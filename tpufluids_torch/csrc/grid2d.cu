// The whole 2D Jacobi solve with set_bnd2d.
//
// Replaces lin_solve2d_pallas / _lin_solve2d_kernel
// (tpufluids/grid/pallas_kernels.py), which keeps the field in VMEM for
// the whole solve.  (The whole 2D step, step2d_whole_pallas, is
// csrc/step2d.cu.)
//
// What bounds it on the H100 is neither bytes nor operations (130^2
// float32 is 68 KB; 20 sweeps of it are 0.05 us of bytes) but its chain
// of dependent sweeps.  The design it replaces ran every sweep on one
// block of 1024 threads, one of the card's 132 multiprocessors, with a
// block barrier a sweep.
//
// Design: the whole 2D step's blocked passes (step2d_blocked.cuh's
// blocked_solve), in one cooperative launch of persistent blocks, one a
// multiprocessor.  A pass loads each block's tile widened by a halo of
// ``levels`` cells into shared memory, runs up to ``levels`` sweeps there
// and writes the tile, its ghosts and corners included; then comes one
// grid barrier, none after the last pass: ceil(iters / levels) - 1
// barriers a solve (kernels.solve2d_plan, solve_barriers).  The fields
// live in device memory (L2) and the boxes in shared memory at every n.
//
// Every output cell is written by one thread, ghosts included, with no
// atomics; a ghost takes the value set_bnd2d leaves there (grid2d.cuh).
// The arithmetic is that of the plain PyTorch version, operation by
// operation with one rounding each (-fmad=false), so kernel and plain
// version agree bit for bit.
#include "step2d_blocked.cuh"

namespace {

// The most threads a block takes (the host picks its count:
// kernels.SOLVE2D_THREADS), one block a multiprocessor.
constexpr int kSolveMaxThreads = 1024;

__global__ void __launch_bounds__(kSolveMaxThreads, 1)
    solve2d_kernel(const tf2d::BlockedSolve d, int n) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  extern __shared__ __align__(16) float smem[];
  tf2d::blocked_solve(grid, d, smem, n, false);
}

}  // namespace

// ``iters`` Jacobi sweeps from x (NULL: zeros) with x0, alternating
// between out and tmp so that the last lands in out.  ``blocks``
// persistent blocks of ``threads``, ``smem`` bytes of shared memory each
// (tf_lin_solve2d_info must have run on the device first); passes of
// ``levels`` sweeps on tiles of tx x ty cells with a halo of ``levels``
// (kernels.solve2d_plan).  A launch the card refuses returns its error.
extern "C" int tf_lin_solve2d(const float* x, const float* x0, float* out,
                              float* tmp, int b, int n, int iters,
                              int blocks, int threads, int smem, int levels,
                              int tx, int ty, float a, float c_inv,
                              void* stream) {
  if (levels < 1 || iters < 1 || blocks < 1 || threads < 1 ||
      threads > kSolveMaxThreads || tx < 1 || ty < 1 || !tmp)
    return (int)cudaErrorInvalidValue;
  tf2d::BlockedSolve d{};
  d.f[0] = tf2d::SolveField{x, x0, out, tmp, b, a, c_inv};
  d.fields = 1;
  d.iters = iters;
  d.levels = levels;
  d.tiles = tf2d::tiles_of(n, tx, ty, levels);
  void* params[] = {&d, &n};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)solve2d_kernel, dim3((unsigned)blocks),
      dim3((unsigned)threads), params, (size_t)smem, (cudaStream_t)stream);
}

// The solve's shape on the current device: the blocks the card keeps
// resident (one a multiprocessor at the most shared memory a block may
// take) and that shared memory in bytes; it sets the kernel's
// shared-memory attribute to that size.
extern "C" int tf_lin_solve2d_info(int* blocks, int* smem) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(solve2d_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, solve2d_kernel, kSolveMaxThreads, optin);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  *smem = optin;
  return 0;
}
