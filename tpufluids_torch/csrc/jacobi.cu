// Jacobi and red-black solves of (x0 + a * sum of the six neighbours) / c
// with set_bnd3d(b) after every sweep and half-sweep, and the whole tier
// built on them: the multi-field diffusion and the fused projection.
//
// Replaces (tpufluids/grid/pallas_kernels.py):
//   lin_solve3d_pallas / _solve_kernel (both dtypes)        -> the passes of
//                                                              jacobi_blocked.cu
//   lin_solve3d_pallas / _solve_whole_kernel (both dtypes)  -> tf_lin_solve3d_whole
//                                           (step_blocked.cuh's blocked_solve)
//   lin_solve3d_rb_packed / _solve_rb_packed_*_kernel, and  -> the passes of
//   lin_solve3d_pallas(red_black=True, dtype=bfloat16)         rb_blocked.cu,
//                                                              then tf_rb_ghosts
//   diffuse3d_whole_multi / _solve_whole_multi_kernel       -> tf_diffuse3d_multi
//                                           (step_blocked.cuh's blocked_solve)
//   project3d_whole_pallas / _project_whole_kernel          -> tf_project3d_whole
//                                           (step_blocked.cuh's blocked_project)
//
// The cell bodies, the ghost scheme and the storage types are in
// jacobi.cuh.
//
// What bounds them on the H100: on paper device-memory bytes.  A sweep
// does 8 flops a cell and moves at least three fields (x and x0 in, the
// result out): 12 B a cell in float32, 6 B in bfloat16.  The dense solves
// do several (half-)sweeps a pass in shared memory (rb_blocked.cu,
// jacobi_blocked.cu), as the TPU kernels did in VMEM.
//
// The whole tier: the whole solve, the multi-field diffusion and the
// fused projection.  At 64^3 a field is 66^3 * 4 B = 1.15 MB, and one
// launch per sweep would leave the card waiting on the host; the fields
// stay in the 50 MB L2.  What bounds them is neither bytes nor operations
// (at 64^3 a 20-iteration solve is 0.7 us of bytes) but their chain of
// dependent sweeps: a design that runs a grid-wide barrier after every
// sweep, or half-sweep, pays some 1.1 us a barrier, 19 to 42 of them a
// call, besides a thread a cell decoding its index each sweep.  Here all
// three run the whole step's blocked passes (step_blocked.cuh's
// blocked_solve and blocked_project) in one cooperative launch: a
// persistent block a multiprocessor loads its tile with a halo into
// shared memory, runs up to ``levels`` sweeps or half-sweeps there and
// writes the tile back, and only then comes a grid barrier:
// ceil(sweeps / levels) - 1 barriers a call (kernels.solve_plan,
// diffuse_plan, project_plan, solve_barriers).  The diffusion's blocks
// take its (field, tile) pairs in turn.  The projection keeps one tile a
// block for the whole solve, its divergence in the block's x0, and
// subtracts the gradient in its last pass, with the cell arithmetic of
// the three-launch path (divgrad.cuh, cell_update), so the two give the
// same bits.  One instance a storage type and mode; the host plans the
// tiles, the threads and every buffer.
#include "step_blocked.cuh"

namespace cg = cooperative_groups;

namespace {

using tf::blocks_of;

template <typename T>
__global__ void ghost_kernel(T* x, int n, int b) {
  tf::ghost_cell(blockIdx.x * blockDim.x + threadIdx.x, x, n, b);
}

// ---------------------------------------------------------------------------
// whole tier: one cooperative launch

// The most threads a block of the whole tier takes (the host picks its
// count: kernels.SOLVE_THREADS), one block a multiprocessor: 128
// registers a thread, which its passes need without a spill (at 96 the
// float32 Jacobi instance spills).
constexpr int kSolveMaxThreads = 512;

// The fused projection: one tile a block, red-black or Jacobi (a runtime
// flag, as in the whole step), no barrier after the last pass.
__global__ void __launch_bounds__(kSolveMaxThreads, 1)
    project_whole_kernel(const tf::BlockedProject g, int n) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  tf::blocked_project<true>(grid, g, reinterpret_cast<float*>(smem_bytes),
                            n);
}

template <typename T>
using Solve = tf::BlockedSolve<T, 1>;

template <typename T, bool RB>
__global__ void __launch_bounds__(kSolveMaxThreads, 1)
    solve_whole_kernel(const Solve<T> g, int n) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  tf::blocked_solve<T, RB, true>(grid, g, reinterpret_cast<T*>(smem_bytes),
                                 n);
}

// Up to three diffusions, x0 each field itself, in the same passes: a
// lone solve's instance (its own x0, here the field; no barrier after the
// last pass) of the diffusion flavour (Jacobi, float32).
using Diffuse = tf::BlockedSolve<float, 3>;

__global__ void __launch_bounds__(kSolveMaxThreads, 1)
    diffuse_multi_kernel(const Diffuse d, int n) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  tf::blocked_solve<float, false, true>(
      grid, d, reinterpret_cast<float*>(smem_bytes), n);
}

using bf16 = __nv_bfloat16;

tf::StepTiles tiles_of(int n, int tx, int ty, int tz, int halo) {
  const int cx = (n + tx - 1) / tx, cy = (n + ty - 1) / ty,
            cz = (n + tz - 1) / tz;
  return tf::StepTiles{tx, ty, tz, halo, cy, cz, cx * cy * cz};
}

template <typename T, bool RB>
int launch_solve_whole(const void* x, const void* x0, void* out, void* tmp,
                       int b, int n, int iters, int blocks, int threads,
                       int smem, int levels, int tx, int ty, int tz,
                       float a, float c_inv, cudaStream_t stream) {
  Solve<T> g{};
  g.f[0] = tf::SolveField<T>{(const T*)x, (const T*)x0, (T*)out, (T*)tmp,
                             b, a, c_inv};
  g.fields = 1;
  g.iters = iters;
  g.levels = levels;
  g.tiles = tiles_of(n, tx, ty, tz, levels);
  void* params[] = {&g, &n};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)solve_whole_kernel<T, RB>, dim3((unsigned)blocks),
      dim3((unsigned)threads), params, (size_t)smem, stream);
}

template <typename Args>
cudaError_t allow_solve_smem(void (*kernel)(Args, int), int bytes,
                             int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int k = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &k, kernel, kSolveMaxThreads, bytes);
  if (e == cudaSuccess && k < *per_sm) *per_sm = k;
  return e;
}

}  // namespace

// The ghost pass that ends the dense red-black solves (their half-sweeps
// are rb_blocked.cu's passes): every ghost of x by set_bnd3d(b); x holds
// float, or bfloat16 when ``bf16_storage``.
extern "C" int tf_rb_ghosts(void* x, int n, int b, int bf16_storage,
                            void* stream) {
  const long long N = n + 2;
  const unsigned blocks = blocks_of(N * N * N - (long long)n * n * n);
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16_storage)
    ghost_kernel<bf16><<<blocks, tf::kThreads, 0, st>>>((bf16*)x, n, b);
  else
    ghost_kernel<float><<<blocks, tf::kThreads, 0, st>>>((float*)x, n, b);
  return tf::launch_status();
}

// x, x0, out and tmp hold float, or bfloat16 when ``bf16_storage``; x
// NULL is a zero initial guess; the passes alternate between out and tmp
// so that the last lands in out.  ``blocks`` persistent blocks of
// ``threads`` (at most one tile each, or several: then each reloads its
// x0 every pass), ``smem`` bytes of shared memory each; passes of
// ``levels`` sweeps or half-sweeps on tiles of tx x ty x tz cells with a
// halo of ``levels`` (kernels.solve_plan).  tf_lin_solve3d_whole_info
// must have run on the device first.  A launch the card refuses returns
// its error.
extern "C" int tf_lin_solve3d_whole(const void* x, const void* x0, void* out,
                                    void* tmp, int b, int n, int iters,
                                    int red_black, int bf16_storage,
                                    int blocks, int threads, int smem,
                                    int levels, int tx, int ty, int tz,
                                    float a, float c_inv, void* stream) {
  if (levels < 1 || iters < 1 || blocks < 1 || threads < 1 ||
      threads > kSolveMaxThreads || tx < 1 || ty < 1 || tz < 1 || !tmp)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16_storage && red_black)
    return launch_solve_whole<bf16, true>(x, x0, out, tmp, b, n, iters,
                                          blocks, threads, smem, levels, tx,
                                          ty, tz, a, c_inv, s);
  if (bf16_storage)
    return launch_solve_whole<bf16, false>(x, x0, out, tmp, b, n, iters,
                                           blocks, threads, smem, levels, tx,
                                           ty, tz, a, c_inv, s);
  if (red_black)
    return launch_solve_whole<float, true>(x, x0, out, tmp, b, n, iters,
                                           blocks, threads, smem, levels, tx,
                                           ty, tz, a, c_inv, s);
  return launch_solve_whole<float, false>(x, x0, out, tmp, b, n, iters,
                                          blocks, threads, smem, levels, tx,
                                          ty, tz, a, c_inv, s);
}

// The whole tier's shape on the current device: its persistent blocks
// (one a multiprocessor at the most shared memory a block may take) and
// that shared memory in bytes; it sets the shared-memory attribute of the
// whole solve's four instances, of the multi-field diffusion and of the
// fused projection to that size.
extern "C" int tf_lin_solve3d_whole_info(int* blocks, int* smem) {
  int dev = 0, sms = 0, optin = 0, per_sm = 1 << 30;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = allow_solve_smem(solve_whole_kernel<float, false>, optin, &per_sm);
  if (e == cudaSuccess)
    e = allow_solve_smem(solve_whole_kernel<float, true>, optin, &per_sm);
  if (e == cudaSuccess)
    e = allow_solve_smem(solve_whole_kernel<bf16, false>, optin, &per_sm);
  if (e == cudaSuccess)
    e = allow_solve_smem(solve_whole_kernel<bf16, true>, optin, &per_sm);
  if (e == cudaSuccess)
    e = allow_solve_smem(diffuse_multi_kernel, optin, &per_sm);
  if (e == cudaSuccess)
    e = allow_solve_smem(project_whole_kernel, optin, &per_sm);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  *smem = optin;
  return 0;
}

// Diffuses x_0 .. x_{k-1} (k 1 to 3) by ``iters`` Jacobi sweeps each, x0
// the field itself, with its own b, a and c_inv, into out_i (tmp_i the
// second buffer): one cooperative launch of ``blocks`` persistent blocks
// of ``threads``, ``smem`` bytes of shared memory each, taking the
// (field, tile) pairs in turn (a block with several reloads its x0 every
// pass); passes of ``levels`` sweeps on tiles of tx x ty x tz cells with a
// halo of ``levels`` (kernels.diffuse_plan).  tf_lin_solve3d_whole_info
// must have run on the device first.  A launch the card refuses returns
// its error.
extern "C" int tf_diffuse3d_multi(const float* x_0, const float* x_1,
                                  const float* x_2, float* out_0,
                                  float* out_1, float* out_2, float* tmp_0,
                                  float* tmp_1, float* tmp_2, int k, int b_0,
                                  int b_1, int b_2, int n, int iters,
                                  int blocks, int threads, int smem,
                                  int levels, int tx, int ty, int tz,
                                  float a_0, float a_1, float a_2,
                                  float c_inv_0, float c_inv_1,
                                  float c_inv_2, void* stream) {
  if (k < 1 || k > 3 || levels < 1 || iters < 1 || blocks < 1 ||
      threads < 1 || threads > kSolveMaxThreads || tx < 1 || ty < 1 ||
      tz < 1)
    return (int)cudaErrorInvalidValue;
  Diffuse d{};
  d.f[0] = tf::SolveField<float>{x_0, x_0, out_0, tmp_0, b_0, a_0, c_inv_0};
  d.f[1] = tf::SolveField<float>{x_1, x_1, out_1, tmp_1, b_1, a_1, c_inv_1};
  d.f[2] = tf::SolveField<float>{x_2, x_2, out_2, tmp_2, b_2, a_2, c_inv_2};
  d.fields = k;
  d.iters = iters;
  d.levels = levels;
  d.tiles = tiles_of(n, tx, ty, tz, levels);
  void* params[] = {&d, &n};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)diffuse_multi_kernel, dim3((unsigned)blocks),
      dim3((unsigned)threads), params, (size_t)smem, (cudaStream_t)stream);
}

// The fused projection of u, v, w into uo, vo, wo: the divergence
// (times ``coef``), ``iters`` red-black iterations or Jacobi sweeps of the
// pressure from a zero guess (a = 1, b = 0, times ``c_inv``), the gradient
// (times ``inv_h``) subtracted.  One cooperative launch of ``blocks``
// persistent blocks of ``threads``, one tile each, ``smem`` bytes of
// shared memory each; passes of ``levels`` half-sweeps or sweeps on tiles
// of tx x ty x tz cells with a halo of ``levels`` + 1, the pressure
// between passes alternating between p0 and p1 (kernels.project_plan).
// tf_lin_solve3d_whole_info must have run on the device first.  A launch
// the card refuses returns its error.
extern "C" int tf_project3d_whole(const float* u, const float* v,
                                  const float* w, float* uo, float* vo,
                                  float* wo, float* p0, float* p1, int n,
                                  int iters, int red_black, int blocks,
                                  int threads, int smem, int levels, int tx,
                                  int ty, int tz, float coef, float inv_h,
                                  float c_inv, void* stream) {
  if (levels < 1 || iters < 1 || blocks < 1 || threads < 1 ||
      threads > kSolveMaxThreads || tx < 1 || ty < 1 || tz < 1)
    return (int)cudaErrorInvalidValue;
  tf::BlockedProject g{u, v, w, uo, vo, wo, p0, p1, iters, red_black,
                       levels, coef, inv_h, c_inv,
                       tiles_of(n, tx, ty, tz, levels + 1)};
  // one tile a block, for the whole solve
  if (g.tiles.count > blocks) return (int)cudaErrorInvalidConfiguration;
  void* params[] = {&g, &n};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)project_whole_kernel, dim3((unsigned)blocks),
      dim3((unsigned)threads), params, (size_t)smem, (cudaStream_t)stream);
}
