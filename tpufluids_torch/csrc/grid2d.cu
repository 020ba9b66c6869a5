// The 2D Jacobi solve with set_bnd2d.
//
// Replaces lin_solve2d_pallas / _lin_solve2d_kernel
// (tpufluids/grid/pallas_kernels.py), which keeps the field in VMEM for
// the whole solve.  (The whole 2D step, step2d_whole_pallas, is
// csrc/step2d.cu.)
//
// A 2D field is small: 130^2 float32 (n = 128) is 68 KB.  Here one thread
// block of 1024 threads runs every sweep, with a block barrier
// (__syncthreads) between sweeps; the solve's two ping-pong buffers live
// in the block's shared memory (2 (n+2)^2 floats, 135 KB at n = 128,
// opted in above 48 KB), x0 in device memory, where it stays in L2.
// What bounds it on the H100 is latency, not bytes or operations: a sweep
// is some 17 cells a thread, and the sweeps are serial.  A solve whose
// buffers do not fit shared memory (n + 2 > 170,
// kernels.solve2d_smem_ok) keeps them in device memory, still in one
// block.
//
// Every output cell is written by one thread, ghosts included, with no
// atomics.  A ghost takes the value set_bnd2d leaves there, computed from
// the new interior value at its clamped index (recomputed by the ghost's
// thread, so no second pass): sx or sy times it on an edge, and 0.5 (sy c
// + sx c) at a corner, c the diagonal interior value (stam.set_bnd2d's
// corner averages of the two edge cells).  The arithmetic is that of the
// plain PyTorch version, operation by operation with one rounding each
// (-fmad=false), so kernel and plain version agree bit for bit.  No
// pointer is __restrict__: a sweep reads what the sweep before wrote.
#include <math.h>

#include "grid2d.cuh"
#include "grid_common.cuh"

namespace {

constexpr int kBlock = 1024;

// Output cell (i, j): c is the flat index of its clamped interior cell,
// xo / yo whether i / j lie on a ghost row / column.
struct Cell2 {
  int c;
  bool xo, yo;
};

__device__ __forceinline__ Cell2 cell2(int idx, int n) {
  const int N = n + 2, i = idx / N, j = idx % N;
  const int ci = tf::clamp_interior(i, n), cj = tf::clamp_interior(j, n);
  return {ci * N + cj, ci != i, cj != j};
}

// The Jacobi update (x0 + a * nb) * c_inv of interior cell c, the
// neighbours summed x-1, x+1, y-1, y+1; src NULL is a zero field.
__device__ __forceinline__ float jacobi2d(const float* src, const float* x0,
                                          int c, int N, float a,
                                          float c_inv) {
  float nb = 0.0f;
  if (src) {
    nb = src[c - N] + src[c + N];
    nb = nb + src[c - 1];
    nb = nb + src[c + 1];
  }
  return (x0[c] + a * nb) * c_inv;
}

// ``iters`` Jacobi sweeps, each followed by set_bnd2d: sweep k reads x
// (k = 0; NULL for a zero guess) or the buffer sweep k - 1 wrote, and
// writes ``even`` or ``odd`` by the parity of k, or ``last`` (if not NULL)
// for the last sweep.  A barrier follows every sweep.  Returns the buffer
// that holds the result.
__device__ __forceinline__ float* solve2d(const float* x, const float* x0,
                                          float* even, float* odd,
                                          float* last, int n, int iters,
                                          tf::Bnd s, float a, float c_inv) {
  const int N = n + 2;
  const float* src = x;
  float* dst = nullptr;
  for (int k = 0; k < iters; ++k) {
    dst = (last && k == iters - 1) ? last : ((k & 1) ? odd : even);
    for (int idx = threadIdx.x; idx < N * N; idx += blockDim.x) {
      const Cell2 g = cell2(idx, n);
      dst[idx] = tf::bnd(g.xo, g.yo, s, jacobi2d(src, x0, g.c, N, a, c_inv));
    }
    __syncthreads();
    src = dst;
  }
  return dst;
}

// Dynamic shared memory above the 48 KB default needs an opt-in per
// kernel; a request past the card's limit returns its error.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute((const void*)kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

__global__ void __launch_bounds__(kBlock)
    lin_solve2d_kernel(const float* x, const float* x0, float* even,
                       float* odd, float* last, int n, int iters, tf::Bnd s,
                       float a, float c_inv) {
  extern __shared__ float smem[];
  if (!even) {
    even = smem;
    odd = smem + (n + 2) * (n + 2);
  }
  solve2d(x, x0, even, odd, last, n, iters, s, a, c_inv);
}

}  // namespace

extern "C" int tf_lin_solve2d(const float* x, const float* x0, float* out,
                              float* tmp, int b, int n, int iters, float a,
                              float c_inv, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const tf::Bnd s = tf::bnd_for(b);
  if (tmp) {
    // device-memory buffers: the last sweep's natural buffer is out
    const bool odd_last = (iters - 1) & 1;
    lin_solve2d_kernel<<<1, kBlock, 0, st>>>(x, x0, odd_last ? tmp : out,
                                             odd_last ? out : tmp, nullptr,
                                             n, iters, s, a, c_inv);
    return tf::launch_status();
  }
  const size_t bytes = 2 * sizeof(float) * (size_t)(n + 2) * (n + 2);
  const int rc = allow_smem(lin_solve2d_kernel, bytes);
  if (rc) return rc;
  lin_solve2d_kernel<<<1, kBlock, bytes, st>>>(x, x0, nullptr, nullptr, out,
                                               n, iters, s, a, c_inv);
  return tf::launch_status();
}
