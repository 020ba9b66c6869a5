// Jacobi and red-black solves of (x0 + a * sum of the six neighbours) / c
// with set_bnd3d(b) after every sweep and half-sweep, and the whole tier
// built on them: the multi-field diffusion and the fused projection.
//
// Replaces (tpufluids/grid/pallas_kernels.py):
//   lin_solve3d_pallas / _solve_kernel                      -> tf_lin_solve3d
//   lin_solve3d_pallas / _solve_whole_kernel (both dtypes)  -> tf_lin_solve3d_whole
//   lin_solve3d_rb_packed / _solve_rb_packed_*_kernel, and  -> the passes of
//   lin_solve3d_pallas(red_black=True, dtype=bfloat16)         rb_blocked.cu,
//                                                              then tf_rb_ghosts
//   lin_solve3d_pallas(dtype=bfloat16) / _solve_kernel      -> the passes of
//                                                              jacobi_blocked.cu
//   diffuse3d_whole_multi / _solve_whole_multi_kernel       -> tf_diffuse3d_multi
//   project3d_whole_pallas / _project_whole_kernel          -> tf_project3d_whole
//
// The cell bodies, the ghost scheme, the storage types and the
// whole-tier phases are in jacobi.cuh.
//
// What bounds them on the H100: on paper device-memory bytes.  A sweep
// does 8 flops a cell and moves at least three fields (x and x0 in, the
// result out): 12 B a cell in float32, 6 B in bfloat16.  The streamed
// float32 Jacobi solve makes one pass per sweep, so it cannot come nearer
// the bound than that one pass; measured, one thread a cell with its
// index decode and ghost branch is bound by instruction issue, a sweep at
// 1.7 TB/s (PERF.md).  The red-black solves in both types and the
// bfloat16 Jacobi solve do several (half-)sweeps a pass in shared memory
// (rb_blocked.cu, jacobi_blocked.cu), as the TPU kernels did in VMEM.
//
// The whole tier: at 64^3 a field is 66^3 * 4 B = 1.15 MB, and one launch
// per sweep would leave the card waiting on the host.  One cooperative
// launch runs every sweep; its fields stay in the 50 MB L2.  The whole
// solve and the fused projection call the cell bodies of the streamed
// kernels (and divgrad.cuh's), in the order of the streamed launches, so
// the two give the same bits.
#include "jacobi.cuh"

namespace cg = cooperative_groups;

namespace {

using tf::blocks_of;

// ---------------------------------------------------------------------------
// streamed: one launch per sweep (the float32 Jacobi solve)

__global__ void jacobi_kernel(const float* __restrict__ src,
                              const float* __restrict__ x0,
                              float* __restrict__ dst, int n, int b, float a,
                              float c_inv) {
  tf::jacobi_cell(blockIdx.x * blockDim.x + threadIdx.x, src, x0, dst, n, b,
                  a, c_inv);
}

template <typename T>
__global__ void ghost_kernel(T* x, int n, int b) {
  tf::ghost_cell(blockIdx.x * blockDim.x + threadIdx.x, x, n, b);
}

int lin_solve3d_streamed(const float* x, const float* x0, float* out,
                         float* tmp, int b, int n, int iters, float a,
                         float c_inv, cudaStream_t st) {
  const float* src = x;
  for (int s = 0; s < iters; ++s) {
    float* dst = tf::sweep_dst(s, iters, out, tmp);
    jacobi_kernel<<<tf::blocks_for(n), tf::kThreads, 0, st>>>(
        src, x0, dst, n, b, a, c_inv);
    const int rc = tf::launch_status();
    if (rc) return rc;
    src = dst;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// whole tier: one cooperative launch

template <int K>
__global__ void diffuse_multi_kernel(tf::DiffuseArgs d) {
  cg::grid_group grid = cg::this_grid();
  tf::diffuse_phase<K>(grid, tf::GridLoop(), d);
}

__global__ void project_whole_kernel(tf::ProjectArgs g) {
  cg::grid_group grid = cg::this_grid();
  tf::project_phase(grid, tf::GridLoop(), g);
}

template <typename T>
__global__ void solve_whole_kernel(tf::SolveArgs<T> g) {
  cg::grid_group grid = cg::this_grid();
  tf::solve_phase(grid, tf::GridLoop(), g);
}

using bf16 = __nv_bfloat16;

}  // namespace

extern "C" int tf_lin_solve3d(const float* x, const float* x0, float* out,
                              float* tmp, int b, int n, int iters, float a,
                              float c_inv, void* stream) {
  return lin_solve3d_streamed(x, x0, out, tmp, b, n, iters, a, c_inv,
                              (cudaStream_t)stream);
}

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

// x, x0, out and tmp hold float, or bfloat16 when ``bf16``; x NULL is a
// zero initial guess, tmp NULL for red-black.
extern "C" int tf_lin_solve3d_whole(const void* x, const void* x0, void* out,
                                    void* tmp, int b, int n, int iters,
                                    int red_black, int bf16_storage, float a,
                                    float c_inv, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16_storage) {
    const tf::SolveArgs<bf16> g{(const bf16*)x, (const bf16*)x0, (bf16*)out,
                                (bf16*)tmp, b, n, iters, red_black, a,
                                c_inv};
    return tf::launch_cooperative(solve_whole_kernel<bf16>, g, n, s);
  }
  const tf::SolveArgs<float> g{(const float*)x, (const float*)x0,
                               (float*)out, (float*)tmp, b, n, iters,
                               red_black, a, c_inv};
  return tf::launch_cooperative(solve_whole_kernel<float>, g, n, s);
}

extern "C" int tf_diffuse3d_multi(const float* x_0, const float* x_1,
                                  const float* x_2, float* out_0,
                                  float* out_1, float* out_2, float* tmp_0,
                                  float* tmp_1, float* tmp_2, int k, int b_0,
                                  int b_1, int b_2, int n, int iters,
                                  float a_0, float a_1, float a_2,
                                  float c_inv_0, float c_inv_1,
                                  float c_inv_2, void* stream) {
  const tf::DiffuseArgs d{{x_0, x_1, x_2},       {out_0, out_1, out_2},
                          {tmp_0, tmp_1, tmp_2}, {b_0, b_1, b_2},
                          {a_0, a_1, a_2},       {c_inv_0, c_inv_1, c_inv_2},
                          n,                     iters};
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: return tf::launch_cooperative(diffuse_multi_kernel<1>, d, n, s);
    case 2: return tf::launch_cooperative(diffuse_multi_kernel<2>, d, n, s);
    case 3: return tf::launch_cooperative(diffuse_multi_kernel<3>, d, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int tf_project3d_whole(const float* u, const float* v,
                                  const float* w, float* uo, float* vo,
                                  float* wo, float* div, float* p, float* p2,
                                  int n, int iters, int red_black, float coef,
                                  float inv_h, float c_inv, void* stream) {
  const tf::ProjectArgs g{u, v, w, uo, vo, wo, div, p, p2, n, iters,
                          red_black, coef, inv_h, c_inv};
  return tf::launch_cooperative(project_whole_kernel, g, n,
                                (cudaStream_t)stream);
}
