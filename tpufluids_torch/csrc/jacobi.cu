// Jacobi and red-black solves of (x0 + a * sum of the six neighbours) / c
// with set_bnd3d(b) after every sweep and half-sweep, and the whole tier
// built on them: the multi-field diffusion and the fused projection.
//
// Replaces (tpufluids/grid/pallas_kernels.py):
//   lin_solve3d_pallas / _solve_whole_kernel, _solve_kernel -> tf_lin_solve3d
//   lin_solve3d_rb_packed / _solve_rb_packed_*_kernel       -> tf_lin_solve3d_rb
//   diffuse3d_whole_multi / _solve_whole_multi_kernel       -> tf_diffuse3d_multi
//   project3d_whole_pallas / _project_whole_kernel          -> tf_project3d_whole
//
// The cell bodies, the ghost scheme and the whole-tier phases are in
// jacobi.cuh.
//
// What bounds them on the H100: device-memory bytes.  A sweep does 8
// flops a cell and moves at least three fields (x and x0 in, the result
// out).  The streamed solvers make one pass per sweep, or per red-black
// half-sweep; the TPU kernels fused several sweeps per pass in VMEM,
// which is left to a later change here (temporal blocking in shared
// memory).  The red-black half-sweep runs one thread per active cell
// only, in place.
//
// The whole tier: at 64^3 a field is 66^3 * 4 B = 1.15 MB, and one launch
// per sweep would leave the card waiting on the host.  One cooperative
// launch runs every sweep; its fields stay in the 50 MB L2.  The fused
// projection calls the cell bodies of divgrad.cuh and the sweeps of
// jacobi.cuh, in the order of the three-launch path, so the two give the
// same bits.
#include "jacobi.cuh"

namespace cg = cooperative_groups;

namespace {

using tf::blocks_of;

// ---------------------------------------------------------------------------
// streamed: one launch per sweep or half-sweep

__global__ void jacobi_kernel(const float* __restrict__ src,
                              const float* __restrict__ x0,
                              float* __restrict__ dst, int n, int b, float a,
                              float c_inv) {
  tf::jacobi_cell(blockIdx.x * blockDim.x + threadIdx.x, src, x0, dst, n, b,
                  a, c_inv);
}

__global__ void rb_kernel(const float* src, const float* __restrict__ x0,
                          float* dst, int n, int p, bool first, tf::Signs s,
                          float a, float c_inv) {
  tf::rb_cell(blockIdx.x * blockDim.x + threadIdx.x, src, x0, dst, n, p,
              first, s.x, s.y, s.z, a, c_inv);
}

__global__ void ghost_kernel(float* x, int n, int b) {
  tf::ghost_cell(blockIdx.x * blockDim.x + threadIdx.x, x, n, b);
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

}  // namespace

extern "C" int tf_lin_solve3d(const float* x, const float* x0, float* out,
                              float* tmp, int b, int n, int iters, float a,
                              float c_inv, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
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

extern "C" int tf_lin_solve3d_rb(const float* x, const float* x0, float* out,
                                 int b, int n, int iters, float a,
                                 float c_inv, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const tf::Signs s = tf::signs_for(b);
  const unsigned blocks = blocks_of((long long)n * n * ((n + 1) / 2));
  for (int it = 0; it < iters; ++it) {
    for (int p = 0; p < 2; ++p) {
      const bool first = it == 0 && p == 0;
      rb_kernel<<<blocks, tf::kThreads, 0, st>>>(first ? x : out, x0, out, n,
                                                 p, first, s, a, c_inv);
      const int rc = tf::launch_status();
      if (rc) return rc;
    }
  }
  const long long N = n + 2;
  ghost_kernel<<<blocks_of(N * N * N - (long long)n * n * n), tf::kThreads,
                 0, st>>>(out, n, b);
  return tf::launch_status();
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
