// 27-tap stencil semi-Lagrangian advection of K fields by (u, v, w).
//
// Replaces advect3d_multi_pallas / _advect_kernel / _advect_stage
// (tpufluids/grid/pallas_kernels.py).  Like the TPU kernel it computes
// the per-cell backtrace weights once and applies them to all K fields
// (K = 3 for the velocity self-advection, 2 for dens/temp).  Unlike it,
// it reads the stored ghost cells of its inputs instead of rebuilding
// the z ghosts, so it reproduces the dense stam.advect3d_stencil.
// Bound by device-memory bytes: one pass over 3 + K fields in and K
// out; the 27 taps per field hit L1/L2.  The cell body lives in
// advect.cuh, which the whole step of step.cu shares.  On an x-slab of the
// sharded step (rows, gx0: grid_common.cuh) the x backtrace clamp and the
// x ghosts follow global rows, as advect3d_multi_pallas's gx0/gn do.
#include "advect.cuh"

namespace {

template <int K>
__global__ void advect3d_kernel(const float* __restrict__ u,
                                const float* __restrict__ v,
                                const float* __restrict__ w,
                                tf::AdvectFields f, int n, float dt0,
                                tf::Place pl) {
  tf::advect_cell<K>(blockIdx.x * blockDim.x + threadIdx.x, u, v, w, f, n,
                     dt0, pl);
}

}  // namespace

extern "C" int tf_advect3d(const float* u, const float* v, const float* w,
                           const float* q0, const float* q1, const float* q2,
                           float* o0, float* o1, float* o2, int k, int b0,
                           int b1, int b2, int n, int rows, int gx0,
                           float dt0, void* stream) {
  const tf::AdvectFields f{{q0, q1, q2}, {o0, o1, o2}, {b0, b1, b2}};
  const tf::Place pl{rows, gx0};
  const dim3 grid(tf::blocks_for(n, pl)), block(tf::kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: advect3d_kernel<1><<<grid, block, 0, s>>>(u, v, w, f, n, dt0, pl); break;
    case 2: advect3d_kernel<2><<<grid, block, 0, s>>>(u, v, w, f, n, dt0, pl); break;
    case 3: advect3d_kernel<3><<<grid, block, 0, s>>>(u, v, w, f, n, dt0, pl); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return tf::launch_status();
}
