// Divergence and pressure-gradient subtraction of the projection.
//
// Replaces div3d_pallas / _div_stage and gradsub3d_pallas /
// _gradsub_stage (tpufluids/grid/pallas_kernels.py).  Both are bound by
// device-memory bytes: one pass that reads three (div) or four
// (gradsub) fields and writes one or three, a few flops per cell.  One
// thread per output cell; the neighbour taps come through L1/L2, and
// ghost outputs follow grid_common.cuh.  The cell bodies live in
// divgrad.cuh, which the fused projection of jacobi.cu shares.  On an
// x-slab of the sharded step (rows, gx0) h is 1 / n of the global grid and
// the x ghosts follow global rows (div3d_pallas's and gradsub3d_pallas's
// h override).
#include "divgrad.cuh"

namespace {

__global__ void div3d_kernel(const float* __restrict__ u,
                             const float* __restrict__ v,
                             const float* __restrict__ w,
                             float* __restrict__ out, int n, float coef,
                             tf::Place pl) {
  tf::div_cell(blockIdx.x * blockDim.x + threadIdx.x, u, v, w, out, n, coef,
               pl);
}

__global__ void gradsub3d_kernel(const float* __restrict__ p,
                                 const float* __restrict__ u,
                                 const float* __restrict__ v,
                                 const float* __restrict__ w,
                                 float* __restrict__ uo,
                                 float* __restrict__ vo,
                                 float* __restrict__ wo, int n, float inv_h,
                                 tf::Place pl) {
  tf::gradsub_cell(blockIdx.x * blockDim.x + threadIdx.x, p, u, v, w, uo, vo,
                   wo, n, inv_h, pl);
}

}  // namespace

extern "C" int tf_div3d(const float* u, const float* v, const float* w,
                        float* out, int n, int rows, int gx0, float coef,
                        void* stream) {
  const tf::Place pl{rows, gx0};
  div3d_kernel<<<tf::blocks_for(n, pl), tf::kThreads, 0,
                 (cudaStream_t)stream>>>(u, v, w, out, n, coef, pl);
  return tf::launch_status();
}

extern "C" int tf_gradsub3d(const float* p, const float* u, const float* v,
                            const float* w, float* uo, float* vo, float* wo,
                            int n, int rows, int gx0, float inv_h,
                            void* stream) {
  const tf::Place pl{rows, gx0};
  gradsub3d_kernel<<<tf::blocks_for(n, pl), tf::kThreads, 0,
                     (cudaStream_t)stream>>>(p, u, v, w, uo, vo, wo, n, inv_h,
                                             pl);
  return tf::launch_status();
}

extern "C" const char* tf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
