// Divergence and pressure-gradient subtraction of the projection.
//
// Replaces div3d_pallas / _div_stage and gradsub3d_pallas /
// _gradsub_stage (tpufluids/grid/pallas_kernels.py).  Both are bound by
// device-memory bytes: one pass that reads three (div) or four
// (gradsub) fields and writes one or three, a few flops per cell.  One
// thread per output cell; the neighbour taps come through L1/L2, and
// ghost outputs follow grid_common.cuh.  The cell bodies live in
// divgrad.cuh, which the fused projection of jacobi.cu shares.
#include "divgrad.cuh"

namespace {

__global__ void div3d_kernel(const float* __restrict__ u,
                             const float* __restrict__ v,
                             const float* __restrict__ w,
                             float* __restrict__ out, int n, float coef) {
  tf::div_cell(blockIdx.x * blockDim.x + threadIdx.x, u, v, w, out, n, coef);
}

__global__ void gradsub3d_kernel(const float* __restrict__ p,
                                 const float* __restrict__ u,
                                 const float* __restrict__ v,
                                 const float* __restrict__ w,
                                 float* __restrict__ uo,
                                 float* __restrict__ vo,
                                 float* __restrict__ wo, int n,
                                 float inv_h) {
  tf::gradsub_cell(blockIdx.x * blockDim.x + threadIdx.x, p, u, v, w, uo, vo,
                   wo, n, inv_h);
}

}  // namespace

extern "C" int tf_div3d(const float* u, const float* v, const float* w,
                        float* out, int n, float coef, void* stream) {
  div3d_kernel<<<tf::blocks_for(n), tf::kThreads, 0,
                 (cudaStream_t)stream>>>(u, v, w, out, n, coef);
  return tf::launch_status();
}

extern "C" int tf_gradsub3d(const float* p, const float* u, const float* v,
                            const float* w, float* uo, float* vo, float* wo,
                            int n, float inv_h, void* stream) {
  gradsub3d_kernel<<<tf::blocks_for(n), tf::kThreads, 0,
                     (cudaStream_t)stream>>>(p, u, v, w, uo, vo, wo, n, inv_h);
  return tf::launch_status();
}

extern "C" const char* tf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
