// Divergence and pressure-gradient subtraction of the projection.
//
// Replaces div3d_pallas / _div_stage and gradsub3d_pallas /
// _gradsub_stage (tpufluids/grid/pallas_kernels.py).  Both are bound by
// device-memory bytes: one pass that reads three (div) or four
// (gradsub) fields and writes one or three, a few flops per cell.  One
// thread per output cell; the neighbour taps come through L1/L2, and
// ghost outputs follow grid_common.cuh.
#include "grid_common.cuh"

namespace {

// out = set_bnd3d(0, -0.5 h (central divergence)), in the association
// order of stam.divergence3d.
__global__ void div3d_kernel(const float* __restrict__ u,
                             const float* __restrict__ v,
                             const float* __restrict__ w,
                             float* __restrict__ out, int n, float coef) {
  tf::Cell cell;
  if (!tf::cell_at(blockIdx.x * blockDim.x + threadIdx.x, n, cell)) return;
  const int N = n + 2, c = cell.c;
  const float s = u[c + N * N] - u[c - N * N] + v[c + N] - v[c - N]
                  + w[c + 1] - w[c - 1];
  out[(cell.i * N + cell.j) * N + cell.k] = coef * s;
}

// q_a += -0.5 (p[+1] - p[-1]) / h along axis a, then set_bnd3d(a + 1).
__global__ void gradsub3d_kernel(const float* __restrict__ p,
                                 const float* __restrict__ u,
                                 const float* __restrict__ v,
                                 const float* __restrict__ w,
                                 float* __restrict__ uo,
                                 float* __restrict__ vo,
                                 float* __restrict__ wo, int n, float h) {
  tf::Cell cell;
  if (!tf::cell_at(blockIdx.x * blockDim.x + threadIdx.x, n, cell)) return;
  const int N = n + 2, c = cell.c;
  const int o = (cell.i * N + cell.j) * N + cell.k;
  uo[o] = cell.sign[1] * (u[c] + -0.5f * (p[c + N * N] - p[c - N * N]) / h);
  vo[o] = cell.sign[2] * (v[c] + -0.5f * (p[c + N] - p[c - N]) / h);
  wo[o] = cell.sign[3] * (w[c] + -0.5f * (p[c + 1] - p[c - 1]) / h);
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
                            int n, float h, void* stream) {
  gradsub3d_kernel<<<tf::blocks_for(n), tf::kThreads, 0,
                     (cudaStream_t)stream>>>(p, u, v, w, uo, vo, wo, n, h);
  return tf::launch_status();
}

extern "C" const char* tf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
