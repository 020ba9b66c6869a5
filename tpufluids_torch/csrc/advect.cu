// 27-tap stencil semi-Lagrangian advection of K fields by (u, v, w).
//
// Replaces advect3d_multi_pallas / _advect_kernel / _advect_stage
// (tpufluids/grid/pallas_kernels.py).  Like the TPU kernel it computes
// the per-cell backtrace weights once and applies them to all K fields
// (K = 3 for the velocity self-advection, 2 for dens/temp).  Unlike it,
// it reads the stored ghost cells of its inputs instead of rebuilding
// the z ghosts, so it reproduces the dense stam.advect3d_stencil.
// Bound by device-memory bytes: one pass over 3 + K fields in and K
// out; the 27 taps per field hit L1/L2.  The taps are summed in the
// _SHIFTS order of stam._advect_stencil.
#include "grid_common.cuh"

namespace {

constexpr int kMaxFields = 3;

struct Fields {
  const float* in[kMaxFields];
  float* out[kMaxFields];
  int bnd[kMaxFields];
};

template <int K>
__global__ void advect3d_kernel(const float* __restrict__ u,
                                const float* __restrict__ v,
                                const float* __restrict__ w, Fields f,
                                int n, float dt0) {
  tf::Cell cell;
  if (!tf::cell_at(blockIdx.x * blockDim.x + threadIdx.x, n, cell)) return;
  const int N = n + 2, c = cell.c;
  const float vel[3] = {u[c], v[c], w[c]};
  const int idx[3] = {c / (N * N), (c / N) % N, c % N};
  // hat[a][d + 1] = max(0, 1 - |off_a - d|), with the backtrace offset
  // clamped to one cell and to the source range [0.5, n + 0.5]
  float hat[3][3];
  for (int a = 0; a < 3; ++a) {
    const float ia = (float)idx[a];
    float off = fminf(fmaxf(-dt0 * vel[a], -1.0f), 1.0f);
    off = fminf(fmaxf(off, 0.5f - ia), ((float)n + 0.5f) - ia);
    for (int d = -1; d <= 1; ++d)
      hat[a][d + 1] = fmaxf(0.0f, 1.0f - fabsf(off - (float)d));
  }
  float acc[K];
  for (int q = 0; q < K; ++q) acc[q] = 0.0f;
  for (int dx = -1; dx <= 1; ++dx)
    for (int dy = -1; dy <= 1; ++dy)
      for (int dz = -1; dz <= 1; ++dz) {
        const float wgt = hat[0][dx + 1] * hat[1][dy + 1] * hat[2][dz + 1];
        const int src = c + (dx * N + dy) * N + dz;
        for (int q = 0; q < K; ++q) acc[q] = acc[q] + wgt * f.in[q][src];
      }
  const int o = (cell.i * N + cell.j) * N + cell.k;
  for (int q = 0; q < K; ++q) f.out[q][o] = cell.sign[f.bnd[q]] * acc[q];
}

}  // namespace

extern "C" int tf_advect3d(const float* u, const float* v, const float* w,
                           const float* q0, const float* q1, const float* q2,
                           float* o0, float* o1, float* o2, int k, int b0,
                           int b1, int b2, int n, float dt0, void* stream) {
  const Fields f{{q0, q1, q2}, {o0, o1, o2}, {b0, b1, b2}};
  const dim3 grid(tf::blocks_for(n)), block(tf::kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: advect3d_kernel<1><<<grid, block, 0, s>>>(u, v, w, f, n, dt0); break;
    case 2: advect3d_kernel<2><<<grid, block, 0, s>>>(u, v, w, f, n, dt0); break;
    case 3: advect3d_kernel<3><<<grid, block, 0, s>>>(u, v, w, f, n, dt0); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return tf::launch_status();
}
