// Per-cell body of the 27-tap stencil semi-Lagrangian advection, shared
// by the streamed kernel of advect.cu and the whole step of step.cu, so
// that the two give the same bits.  No pointer here is __restrict__ (see
// forcing.cuh).
#pragma once

#include "grid_common.cuh"

namespace tf {

constexpr int kMaxAdvected = 3;

struct AdvectFields {
  const float* in[kMaxAdvected];
  float* out[kMaxAdvected];
  int bnd[kMaxAdvected];
};

// Output cell idx of the K fields of f advected by (u, v, w): the
// backtrace weights once, then the 27 taps of each field in the _SHIFTS
// order of stam._advect_stencil, then the set_bnd sign of field q's b.
// On a slab (Place) the x backtrace is clamped by the global row.
template <int K>
__device__ __forceinline__ void advect_cell(int idx, const float* u,
                                            const float* v, const float* w,
                                            const AdvectFields& f, int n,
                                            float dt0, Place pl) {
  Cell cell;
  if (!cell_at(idx, n, pl, cell)) return;
  const int o = out_index(cell, n);
  if (!cell.ok) {
#pragma unroll
    for (int q = 0; q < K; ++q) f.out[q][o] = 0.0f;
    return;
  }
  const int N = n + 2, c = cell.c;
  const float vel[3] = {u[c], v[c], w[c]};
  const int at[3] = {cell.gi, (c / N) % N, c % N};
  // hat[a][d + 1] = max(0, 1 - |off_a - d|), with the backtrace offset
  // clamped to one cell and to the source range [0.5, n + 0.5]
  float hat[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ia = (float)at[a];
    float off = fminf(fmaxf(-dt0 * vel[a], -1.0f), 1.0f);
    off = fminf(fmaxf(off, 0.5f - ia), ((float)n + 0.5f) - ia);
#pragma unroll
    for (int d = -1; d <= 1; ++d)
      hat[a][d + 1] = fmaxf(0.0f, 1.0f - fabsf(off - (float)d));
  }
  float acc[K];
#pragma unroll
  for (int q = 0; q < K; ++q) acc[q] = 0.0f;
#pragma unroll
  for (int dx = -1; dx <= 1; ++dx)
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dz = -1; dz <= 1; ++dz) {
        const float wgt = hat[0][dx + 1] * hat[1][dy + 1] * hat[2][dz + 1];
        const int src = c + (dx * N + dy) * N + dz;
#pragma unroll
        for (int q = 0; q < K; ++q) acc[q] = acc[q] + wgt * f.in[q][src];
      }
#pragma unroll
  for (int q = 0; q < K; ++q) f.out[q][o] = cell.sign(f.bnd[q]) * acc[q];
}

template <int K>
__device__ __forceinline__ void advect_cell(int idx, const float* u,
                                            const float* v, const float* w,
                                            const AdvectFields& f, int n,
                                            float dt0) {
  advect_cell<K>(idx, u, v, w, f, n, dt0, cubic(n));
}

}  // namespace tf
