// The arithmetic of one cell of the 27-tap stencil semi-Lagrangian
// advection, shared by the x-march of advect.cu and the whole step of
// step.cu, so that the two give the same bits: the backtrace hats of a
// cell (advect_hats) and the sum of one tap (advect_tap), whatever memory
// the taps come from.  advect_cell, the whole step's body, reads its taps
// from device memory.  No pointer here is __restrict__ (see forcing.cuh).
#pragma once

#include "grid_common.cuh"

namespace tf {

constexpr int kMaxAdvected = 3;

struct AdvectFields {
  const float* in[kMaxAdvected];
  float* out[kMaxAdvected];
  int bnd[kMaxAdvected];
};

// hat[a][d + 1] = max(0, 1 - |off_a - d|) of a cell at (gi, cj, ck), gi
// its global row: the backtrace offset -dt0 * vel clamped to one cell and
// to the source range [0.5, n + 0.5].
__device__ __forceinline__ void advect_hats(float ux, float vy, float wz,
                                            int gi, int cj, int ck, int n,
                                            float dt0, float (&hat)[3][3]) {
  const float vel[3] = {ux, vy, wz};
  const int at[3] = {gi, cj, ck};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ia = (float)at[a];
    float off = fminf(fmaxf(-dt0 * vel[a], -1.0f), 1.0f);
    off = fminf(fmaxf(off, 0.5f - ia), ((float)n + 0.5f) - ia);
#pragma unroll
    for (int d = -1; d <= 1; ++d)
      hat[a][d + 1] = fmaxf(0.0f, 1.0f - fabsf(off - (float)d));
  }
}

// acc plus tap (dx, dy, dz) of value f.  A cell's sum takes its taps in
// the _SHIFTS order of stam._advect_stencil: dx, then dy, then dz.
__device__ __forceinline__ float advect_tap(float acc,
                                            const float (&hat)[3][3], int dx,
                                            int dy, int dz, float f) {
  const float wgt = hat[0][dx + 1] * hat[1][dy + 1] * hat[2][dz + 1];
  return acc + wgt * f;
}

// Output cell idx of the K fields of f advected by (u, v, w), every tap
// from device memory: the hats once, then the 27 taps of each field, then
// the set_bnd sign of field q's b.  On a slab (Place) the x backtrace is
// clamped by the global row.
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
  float hat[3][3];
  advect_hats(u[c], v[c], w[c], cell.gi, (c / N) % N, c % N, n, dt0, hat);
  float acc[K];
#pragma unroll
  for (int q = 0; q < K; ++q) acc[q] = 0.0f;
#pragma unroll
  for (int dx = -1; dx <= 1; ++dx)
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dz = -1; dz <= 1; ++dz) {
        const int src = c + (dx * N + dy) * N + dz;
#pragma unroll
        for (int q = 0; q < K; ++q)
          acc[q] = advect_tap(acc[q], hat, dx, dy, dz, f.in[q][src]);
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
