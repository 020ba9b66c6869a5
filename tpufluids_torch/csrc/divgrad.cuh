// Per-cell bodies of the projection's divergence and gradient
// subtraction, shared by the streamed kernels of divgrad.cu, the fused
// whole projection of jacobi.cu and the whole step's blocked projection
// (step_blocked.cuh), so that they give the same bits.
#pragma once

#include "grid_common.cuh"

namespace tf {

// -0.5 h (central divergence) at interior cell c, in the association
// order of stam.divergence3d: the value of every divergence kernel.
__device__ __forceinline__ float div_value(const float* u, const float* v,
                                           const float* w, int c, int N,
                                           float coef) {
  const float s = u[c + N * N] - u[c - N * N] + v[c + N] - v[c - N]
                  + w[c + 1] - w[c - 1];
  return coef * s;
}

// q - 0.5 (p[+1] - p[-1]) / h as the card runs the plain version: a
// product with inv_h = fl(1 / h) (forcing.cuh).
__device__ __forceinline__ float gradsub_value(float q, float pm, float pp,
                                               float inv_h) {
  return q + -0.5f * (pp - pm) * inv_h;
}

// out = set_bnd3d(0, -0.5 h (central divergence)), in the association
// order of stam.divergence3d.
__device__ __forceinline__ void div_cell(int idx, const float* u,
                                         const float* v, const float* w,
                                         float* out, int n, float coef,
                                         Place pl) {
  Cell cell;
  if (!cell_at(idx, n, pl, cell)) return;
  const int o = out_index(cell, n);
  if (!cell.ok) {
    out[o] = 0.0f;
    return;
  }
  out[o] = div_value(u, v, w, cell.c, n + 2, coef);
}

__device__ __forceinline__ void div_cell(int idx, const float* u,
                                         const float* v, const float* w,
                                         float* out, int n, float coef) {
  div_cell(idx, u, v, w, out, n, coef, cubic(n));
}

// q_a += -0.5 (p[+1] - p[-1]) / h along axis a, then set_bnd3d(a + 1)
// (gradsub_value).
__device__ __forceinline__ void gradsub_cell(int idx, const float* p,
                                             const float* u, const float* v,
                                             const float* w, float* uo,
                                             float* vo, float* wo, int n,
                                             float inv_h, Place pl) {
  Cell cell;
  if (!cell_at(idx, n, pl, cell)) return;
  const int o = out_index(cell, n);
  if (!cell.ok) {
    uo[o] = vo[o] = wo[o] = 0.0f;
    return;
  }
  const int N = n + 2, c = cell.c;
  uo[o] = cell.sign(1) * gradsub_value(u[c], p[c - N * N], p[c + N * N],
                                       inv_h);
  vo[o] = cell.sign(2) * gradsub_value(v[c], p[c - N], p[c + N], inv_h);
  wo[o] = cell.sign(3) * gradsub_value(w[c], p[c - 1], p[c + 1], inv_h);
}

__device__ __forceinline__ void gradsub_cell(int idx, const float* p,
                                             const float* u, const float* v,
                                             const float* w, float* uo,
                                             float* vo, float* wo, int n,
                                             float inv_h) {
  gradsub_cell(idx, p, u, v, w, uo, vo, wo, n, inv_h, cubic(n));
}

}  // namespace tf
