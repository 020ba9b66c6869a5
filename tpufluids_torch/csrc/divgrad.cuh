// Per-cell bodies of the projection's divergence and gradient
// subtraction, shared by the streamed kernels of divgrad.cu and the
// fused whole projection of jacobi.cu, so that the two give the same
// bits.
#pragma once

#include "grid_common.cuh"

namespace tf {

// out = set_bnd3d(0, -0.5 h (central divergence)), in the association
// order of stam.divergence3d.
__device__ __forceinline__ void div_cell(int idx, const float* u,
                                         const float* v, const float* w,
                                         float* out, int n, float coef) {
  Cell cell;
  if (!cell_at(idx, n, cell)) return;
  const int N = n + 2, c = cell.c;
  const float s = u[c + N * N] - u[c - N * N] + v[c + N] - v[c - N]
                  + w[c + 1] - w[c - 1];
  out[out_index(cell, n)] = coef * s;
}

// q_a += -0.5 (p[+1] - p[-1]) / h along axis a, then set_bnd3d(a + 1), as
// the card runs the plain version's division: a product with inv_h =
// fl(1 / h) (forcing.cuh).
__device__ __forceinline__ void gradsub_cell(int idx, const float* p,
                                             const float* u, const float* v,
                                             const float* w, float* uo,
                                             float* vo, float* wo, int n,
                                             float inv_h) {
  Cell cell;
  if (!cell_at(idx, n, cell)) return;
  const int N = n + 2, c = cell.c;
  const int o = out_index(cell, n);
  uo[o] = cell.sign[1] *
          (u[c] + -0.5f * (p[c + N * N] - p[c - N * N]) * inv_h);
  vo[o] = cell.sign[2] * (v[c] + -0.5f * (p[c + N] - p[c - N]) * inv_h);
  wo[o] = cell.sign[3] * (w[c] + -0.5f * (p[c + 1] - p[c - 1]) * inv_h);
}

}  // namespace tf
