// Per-cell bodies of the forcing (buoyancy + vorticity confinement),
// shared by the two streamed launches of forcing.cu and the whole step of
// step.cu, so that the two give the same bits.  Arithmetic follows
// stam.buoyancy3d and stam.vorticity_confinement3d operation by
// operation.  No pointer here is __restrict__: the whole step reads in one
// phase what another block wrote in the phase before (jacobi.cuh).
#pragma once

#include <math.h>

#include "grid_common.cuh"

namespace tf {

struct Buoyancy {
  float dt, alpha, beta, t_amb;
};

// w + dt (-alpha dens + beta (temp - t_amb)) at an interior cell.
__device__ __forceinline__ float buoyant_w(const float* w, const float* dens,
                                           const float* temp, int c,
                                           Buoyancy b) {
  const float f = -b.alpha * dens[c] + b.beta * (temp[c] - b.t_amb);
  return w[c] + b.dt * f;
}

// w' at any cell (ghosts by the set_bnd3d(3) closed form): the w the
// curl reads.  Without buoyancy w' is w itself, stored ghosts included.
// i is a local row of ``pl``, clamped by its global row.
__device__ __forceinline__ float w_prime(const float* w, const float* dens,
                                         const float* temp, int i, int j,
                                         int k, int n, bool buoy, Buoyancy b,
                                         Place pl) {
  const int N = n + 2;
  if (!buoy) return w[(i * N + j) * N + k];
  const int ck = clamp_interior(k, n);
  const int ci = clamp_interior(pl.gx0 + i, n) - pl.gx0;
  const int c = (ci * N + clamp_interior(j, n)) * N + ck;
  return (ck != k ? -1.0f : 1.0f) * buoyant_w(w, dens, temp, c, b);
}

// The three curl components at interior cell (i, j, k).  The plain
// version's division by the Python scalar h runs on the card as a product
// with fl(1 / h), the reciprocal taken in double, so the kernels take
// inv_h = 1 / h from Python and multiply by it.
__device__ __forceinline__ void curl_at(const float* u, const float* v,
                                        float w_jp, float w_jm, float w_ip,
                                        float w_im, int c, int N,
                                        float inv_h, float& cx, float& cy,
                                        float& cz) {
  cx = 0.5f * (w_jp - w_jm) * inv_h - 0.5f * (v[c + 1] - v[c - 1]) * inv_h;
  cy = 0.5f * (u[c + 1] - u[c - 1]) * inv_h - 0.5f * (w_ip - w_im) * inv_h;
  cz = 0.5f * (v[c + N * N] - v[c - N * N]) * inv_h
       - 0.5f * (u[c + N] - u[c - N]) * inv_h;
}

// Half A at output cell idx: w_out = w' (if buoy), mag_out = |curl(u, v,
// w')| on the interior and 0 on the ghosts (if vort).
__device__ __forceinline__ void forcing_a_cell(
    int idx, const float* u, const float* v, const float* w,
    const float* dens, const float* temp, float* w_out, float* mag_out,
    int n, int buoy, int vort, Buoyancy b, float inv_h, Place pl) {
  Cell cell;
  if (!cell_at(idx, n, pl, cell)) return;
  const int N = n + 2;
  const int o = out_index(cell, n);
  if (!cell.ok) {
    if (buoy) w_out[o] = 0.0f;
    if (vort) mag_out[o] = 0.0f;
    return;
  }
  if (buoy) w_out[o] = cell.sign(3) * buoyant_w(w, dens, temp, cell.c, b);
  if (!vort) return;
  if (!is_interior(cell, N)) {
    mag_out[o] = 0.0f;
    return;
  }
  const int i = cell.i, j = cell.j, k = cell.k;
  float cx, cy, cz;
  curl_at(u, v, w_prime(w, dens, temp, i, j + 1, k, n, buoy, b, pl),
          w_prime(w, dens, temp, i, j - 1, k, n, buoy, b, pl),
          w_prime(w, dens, temp, i + 1, j, k, n, buoy, b, pl),
          w_prime(w, dens, temp, i - 1, j, k, n, buoy, b, pl), cell.c, N,
          inv_h, cx, cy, cz);
  mag_out[o] = sqrtf(cx * cx + cy * cy + cz * cz);
}

__device__ __forceinline__ void forcing_a_cell(
    int idx, const float* u, const float* v, const float* w,
    const float* dens, const float* temp, float* w_out, float* mag_out,
    int n, int buoy, int vort, Buoyancy b, float inv_h) {
  forcing_a_cell(idx, u, v, w, dens, temp, w_out, mag_out, n, buoy, vort, b,
                 inv_h, cubic(n));
}

// Half B at output cell idx: the confinement force eps h (N x curl) added
// to u, v, w' (w' from half A, or w without buoyancy), then set_bnd3d(1 /
// 2 / 3).
__device__ __forceinline__ void forcing_b_cell(int idx, const float* u,
                                               const float* v, const float* w,
                                               const float* mag, float* uo,
                                               float* vo, float* wo, int n,
                                               float dt, float eps_h,
                                               float inv_h, Place pl) {
  Cell cell;
  if (!cell_at(idx, n, pl, cell)) return;
  const int o = out_index(cell, n);
  if (!cell.ok) {
    uo[o] = vo[o] = wo[o] = 0.0f;
    return;
  }
  const int N = n + 2, c = cell.c;
  float cx, cy, cz;
  curl_at(u, v, w[c + N], w[c - N], w[c + N * N], w[c - N * N], c, N, inv_h,
          cx, cy, cz);
  float gx = 0.5f * (mag[c + N * N] - mag[c - N * N]) * inv_h;
  float gy = 0.5f * (mag[c + N] - mag[c - N]) * inv_h;
  float gz = 0.5f * (mag[c + 1] - mag[c - 1]) * inv_h;
  const float norm = sqrtf(gx * gx + gy * gy + gz * gz) + 1e-5f;
  gx = gx / norm;
  gy = gy / norm;
  gz = gz / norm;
  uo[o] = cell.sign(1) * (u[c] + dt * (eps_h * (gy * cz - gz * cy)));
  vo[o] = cell.sign(2) * (v[c] + dt * (eps_h * (gz * cx - gx * cz)));
  wo[o] = cell.sign(3) * (w[c] + dt * (eps_h * (gx * cy - gy * cx)));
}

__device__ __forceinline__ void forcing_b_cell(int idx, const float* u,
                                               const float* v, const float* w,
                                               const float* mag, float* uo,
                                               float* vo, float* wo, int n,
                                               float dt, float eps_h,
                                               float inv_h) {
  forcing_b_cell(idx, u, v, w, mag, uo, vo, wo, n, dt, eps_h, inv_h,
                 cubic(n));
}

}  // namespace tf
