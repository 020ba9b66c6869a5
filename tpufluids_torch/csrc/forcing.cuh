// The arithmetic of the forcing (buoyancy + vorticity confinement), shared
// by the x-march of forcing.cu and the whole step of step.cu, so that the
// two give the same bits: value functions of a cell's inputs
// (buoyant_value, curl_of, curl_mag, confine), whatever memory they come
// from.  Arithmetic follows stam.buoyancy3d and
// stam.vorticity_confinement3d operation by operation.  The whole step
// runs the forcing as two halves over device memory (forcing_a_cell,
// forcing_b_cell) through two scratch fields.  No pointer here is
// __restrict__: the whole step reads in one phase what another block
// wrote in the phase before (jacobi.cuh).
#pragma once

#include <math.h>

#include "grid_common.cuh"

namespace tf {

struct Buoyancy {
  float dt, alpha, beta, t_amb;
};

// w + dt (-alpha dens + beta (temp - t_amb)): w after buoyancy.
__device__ __forceinline__ float buoyant_value(float w, float dens,
                                               float temp, Buoyancy b) {
  const float f = -b.alpha * dens + b.beta * (temp - b.t_amb);
  return w + b.dt * f;
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
  return (ck != k ? -1.0f : 1.0f) * buoyant_value(w[c], dens[c], temp[c], b);
}

// The three curl components at an interior cell from its neighbours'
// values: u at y +- 1 and z +- 1, v at z +- 1 and x +- 1, w' at y +- 1
// and x +- 1.  The plain version's division by the Python scalar h runs
// on the card as a product with fl(1 / h), the reciprocal taken in
// double, so the kernels take inv_h = 1 / h from Python and multiply by
// it.
__device__ __forceinline__ void curl_of(float u_yp, float u_ym, float u_zp,
                                        float u_zm, float v_zp, float v_zm,
                                        float v_xp, float v_xm, float w_yp,
                                        float w_ym, float w_xp, float w_xm,
                                        float inv_h, float& cx, float& cy,
                                        float& cz) {
  cx = 0.5f * (w_yp - w_ym) * inv_h - 0.5f * (v_zp - v_zm) * inv_h;
  cy = 0.5f * (u_zp - u_zm) * inv_h - 0.5f * (w_xp - w_xm) * inv_h;
  cz = 0.5f * (v_xp - v_xm) * inv_h - 0.5f * (u_yp - u_ym) * inv_h;
}

__device__ __forceinline__ float curl_mag(float cx, float cy, float cz) {
  return sqrtf(cx * cx + cy * cy + cz * cz);
}

// The confined (u, v, w) of a cell, before its set_bnd sign: the force eps
// h (N x curl) added, N the normalised gradient of |curl| from its
// neighbours' |curl| (0 on the ghosts).
__device__ __forceinline__ void confine(float u, float v, float w, float cx,
                                        float cy, float cz, float m_xp,
                                        float m_xm, float m_yp, float m_ym,
                                        float m_zp, float m_zm, float dt,
                                        float eps_h, float inv_h, float& fu,
                                        float& fv, float& fw) {
  float gx = 0.5f * (m_xp - m_xm) * inv_h;
  float gy = 0.5f * (m_yp - m_ym) * inv_h;
  float gz = 0.5f * (m_zp - m_zm) * inv_h;
  const float norm = sqrtf(gx * gx + gy * gy + gz * gz) + 1e-5f;
  gx = gx / norm;
  gy = gy / norm;
  gz = gz / norm;
  fu = u + dt * (eps_h * (gy * cz - gz * cy));
  fv = v + dt * (eps_h * (gz * cx - gx * cz));
  fw = w + dt * (eps_h * (gx * cy - gy * cx));
}

// Half A at output cell idx: w_out = w' (if buoy), mag_out = |curl(u, v,
// w')| on the interior and 0 on the ghosts (if vort).  With vort off it is
// the buoyancy-only pass of forcing.cu.
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
  const int c = cell.c;
  if (buoy)
    w_out[o] = cell.sign(3) * buoyant_value(w[c], dens[c], temp[c], b);
  if (!vort) return;
  if (!is_interior(cell, N)) {
    mag_out[o] = 0.0f;
    return;
  }
  const int i = cell.i, j = cell.j, k = cell.k;
  float cx, cy, cz;
  curl_of(u[c + N], u[c - N], u[c + 1], u[c - 1], v[c + 1], v[c - 1],
          v[c + N * N], v[c - N * N],
          w_prime(w, dens, temp, i, j + 1, k, n, buoy, b, pl),
          w_prime(w, dens, temp, i, j - 1, k, n, buoy, b, pl),
          w_prime(w, dens, temp, i + 1, j, k, n, buoy, b, pl),
          w_prime(w, dens, temp, i - 1, j, k, n, buoy, b, pl), inv_h, cx,
          cy, cz);
  mag_out[o] = curl_mag(cx, cy, cz);
}

__device__ __forceinline__ void forcing_a_cell(
    int idx, const float* u, const float* v, const float* w,
    const float* dens, const float* temp, float* w_out, float* mag_out,
    int n, int buoy, int vort, Buoyancy b, float inv_h) {
  forcing_a_cell(idx, u, v, w, dens, temp, w_out, mag_out, n, buoy, vort, b,
                 inv_h, cubic(n));
}

// Half B at output cell idx: u, v, w' (w' from half A, or w without
// buoyancy) confined, then set_bnd3d(1 / 2 / 3).
__device__ __forceinline__ void forcing_b_cell(int idx, const float* u,
                                               const float* v, const float* w,
                                               const float* mag, float* uo,
                                               float* vo, float* wo, int n,
                                               float dt, float eps_h,
                                               float inv_h) {
  Cell cell;
  if (!cell_at(idx, n, cell)) return;
  const int o = out_index(cell, n);
  const int N = n + 2, NN = N * N, c = cell.c;
  float cx, cy, cz, fu, fv, fw;
  curl_of(u[c + N], u[c - N], u[c + 1], u[c - 1], v[c + 1], v[c - 1],
          v[c + NN], v[c - NN], w[c + N], w[c - N], w[c + NN], w[c - NN],
          inv_h, cx, cy, cz);
  confine(u[c], v[c], w[c], cx, cy, cz, mag[c + NN], mag[c - NN], mag[c + N],
          mag[c - N], mag[c + 1], mag[c - 1], dt, eps_h, inv_h, fu, fv, fw);
  uo[o] = cell.sign(1) * fu;
  vo[o] = cell.sign(2) * fv;
  wo[o] = cell.sign(3) * fw;
}

}  // namespace tf
