// Smoothing kernels and the candidate walk shared by the SPH pair passes
// (sph_forces.cu, sph_unidyn.cu), with the operations per pair of
// tpufluids_torch/kernels.py; the sources are built with -fmad=false.
#pragma once

#include <cuda_runtime.h>

namespace tf_sph {

// w_cubic (FluidGPU.cu:11-21); w_norm = PI_REF h^3
__device__ __forceinline__ float w_cubic(float ds, float h, float w_norm) {
  const float q = ds / h;
  float w;
  if (q <= 1.f) {
    w = 1.f - 1.5f * q * q + 0.75f * q * q * q;
  } else if (q < 2.f) {
    const float t = 2.f - q;
    w = 0.25f * (t * t * t);
  } else {
    w = 0.f;
  }
  return w / w_norm;
}

// grad_w_spiky (FluidGPU.cu:35-43) over the pair distance (ds > 0);
// spiky = -45 / (PI_REF h^6)
__device__ __forceinline__ float spiky_over_ds(float ds, float h,
                                               float spiky) {
  const float hr = h - ds;
  return (ds < h ? spiky * (hr * hr) : 0.f) / ds;
}

// Calls f(j) for the sorted rows j that lane ``lane`` of a home row's
// kLanes lanes takes of the 9 (dx, dy) runs around column (cx, cy), in
// binning.RUN_OFFSETS order, on a grid of gx x planes (the cube, gx = g,
// or a rank's x-slab: cx is local to it) of g x g columns.  Run (dx, dy)
// is the contiguous rows of cells z0..z1 of its column
// col = (cx + dx) g + cy + dy, where
// zrange(dx, dy, col, z0, z1) sets them and returns false to skip the
// run (z0 <= z1 within [0, g - 1] when it returns true); capped, only the
// first w_cap rows of each column.  The t-th walked slot, counted over
// all runs, pair or not, goes to lane t mod kLanes: the split follows
// the bin tables, not the positions.
template <int kLanes, bool kCapped, class Z, class F>
__device__ __forceinline__ void for_each_candidate(
    const int* __restrict__ cell_start, int cx, int cy, int gx, int g,
    int w_cap, int lane, Z&& zrange, F&& f) {
  static_assert(kLanes > 0 && (kLanes & (kLanes - 1)) == 0,
                "kLanes is a power of two");
  int t = 0;  // slots walked in the runs before this one
  for (int dx = -1; dx <= 1; ++dx) {
    const int nx = cx + dx;
    if (nx < 0 || nx >= gx) continue;
    for (int dy = -1; dy <= 1; ++dy) {
      const int ny = cy + dy;
      if (ny < 0 || ny >= g) continue;
      const int col = nx * g + ny;
      int z0, z1;
      if (!zrange(dx, dy, col, z0, z1)) continue;
      const int base = col * g;
      const int lo = cell_start[base + z0];
      int len = cell_start[base + z1 + 1] - lo;
      if (kCapped) len = min(len, max(cell_start[base] + w_cap - lo, 0));
      for (int s = (lane - t) & (kLanes - 1); s < len; s += kLanes) {
        f(lo + s);
      }
      t += len;
    }
  }
}

// The stale walks' z-window of one neighbour column (binning.stale_window):
// the cells z0..z1 of the column whose rows can be within one cell of a
// home row now at z-cell cz (binning.cell_trunc, a float), when no row
// of the column has moved more than d z-cells since the tables were
// built (d from forces.column_shift, d >= g for "unknown": the whole
// column).  A kept candidate's stale z-cell lies in [cz - 1 - d,
// cz + 1 + d].  cz is clamped to [-2g - 2, 2g + 2] before it becomes an
// int, which changes no window (one beyond that range is empty either
// way, as d < g); a NaN home, which keeps no pair, gets the low end, and
// so no window.  Returns false for an empty window.
__device__ __forceinline__ bool stale_window(float cz, int d, int g, int& z0,
                                             int& z1) {
  if (d >= g) {
    z0 = 0;
    z1 = g - 1;
    return true;
  }
  const float edge = 2.f * (float)g + 2.f;
  const int c = (int)fminf(fmaxf(cz, -edge), edge);
  z0 = max(c - 1 - d, 0);
  z1 = min(c + 1 + d, g - 1);
  return z0 <= z1;
}

}  // namespace tf_sph
