// Smoothing kernels and candidate-walk helpers shared by the SPH pair
// passes (sph_forces.cu, sph_unidyn.cu), with the operations per pair of
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

// How a home row walks its candidates beyond the plain 27-cell runs.
struct Walk {
  int b, w_cap;                 // column caps (config.column_caps)
  float xmin, ymin, zmin, cs;   // domain minimum and cell size (stale)
};

// Current truncated cell coordinates of a row (x, y, z, ...), as
// binning.cell_trunc: trunc((x - xmin) / cs), a true division.
__device__ __forceinline__ void cells_now(const float4& a, const Walk& w,
                                          float c[3]) {
  c[0] = truncf((a.x - w.xmin) / w.cs);
  c[1] = truncf((a.y - w.ymin) / w.cs);
  c[2] = truncf((a.z - w.zmin) / w.cs);
}

// The stale walks' pair mask (forces.near_cells): the candidate's
// current cells are within one of the home row's cells ci on each axis.
__device__ __forceinline__ bool near_now(const float ci[3], const float4& a,
                                         const Walk& w) {
  float cj[3];
  cells_now(a, w, cj);
  return fabsf(ci[0] - cj[0]) <= 1.f && fabsf(ci[1] - cj[1]) <= 1.f &&
         fabsf(ci[2] - cj[2]) <= 1.f;
}

}  // namespace tf_sph
