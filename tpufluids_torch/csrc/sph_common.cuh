// Smoothing kernels shared by the SPH pair passes (sph_forces.cu,
// sph_unidyn.cu), with the operations per pair of
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

}  // namespace tf_sph
