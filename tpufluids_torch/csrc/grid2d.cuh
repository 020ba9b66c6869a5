// stam.set_bnd2d for the 2D kernels (the solve in grid2d.cu, the whole
// step in step2d.cu), which must agree on it bit for bit.
//
// A (n+2)^2 field, C order, y contiguous, one ghost layer a face.  After
// set_bnd2d(b) a ghost holds the value of its clamped interior cell times
// sx on an x edge and sy on a y edge (-1 on axis a iff b == a + 1), and a
// corner 0.5 (sy c + sx c), c the diagonal interior cell: set_bnd2d's
// average of the two edge cells beside it.
#pragma once

#include <cuda_runtime.h>

namespace tf {

// set_bnd2d's signs for b: sx on the x edges, sy on the y edges.
struct Bnd {
  float sx, sy;
};

__host__ __device__ inline Bnd bnd_for(int b) {
  return {b == 1 ? -1.0f : 1.0f, b == 2 ? -1.0f : 1.0f};
}

// The value set_bnd2d leaves at an output cell whose clamped interior
// cell holds c: xo / yo whether the cell lies on a ghost row / column.
__device__ __forceinline__ float bnd(bool xo, bool yo, Bnd s, float c) {
  if (xo && yo) return 0.5f * (s.sy * c + s.sx * c);
  if (xo) return s.sx * c;
  if (yo) return s.sy * c;
  return c;
}

}  // namespace tf
