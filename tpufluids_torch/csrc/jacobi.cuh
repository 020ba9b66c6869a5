// Cell bodies of the Jacobi and red-black solves, shared by the blocked
// kernels (rb_blocked.cu, jacobi_blocked.cu) and the blocked passes of
// the whole tier (step_blocked.cuh: the whole solve, the multi-field
// diffusion, the fused projection and the whole step).
//
// The arithmetic is the reference's (stam.lin_solve3d): the neighbours
// summed as ((((x[i-1] + x[i+1]) + x[j-1]) + x[j+1]) + x[k-1]) + x[k+1],
// then (x0 + a * nb) * c_inv, one rounding per operation (-fmad=false),
// as the plain PyTorch version does, so kernel and plain version agree
// bit for bit.  A NULL initial guess is a zero field.
//
// Storage type.  The cell bodies are templated on the type the fields
// are stored in: float, or __nv_bfloat16 for the reference's bfloat16
// solve (lin_solve3d_pallas(dtype=bfloat16)), where every operation
// rounds to bfloat16.  A bfloat16 operation is computed in float32 and
// rounded to bfloat16 (RN) at once: the float32 sum or product of two
// bfloat16 values rounds to the correctly rounded bfloat16 result, since
// float32's 24 bits are at least 2 * 8 + 2.  The scalars a and c_inv
// arrive as floats that bfloat16 represents exactly (the wrapper rounds
// them, as the reference's weak-typed scalars are rounded).
//
// Ghosts.  A Jacobi sweep is out of place and writes every output cell,
// ghosts included (grid_common.cuh), so each sweep reads the ghosts the
// previous one wrote, and the first reads the input's stored ghosts, as
// the reference does.  A red-black half-sweep updates in place, so a
// ghost written in the same launch could race with the face cell that
// reads it.  Instead only the first half-sweep reads stored ghosts (from
// the input, into a separate output); every later one takes a ghost tap
// as the updating cell's own value times the set_bnd sign of that face,
// which is what set_bnd3d left there after the previous half-sweep.  One
// pass after the last half-sweep writes the ghosts.
//
// The whole tier runs its solves as blocked passes in one cooperative
// launch, a grid-wide barrier between passes (step_blocked.cuh).  Inside
// a cooperative kernel no pointer is __restrict__: fields written in one
// pass are read in the next, and must not come through the non-coherent
// read-only path.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "divgrad.cuh"

namespace tf {

namespace cg = cooperative_groups;

// Loads a stored value as float, and rounds a float to the storage type.
template <typename T>
struct Store;

template <>
struct Store<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Store<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 round(float v) {
    return __float2bfloat16_rn(v);
  }
};

// x + y and s * x, rounded once to the storage type.
template <typename T>
__device__ __forceinline__ T add_rn(T x, T y) {
  return Store<T>::round(Store<T>::load(x) + Store<T>::load(y));
}

template <typename T>
__device__ __forceinline__ T mul_rn(float s, T x) {
  return Store<T>::round(s * Store<T>::load(x));
}

// (x0c + a * nb) * c_inv with nb the six neighbours summed in the
// reference's order, x-1, x+1, y-1, y+1, z-1, z+1: the one cell update
// of every Jacobi and red-black kernel, so their sums cannot drift apart.
template <typename T>
__device__ __forceinline__ T cell_update(T x0c, T xm, T xp, T ym, T yp,
                                         T zm, T zp, float a, float c_inv) {
  T nb = add_rn(xm, xp);
  nb = add_rn(nb, ym);
  nb = add_rn(nb, yp);
  nb = add_rn(nb, zm);
  nb = add_rn(nb, zp);
  return mul_rn(c_inv, add_rn(x0c, mul_rn(a, nb)));
}

// Two cells of one storage type side by side in a 4- or 8-byte word (a
// slot of the blocked kernels): loaded and stored as one word, updated
// lane by lane.
template <typename T>
struct Pair;

template <>
struct Pair<float> {
  using V = float2;
  static __device__ __forceinline__ V load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void store(float* p, V v) {
    *reinterpret_cast<float2*>(p) = v;
  }
  static __device__ __forceinline__ float lo(V v) { return v.x; }
  static __device__ __forceinline__ float hi(V v) { return v.y; }
  // the z taps of two cells whose neighbours are p[e], p[e+1] and
  // p[e+1], p[e+2]: (p[e], p[e+1]) and (p[e+1], p[e+2])
  static __device__ __forceinline__ void z_taps(const float* p, int e,
                                                V& zm, V& zp) {
    const float z0 = p[e], z1 = p[e + 1], z2 = p[e + 2];
    zm = make_float2(z0, z1);
    zp = make_float2(z1, z2);
  }
  // lane by lane: ``stored``, or where l0 / l1 the cell's own value times
  // the face's sign s
  static __device__ __forceinline__ V tap(V stored, V own, float s, bool l0,
                                          bool l1);
};

template <>
struct Pair<__nv_bfloat16> {
  using V = __nv_bfloat162;
  static __device__ __forceinline__ V load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const __nv_bfloat162*>(p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, V v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = v;
  }
  static __device__ __forceinline__ __nv_bfloat16 lo(V v) {
    return __low2bfloat16(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 hi(V v) {
    return __high2bfloat16(v);
  }
  static __device__ __forceinline__ unsigned bits(V v) {
    return *reinterpret_cast<const unsigned*>(&v);
  }
  static __device__ __forceinline__ V of_bits(unsigned u) {
    V v;
    *reinterpret_cast<unsigned*>(&v) = u;
    return v;
  }
  // (hi half of ``a``, lo half of ``b``): the pair that straddles two
  // words, one byte permute
  static __device__ __forceinline__ V straddle(unsigned a, unsigned b) {
    return of_bits(__byte_perm(a, b, 0x5432));
  }
  // As Pair<float>::z_taps, p word-aligned: of the two pairs one is a
  // word and the other straddles two (which one, e's parity says).
  static __device__ __forceinline__ void z_taps(const __nv_bfloat16* p,
                                                int e, V& zm, V& zp) {
    const unsigned* w = reinterpret_cast<const unsigned*>(p) + (e >> 1);
    const unsigned lo = w[0], hi = w[1];
    const V mid = straddle(lo, hi);
    zm = e & 1 ? mid : of_bits(lo);
    zp = e & 1 ? of_bits(hi) : mid;
  }
  static __device__ __forceinline__ V tap(V stored, V own, float s, bool l0,
                                          bool l1);
};

// Two cells at once, lane by lane.  In float32 two cell_update calls; in
// bfloat16 one bf16x2 instruction an operation (add.rn.bf16x2,
// mul.rn.bf16x2 on sm_90), the sum in the same order.  The correctly
// rounded bfloat16 result of a bfloat16 operation equals the float32
// result rounded to bfloat16 (the rule above), so this is the scalar
// cell_update of each lane bit for bit; the _rn forms are never
// contracted into an FMA.
__device__ __forceinline__ float2 cell_update(float2 x0c, float2 xm,
                                              float2 xp, float2 ym,
                                              float2 yp, float2 zm,
                                              float2 zp, float a,
                                              float c_inv) {
  return make_float2(
      cell_update(x0c.x, xm.x, xp.x, ym.x, yp.x, zm.x, zp.x, a, c_inv),
      cell_update(x0c.y, xm.y, xp.y, ym.y, yp.y, zm.y, zp.y, a, c_inv));
}

__device__ __forceinline__ __nv_bfloat162 cell_update(
    __nv_bfloat162 x0c, __nv_bfloat162 xm, __nv_bfloat162 xp,
    __nv_bfloat162 ym, __nv_bfloat162 yp, __nv_bfloat162 zm,
    __nv_bfloat162 zp, float a, float c_inv) {
  // a and c_inv are bfloat16 values (the wrapper rounds them): exact
  const __nv_bfloat162 a2 = __float2bfloat162_rn(a);
  const __nv_bfloat162 c2 = __float2bfloat162_rn(c_inv);
  __nv_bfloat162 nb = __hadd2_rn(xm, xp);
  nb = __hadd2_rn(nb, ym);
  nb = __hadd2_rn(nb, yp);
  nb = __hadd2_rn(nb, zm);
  nb = __hadd2_rn(nb, zp);
  return __hmul2_rn(c2, __hadd2_rn(x0c, __hmul2_rn(a2, nb)));
}

__device__ __forceinline__ float2 Pair<float>::tap(float2 stored, float2 own,
                                                   float s, bool l0,
                                                   bool l1) {
  return make_float2(l0 ? mul_rn(s, own.x) : stored.x,
                     l1 ? mul_rn(s, own.y) : stored.y);
}

// s * own is exact in bfloat16 (s is +-1), -0 included.
__device__ __forceinline__ __nv_bfloat162 Pair<__nv_bfloat16>::tap(
    __nv_bfloat162 stored, __nv_bfloat162 own, float s, bool l0, bool l1) {
  const __nv_bfloat162 so = __hmul2_rn(__float2bfloat162_rn(s), own);
  return __halves2bfloat162(l0 ? __low2bfloat16(so) : __low2bfloat16(stored),
                            l1 ? __high2bfloat16(so)
                               : __high2bfloat16(stored));
}

// Ghost cell t of x set to the value set_bnd3d(b) gives it.  The ghost
// cells in order: the x faces (2 N^2 cells), then the y faces without
// the x ghosts (2 n N), then the z faces without either (2 n^2): N^3 -
// n^3 in all.
template <typename T>
__device__ __forceinline__ void ghost_cell(int t, T* x, int n, int b) {
  const int N = n + 2;
  int i, j, k;
  if (t < 2 * N * N) {
    i = t / (N * N) ? N - 1 : 0;
    j = (t / N) % N;
    k = t % N;
  } else if ((t -= 2 * N * N) < 2 * n * N) {
    j = t / (n * N) ? N - 1 : 0;
    i = 1 + (t / N) % n;
    k = t % N;
  } else if ((t -= 2 * n * N) < 2 * n * n) {
    k = t / (n * n) ? N - 1 : 0;
    i = 1 + (t / n) % n;
    j = 1 + t % n;
  } else {
    return;
  }
  Cell cell;
  cell_from(i, j, k, n, cell);
  x[out_index(cell, n)] = mul_rn(cell.sign(b), x[cell.c]);
}

struct Signs {
  float x, y, z;
};

__host__ __device__ inline Signs signs_for(int b) {
  return {b == 1 ? -1.0f : 1.0f, b == 2 ? -1.0f : 1.0f,
          b == 3 ? -1.0f : 1.0f};
}

inline unsigned blocks_of(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

// The cells of a launch that strides over the grid: thread t takes
// cells t, t + stride, ... (the whole step's elementwise phases).
struct GridLoop {
  int start, stride;
  __device__ GridLoop()
      : start(blockIdx.x * blockDim.x + threadIdx.x),
        stride(gridDim.x * blockDim.x) {}
};

}  // namespace tf
