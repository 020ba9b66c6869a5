// Cell bodies and whole-tier phases of the Jacobi and red-black solves,
// shared by the streamed and cooperative kernels of jacobi.cu and the
// whole step of step.cu.
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
// The whole tier's fused projection runs in one cooperative launch with a
// grid-wide barrier between sweeps and phases (the whole solve, the
// multi-field diffusion and the whole step run blocked passes instead:
// step_blocked.cuh).  66^3 cells (64^3) are more than the card keeps
// resident, so the threads stride over the cells, and the grid is sized
// by the occupancy query.  Inside a cooperative kernel no pointer is
// __restrict__: fields written in one phase are read in the next, and
// must not come through the non-coherent read-only path.
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

// The Jacobi update of interior cell c from src (NULL: zeros).
template <typename T>
__device__ __forceinline__ T jacobi_at(const T* src, const T* x0, int c,
                                       int N, float a, float c_inv) {
  if (src)
    return cell_update(x0[c], src[c - N * N], src[c + N * N], src[c - N],
                       src[c + N], src[c - 1], src[c + 1], a, c_inv);
  return mul_rn(c_inv, add_rn(x0[c], mul_rn(a, Store<T>::round(0.0f))));
}

// One output cell of a Jacobi sweep followed by set_bnd3d(b).
template <typename T>
__device__ __forceinline__ void jacobi_cell(int idx, const T* src,
                                            const T* x0, T* dst, int n,
                                            int b, float a, float c_inv) {
  Cell cell;
  if (!cell_at(idx, n, cell)) return;
  dst[out_index(cell, n)] =
      mul_rn(cell.sign(b), jacobi_at(src, x0, cell.c, n + 2, a, c_inv));
}

// Active cells of a red-black half-sweep.  Interior cell (I, J, K),
// 1-based, has parity (I + J + K + 1) % 2: the reference's _checker sums
// the 0-based interior indices, so cell (1, 1, 1) has parity 0.
__device__ __forceinline__ int rb_threads(int n) {
  return n * n * ((n + 1) / 2);
}

// Thread t of the half-sweep of parity p owns the pair of cells
// K = 2q + 1, 2q + 2 of row (I, J); one of them is active.  ``first``:
// src is the solve's input (or NULL), read with its stored ghosts, and
// the inactive cell is copied to dst; otherwise src == dst (in place)
// and a ghost tap is s * (the active cell's own value).
template <typename T>
__device__ __forceinline__ void rb_cell(int t, const T* src, const T* x0,
                                        T* dst, int n, int p, bool first,
                                        float sx, float sy, float sz,
                                        float a, float c_inv) {
  const int half = (n + 1) / 2;
  if (t >= n * n * half) return;
  const int I = 1 + t / (n * half);
  const int J = 1 + (t / half) % n;
  const int q = t % half;
  const int odd = (p + I + J) & 1;
  const int N = n + 2;
  const int row = (I * N + J) * N;
  const int Ki = 2 * q + 2 - odd;
  if (first && Ki <= n)
    dst[row + Ki] = src ? src[row + Ki] : Store<T>::round(0.0f);
  const int K = 2 * q + 1 + odd;
  if (K > n) return;
  const int c = row + K;
  if (first) {
    dst[c] = jacobi_at(src, x0, c, N, a, c_inv);
    return;
  }
  const T own = src[c];
  dst[c] = cell_update(x0[c], I == 1 ? mul_rn(sx, own) : src[c - N * N],
                       I == n ? mul_rn(sx, own) : src[c + N * N],
                       J == 1 ? mul_rn(sy, own) : src[c - N],
                       J == n ? mul_rn(sy, own) : src[c + N],
                       K == 1 ? mul_rn(sz, own) : src[c - 1],
                       K == n ? mul_rn(sz, own) : src[c + 1], a, c_inv);
}

// Ghost cells: the x faces (2 N^2 cells), then the y faces without the x
// ghosts (2 n N), then the z faces without either (2 n^2): N^3 - n^3.
__device__ __forceinline__ int ghost_threads(int n) {
  const int N = n + 2;
  return 2 * N * N + 2 * n * N + 2 * n * n;
}

// Ghost cell t of x set to the value set_bnd3d(b) gives it.
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

// The buffer Jacobi sweep s of ``iters`` writes: out for the last sweep,
// and alternately tmp and out before it.
template <typename T>
__host__ __device__ inline T* sweep_dst(int s, int iters, T* out, T* tmp) {
  return ((iters - 1 - s) & 1) ? tmp : out;
}

inline unsigned blocks_of(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

// ---------------------------------------------------------------------------
// whole tier: phases of one cooperative launch

struct GridLoop {
  int start, stride;
  __device__ GridLoop()
      : start(blockIdx.x * blockDim.x + threadIdx.x),
        stride(gridDim.x * blockDim.x) {}
};

template <typename T>
struct SolveArgs {
  const T* x;  // the initial guess; NULL: zeros
  const T* x0;
  T *out, *tmp;  // tmp: the second Jacobi buffer (unused by red-black)
  int b, n, iters, red_black;
  float a, c_inv;
};

// A whole solve, every sweep of the streamed kernels' launches in turn
// (the fused projection's pressure solve): Jacobi sweeps out of place
// between out and tmp, the first reading x's stored ghosts, or red-black
// half-sweeps in place on out after the first (the ghost-race scheme
// above), then the ghost pass.
template <typename T>
__device__ __forceinline__ void solve_phase(cg::grid_group& grid,
                                            const GridLoop& loop,
                                            const SolveArgs<T>& g) {
  const int n = g.n;
  if (g.red_black) {
    const Signs s = signs_for(g.b);
    const int active = rb_threads(n);
    for (int it = 0; it < g.iters; ++it) {
      for (int par = 0; par < 2; ++par) {
        const bool first = it == 0 && par == 0;
        for (int t = loop.start; t < active; t += loop.stride)
          rb_cell(t, first ? g.x : g.out, g.x0, g.out, n, par, first, s.x,
                  s.y, s.z, g.a, g.c_inv);
        grid.sync();
      }
    }
    const int ghosts = ghost_threads(n);
    for (int t = loop.start; t < ghosts; t += loop.stride)
      ghost_cell(t, g.out, n, g.b);
    return;
  }
  const int cells = (n + 2) * (n + 2) * (n + 2);
  for (int s = 0; s < g.iters; ++s) {
    const T* src = s == 0 ? g.x : sweep_dst(s - 1, g.iters, g.out, g.tmp);
    T* dst = sweep_dst(s, g.iters, g.out, g.tmp);
    for (int idx = loop.start; idx < cells; idx += loop.stride)
      jacobi_cell(idx, src, g.x0, dst, n, g.b, g.a, g.c_inv);
    if (s + 1 < g.iters) grid.sync();
  }
}

struct ProjectArgs {
  const float *u, *v, *w;
  float *uo, *vo, *wo, *div, *p, *p2;
  int n, iters, red_black;
  float coef, inv_h, c_inv;
};

// divergence -> zero-guess pressure solve (a = 1, b = 0) -> gradient
// subtraction, the phases of stam.project3d's three-launch path.  p2 is
// the second Jacobi buffer (unused by red-black).  The caller syncs
// before anything reads uo, vo, wo.
__device__ __forceinline__ void project_phase(cg::grid_group& grid,
                                              const GridLoop& loop,
                                              const ProjectArgs& g) {
  const int n = g.n;
  const int cells = (n + 2) * (n + 2) * (n + 2);
  for (int idx = loop.start; idx < cells; idx += loop.stride)
    div_cell(idx, g.u, g.v, g.w, g.div, n, g.coef);
  grid.sync();
  const SolveArgs<float> solve{nullptr, g.div, g.p, g.p2, 0, n,
                               g.iters, g.red_black, 1.0f, g.c_inv};
  solve_phase(grid, loop, solve);
  grid.sync();
  for (int idx = loop.start; idx < cells; idx += loop.stride)
    gradsub_cell(idx, g.p, g.u, g.v, g.w, g.uo, g.vo, g.wo, n, g.inv_h);
}

// Launches ``kernel`` cooperatively with as many blocks as the card keeps
// resident (at most one thread per cell).  A launch the card refuses
// returns its error; nothing falls back to the streamed path.
template <typename Args>
int launch_cooperative(void (*kernel)(Args), Args args, int n,
                       cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  long long blocks = (long long)per_sm * sms;
  const long long need = blocks_of((long long)(n + 2) * (n + 2) * (n + 2));
  if (need < blocks) blocks = need;
  if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&args};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel,
                                          dim3((unsigned)blocks),
                                          dim3(kThreads), params, 0, stream);
}

}  // namespace tf
