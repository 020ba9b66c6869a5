// The blocked phases of the whole 3D step (step.cu) and of the whole
// tier's lone calls (jacobi.cu): the projection, the diffusions and a
// Jacobi or red-black solve, each a few passes of several (half-)sweeps
// in shared memory with one grid-wide barrier after each pass, where a
// design of one barrier a sweep would pay some 1.1 us a sweep.
//
// Tiles and boxes.  A phase cuts the interior into tiles of tx x ty x tz
// cells (the host chooses them: kernels.step_plan); a block's box is its
// tile widened by ``halo`` cells, clipped to the (n+2)^3 array, held in
// shared memory with z contiguous.  A pass loads the box from the
// buffer the previous pass wrote, runs H levels in it, a block barrier
// between levels, and writes its tile; the next pass starts after a
// grid-wide barrier.
//
// The halo cone.  Level h of a pass of H updates the tile widened by e =
// H-1-h (+ 1 on a projection's last pass), clipped to the interior, and
// reads one cell further out, which level h-1 updated (or the load
// brought in, for level 0).  So a pass loads the tile widened by H (+ 1)
// and the tile comes out exact.
//
// Ghosts (the rules of rb_blocked.cu and jacobi_blocked.cu).  A tap
// across a domain face is the cell's own value times the face's set_bnd
// sign, which is what the ghost would hold, except where a level reads
// stored ghosts: level 0 of a diffusion pass (the field's own ghosts, or
// those the previous pass wrote), and the pressure solve's first
// (half-)sweep, from a zero guess (the box starts as zeros).  The
// pressure's passes write interior cells only; a diffusion pass writes
// every output cell whose clamped cell lies in its tile, ghosts
// included, each the clamped cell's value times its set_bnd3d sign.
//
// The projection.  Its first pass computes the divergence over the box
// into the box's x0 (div_value, the divergence kernel's own arithmetic),
// which stays in shared memory for the whole solve, so the divergence
// needs no buffer and no barrier of its own.  Its last pass updates the
// tile widened by one, so that the pressure is final on every cell the
// gradient reads, and subtracts the gradient on the tile and its ghosts
// (gradsub_value); the pressure's ghosts are those of set_bnd3d(0), the
// clamped cell's value.  So a projection costs one barrier a pass and
// nothing more.
//
// The solve.  blocked_solve runs the diffusions and the whole solve:
// Jacobi or red-black, any b, from a given initial guess (read with its
// stored ghosts by the first (half-)sweep) or from zeros, the fields
// stored as float or as __nv_bfloat16 (every operation rounded to the
// storage type, tf::cell_update).  Red-black passes write the tile's
// interior cells, the last pass every owned cell with its ghosts (the
// set_bnd3d signs of tf::ghost_cell), so no ghost pass follows.
//
// Per cell the arithmetic is tf::cell_update's, in the order of the
// streamed kernels, so a blocked phase equals the separate kernels bit
// for bit (tests/test_torch_step_blocked.py and
// tests/test_torch_solve_blocked.py emulate it tile by tile).
#pragma once

#include "jacobi.cuh"

namespace tf {

// The tiles of a blocked phase: cy x cz tiles a row of x, ``count`` in
// all, in C order; a box is a tile widened by ``halo``.
struct StepTiles {
  int tx, ty, tz, halo;
  int cy, cz, count;
};

// One block's box: its tile, interior cells [x0, x1] x [y0, y1] x [z0,
// z1], and the box, nx x ny x nz cells from array cell (bx, by, bz), z
// contiguous in rows of pz >= nz words, pz even: then a warp of a
// red-black level, whose neighbouring threads take cells a row of x
// apart, hits 32 banks (sx is even).  Indexed by constants only (no
// per-axis arrays, which would go to local memory).
struct Box {
  int x0, x1, y0, y1, z0, z1;
  int bx, by, bz, nx, ny, nz, pz;
  __device__ __forceinline__ int sy() const { return pz; }
  __device__ __forceinline__ int sx() const { return ny * pz; }
  __device__ __forceinline__ int at(int i, int j, int k) const {
    return ((i - bx) * ny + (j - by)) * pz + (k - bz);
  }
  __device__ __forceinline__ int cells() const { return nx * ny * pz; }
};

__device__ __forceinline__ Box box_of(const StepTiles& t, int tile, int n) {
  Box b;
  const int iz = tile % t.cz, iy = (tile / t.cz) % t.cy;
  const int ix = tile / (t.cz * t.cy);
  b.x0 = 1 + ix * t.tx;
  b.y0 = 1 + iy * t.ty;
  b.z0 = 1 + iz * t.tz;
  b.x1 = min(b.x0 + t.tx - 1, n);
  b.y1 = min(b.y0 + t.ty - 1, n);
  b.z1 = min(b.z0 + t.tz - 1, n);
  b.bx = max(b.x0 - t.halo, 0);
  b.by = max(b.y0 - t.halo, 0);
  b.bz = max(b.z0 - t.halo, 0);
  b.nx = min(b.x1 + t.halo, n + 1) - b.bx + 1;
  b.ny = min(b.y1 + t.halo, n + 1) - b.by + 1;
  b.nz = min(b.z1 + t.halo, n + 1) - b.bz + 1;
  b.pz = b.nz + (b.nz & 1);
  return b;
}

// Cells [i0, i0 + ni) x [j0, j0 + nj) x [k0, k0 + nk).
struct Region {
  int i0, j0, k0, ni, nj, nk;
};

// The tile widened by e, clipped to [lo, hi] on every axis.
__device__ __forceinline__ Region widen(const Box& b, int e, int lo, int hi) {
  Region r;
  r.i0 = max(b.x0 - e, lo);
  r.j0 = max(b.y0 - e, lo);
  r.k0 = max(b.z0 - e, lo);
  r.ni = min(b.x1 + e, hi) - r.i0 + 1;
  r.nj = min(b.y1 + e, hi) - r.j0 + 1;
  r.nk = min(b.z1 + e, hi) - r.k0 + 1;
  return r;
}

// The output cells whose clamped interior cell lies in the tile: the
// tile, and the ghosts beside it where it touches a face of the grid.
__device__ __forceinline__ Region owned(const Box& b, int n) {
  Region r;
  r.i0 = b.x0 == 1 ? 0 : b.x0;
  r.j0 = b.y0 == 1 ? 0 : b.y0;
  r.k0 = b.z0 == 1 ? 0 : b.z0;
  r.ni = (b.x1 == n ? n + 1 : b.x1) - r.i0 + 1;
  r.nj = (b.y1 == n ? n + 1 : b.y1) - r.j0 + 1;
  r.nk = (b.z1 == n ? n + 1 : b.z1) - r.k0 + 1;
  return r;
}

__device__ __forceinline__ int flat(int i, int j, int k, int N) {
  return (i * N + j) * N + k;
}

// How the threads of a block walk a region: each takes runs of rows
// along x of one (j, k) column, the columns cut into ``seg`` runs so that
// about every thread has one; a warp's threads hold neighbouring k, so
// their shared and device accesses are consecutive words.  A cell costs
// no index arithmetic beyond a step along the run.
struct Runs {
  int plane, seg, len;
  __device__ __forceinline__ explicit Runs(const Region& r) {
    plane = r.nj * r.nk;
    seg = min(r.ni, max(1, (int)blockDim.x / plane));
    len = (r.ni + seg - 1) / seg;
  }
  __device__ __forceinline__ int count() const { return plane * seg; }
  // run t: column (j, k), rows [i, i_end)
  __device__ __forceinline__ void at(const Region& r, int t, int& i,
                                     int& i_end, int& j, int& k) const {
    const int p = t % plane, q = t / plane;
    j = r.j0 + p / r.nk;
    k = r.k0 + p % r.nk;
    i = r.i0 + q * len;
    i_end = min(i + len, r.i0 + r.ni);
  }
};

// A stored cell read through L2 (__ldcg), not the read-only path: the
// fields were written before the last grid barrier.
__device__ __forceinline__ float ld_l2(const float* p) { return __ldcg(p); }

__device__ __forceinline__ __nv_bfloat16 ld_l2(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// Box cells of region r of two fields from device memory, S0 from g0 and
// S1 from g1 (g1 NULL: one field), eight rows of a run at a time.
template <typename T>
__device__ __forceinline__ void load_region(T* S0, const T* g0, T* S1,
                                            const T* g1, const Box& b,
                                            const Region& r, int N) {
  constexpr int kRows = 8;
  const Runs R(r);
  const int sx = b.sx(), NN = N * N;
  for (int t = threadIdx.x; t < R.count(); t += blockDim.x) {
    int i, ie, j, k;
    R.at(r, t, i, ie, j, k);
    int s = b.at(i, j, k), c = flat(i, j, k, N);
    for (; i < ie; i += kRows, s += kRows * sx, c += kRows * NN) {
      T v[kRows], w[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        if (i + q < ie) {
          v[q] = ld_l2(g0 + c + q * NN);
          if (g1) w[q] = ld_l2(g1 + c + q * NN);
        }
      }
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        if (i + q < ie) {
          S0[s + q * sx] = v[q];
          if (g1) S1[s + q * sx] = w[q];
        }
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void zero_box(T* S, const Box& b) {
  const T zero = Store<T>::round(0.0f);
  for (int t = threadIdx.x; t < b.cells(); t += blockDim.x) S[t] = zero;
}

// Taps across a face of the grid replaced by the cell's own value times
// the face's sign (what set_bnd3d leaves in the ghost).
template <typename T>
__device__ __forceinline__ void face_taps(T& xm, T& xp, T& ym, T& yp, T& zm,
                                          T& zp, T own, int i, int j, int k,
                                          int n, Signs sg) {
  xm = i == 1 ? mul_rn(sg.x, own) : xm;
  xp = i == n ? mul_rn(sg.x, own) : xp;
  ym = j == 1 ? mul_rn(sg.y, own) : ym;
  yp = j == n ? mul_rn(sg.y, own) : yp;
  zm = k == 1 ? mul_rn(sg.z, own) : zm;
  zp = k == n ? mul_rn(sg.z, own) : zp;
}

// A Jacobi sweep over the interior cells of region r, from S into D,
// each cell tf::cell_update of its six neighbours.  A run carries the
// cell and the one below it to the next row.  ``first``: read the stored
// neighbours; else a tap across a face of the grid is the cell's own
// value times the face's sign.
template <typename T>
__device__ __forceinline__ void jacobi_level(const T* S, T* D, const T* X0,
                                             const Box& b, const Region& r,
                                             int n, bool first, Signs sg,
                                             float a, float c_inv) {
  const Runs R(r);
  const int sx = b.sx(), sy = b.sy();
  for (int t = threadIdx.x; t < R.count(); t += blockDim.x) {
    int i, ie, j, k;
    R.at(r, t, i, ie, j, k);
    if (i >= ie) continue;
    const bool column_face = j == 1 || j == n || k == 1 || k == n;
    int s = b.at(i, j, k);
    T xm = S[s - sx], own = S[s];
    for (; i < ie; ++i, s += sx) {
      const T xp = S[s + sx];
      T ym = S[s - sy], yp = S[s + sy], zm = S[s - 1], zp = S[s + 1];
      T tm = xm, tp = xp;
      if (!first && (column_face || i == 1 || i == n))
        face_taps(tm, tp, ym, yp, zm, zp, own, i, j, k, n, sg);
      D[s] = cell_update(X0[s], tm, tp, ym, yp, zm, zp, a, c_inv);
      xm = own;
      own = xp;
    }
  }
}

// A red-black half-sweep of parity p over the interior cells of region r,
// in place in S, each cell tf::cell_update.  A run visits the rows of its
// column whose cell has parity p ((i + j + k + 1) % 2 == p), every
// second row; they read only cells of the other parity, which the level
// does not write, and the x neighbour above one is the one below the
// next.  ``first``: the solve's first half-sweep, which reads the stored
// neighbours (the guess's, ghosts included, or zeros); else a tap across
// a face of the grid is the cell's own value times the face's sign.
template <typename T>
__device__ __forceinline__ void rb_level(T* S, const T* X0, const Box& b,
                                         const Region& r, int n, int p,
                                         bool first, Signs sg, float a,
                                         float c_inv) {
  const Runs R(r);
  const int sx = b.sx(), sy = b.sy();
  for (int t = threadIdx.x; t < R.count(); t += blockDim.x) {
    int i, ie, j, k;
    R.at(r, t, i, ie, j, k);
    i += (p + i + j + k + 1) & 1;
    if (i >= ie) continue;
    const bool column_face = j == 1 || j == n || k == 1 || k == n;
    int s = b.at(i, j, k);
    T xm = S[s - sx];
    for (; i < ie; i += 2, s += 2 * sx) {
      const T xp = S[s + sx];
      T ym = S[s - sy], yp = S[s + sy], zm = S[s - 1], zp = S[s + 1];
      T tm = xm, tp = xp;
      if (!first && (column_face || i == 1 || i == n))
        face_taps(tm, tp, ym, yp, zm, zp, S[s], i, j, k, n, sg);
      S[s] = cell_update(X0[s], tm, tp, ym, yp, zm, zp, a, c_inv);
      xm = xp;
    }
  }
}

// The tile's interior cells of S to dst.
template <typename T>
__device__ __forceinline__ void store_tile(const T* S, const Box& b, T* dst,
                                           int N) {
  const Region r = widen(b, 0, 1, N - 2);
  const Runs R(r);
  const int sx = b.sx(), NN = N * N;
  for (int t = threadIdx.x; t < R.count(); t += blockDim.x) {
    int i, ie, j, k;
    R.at(r, t, i, ie, j, k);
    int s = b.at(i, j, k), c = flat(i, j, k, N);
    for (; i < ie; ++i, s += sx, c += NN) dst[c] = S[s];
  }
}

// The set_bnd sign of output cell (i, j, k) for b, given its clamped
// cell: -1 where axis b - 1 is clamped (Cell::sign).
__device__ __forceinline__ float bnd_sign(int b, int i, int j, int k,
                                          int ci, int cj, int ck) {
  return b == 1 ? (ci != i ? -1.0f : 1.0f)
                : b == 2 ? (cj != j ? -1.0f : 1.0f)
                         : b == 3 ? (ck != k ? -1.0f : 1.0f) : 1.0f;
}

// The owned output cells to dst, each the clamped cell's value times its
// set_bnd3d(bnd) sign (tf::ghost_cell's rule).
template <typename T>
__device__ __forceinline__ void store_owned(const T* S, const Box& b, T* dst,
                                            int n, int bnd) {
  const Region r = owned(b, n);
  const Runs R(r);
  const int N = n + 2;
  for (int t = threadIdx.x; t < R.count(); t += blockDim.x) {
    int i, ie, j, k;
    R.at(r, t, i, ie, j, k);
    const int cj = clamp_interior(j, n), ck = clamp_interior(k, n);
    for (; i < ie; ++i) {
      const int ci = clamp_interior(i, n);
      dst[flat(i, j, k, N)] = mul_rn(bnd_sign(bnd, i, j, k, ci, cj, ck),
                                     S[b.at(ci, cj, ck)]);
    }
  }
}

// ---------------------------------------------------------------------------
// the projection

struct BlockedProject {
  const float *u, *v, *w;
  float *uo, *vo, *wo;
  float *p0, *p1;  // the pressure between passes, alternately
  int iters, red_black;
  int levels;  // (half-)sweeps a pass
  float coef, inv_h, c_inv;
  StepTiles tiles;  // halo levels + 1; no more tiles than blocks
};

// A projection of stam.project3d's three-launch path: divergence, the
// zero-guess pressure solve (a = 1, b = 0), gradient subtraction, in
// ceil(sweeps / levels) passes of the blocked solve, a grid-wide barrier
// after each.  Block t owns tile t for the whole solve, and keeps its
// x0 (the divergence) in shared memory; the pressure's box is loaded
// anew each pass.  ``smem`` holds three boxes (the third for Jacobi's
// second buffer; red-black takes two).  The whole step's projections
// (LONE false) end with a barrier, which its advection needs; a lone
// projection (the whole tier's fused projection) has none after its
// last pass: a compile-time choice, so that the step's code is its own.
template <bool LONE>
__device__ __forceinline__ void blocked_project(cg::grid_group& grid,
                                                const BlockedProject& g,
                                                float* smem, int n) {
  const int N = n + 2;
  const int total = g.red_black ? 2 * g.iters : g.iters;
  const int passes = (total + g.levels - 1) / g.levels;
  const bool owns = (int)blockIdx.x < g.tiles.count;
  const Box b = box_of(g.tiles, owns ? blockIdx.x : 0, n);
  const int vol = b.cells(), sx = b.sx(), sy = b.sy();
  float* X0 = smem;
  float* A = smem + vol;
  float* B = A + vol;
  if (owns) {
    // the divergence on every cell a level of any pass reads as x0, two
    // rows at a time: their loads in flight together
    const Region r = widen(b, g.tiles.halo - 1, 1, n);
    const Runs R(r);
    for (int t = threadIdx.x; t < R.count(); t += blockDim.x) {
      int i, ie, j, k;
      R.at(r, t, i, ie, j, k);
      int s = b.at(i, j, k), c = flat(i, j, k, N);
      for (; i + 1 < ie; i += 2, s += 2 * sx, c += 2 * N * N) {
        const float d0 = div_value(g.u, g.v, g.w, c, N, g.coef);
        const float d1 = div_value(g.u, g.v, g.w, c + N * N, N, g.coef);
        X0[s] = d0;
        X0[s + sx] = d1;
      }
      if (i < ie) X0[s] = div_value(g.u, g.v, g.w, c, N, g.coef);
    }
    zero_box(A, b);
  }
  for (int pass = 0; pass < passes; ++pass) {
    const bool last = pass == passes - 1;
    const int h0 = pass * g.levels, H = min(g.levels, total - h0);
    const int extra = last ? 1 : 0;
    if (owns) {
      if (pass > 0)
        load_region<float>(A, pass & 1 ? g.p0 : g.p1, nullptr, nullptr, b,
                           widen(b, H + extra, 0, n + 1), N);
      __syncthreads();
      float* cur = A;
      float* nxt = B;
      for (int h = 0; h < H; ++h) {
        // b = 0: a tap across a face is the cell's own value; red-black
        // in place, Jacobi from cur into nxt
        const Region r = widen(b, H - 1 - h + extra, 1, n);
        if (g.red_black) {
          rb_level(cur, X0, b, r, n, (h0 + h) & 1, h0 + h == 0,
                   Signs{1.0f, 1.0f, 1.0f}, 1.0f, g.c_inv);
        } else {
          jacobi_level(cur, nxt, X0, b, r, n, h0 + h == 0,
                       Signs{1.0f, 1.0f, 1.0f}, 1.0f, g.c_inv);
          float* t = cur;
          cur = nxt;
          nxt = t;
        }
        __syncthreads();
      }
      if (!last) {
        store_tile(cur, b, pass & 1 ? g.p1 : g.p0, N);
      } else {
        // q - 0.5 (p+ - p-) / h on the tile and its ghosts, then
        // set_bnd3d(1 / 2 / 3): tf::gradsub_cell, with p's ghosts
        // set_bnd3d(0)'s (the clamped cell's value); two rows at a time,
        // their velocity loads in flight together
        const Region r = owned(b, n);
        const Runs R(r);
        for (int t = threadIdx.x; t < R.count(); t += blockDim.x) {
          int i, ie, j, k;
          R.at(r, t, i, ie, j, k);
          const int cj = clamp_interior(j, n), ck = clamp_interior(k, n);
          const float sv = cj != j ? -1.0f : 1.0f;
          const float sw = ck != k ? -1.0f : 1.0f;
          for (; i < ie; i += 2) {
            float q[2][3];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (i + e < ie) {
                const int c = flat(clamp_interior(i + e, n), cj, ck, N);
                q[e][0] = g.u[c];
                q[e][1] = g.v[c];
                q[e][2] = g.w[c];
              }
            }
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (i + e < ie) {
                const int ci = clamp_interior(i + e, n);
                const int s = b.at(ci, cj, ck), o = flat(i + e, j, k, N);
                const float pc = cur[s];
                const float pxm = ci == 1 ? pc : cur[s - sx];
                const float pxp = ci == n ? pc : cur[s + sx];
                const float pym = cj == 1 ? pc : cur[s - sy];
                const float pyp = cj == n ? pc : cur[s + sy];
                const float pzm = ck == 1 ? pc : cur[s - 1];
                const float pzp = ck == n ? pc : cur[s + 1];
                g.uo[o] = (ci != i + e ? -1.0f : 1.0f) *
                          gradsub_value(q[e][0], pxm, pxp, g.inv_h);
                g.vo[o] = sv * gradsub_value(q[e][1], pym, pyp, g.inv_h);
                g.wo[o] = sw * gradsub_value(q[e][2], pzm, pzp, g.inv_h);
              }
            }
          }
        }
      }
    }
    if (!LONE || !last) grid.sync();
  }
}

// ---------------------------------------------------------------------------
// the diffusions and the whole solve

constexpr int kStepFields = 5;

template <typename T>
struct SolveField {
  const T* x;   // the initial guess, read by the first pass; NULL: zeros
  const T* x0;
  T *out, *tmp;  // the last pass lands in out; tmp alternates with it
  int b;
  float a, c_inv;
};

// A diffusion: x and x0 the field itself.
using DiffuseField = SolveField<float>;

// Up to F fields solved in the same passes.
template <typename T, int F>
struct BlockedSolve {
  SolveField<T> f[F];
  int fields, iters;
  int levels;  // (half-)sweeps a pass
  StepTiles tiles;  // halo levels
};

using BlockedDiffuse = BlockedSolve<float, kStepFields>;

// Field f of d by selects over constant indices: a runtime index into the
// parameter array would copy it to local memory.
template <typename T, int F>
__device__ __forceinline__ SolveField<T> field_of(const BlockedSolve<T, F>& d,
                                                  int f) {
  SolveField<T> r = d.f[0];
#pragma unroll
  for (int i = 1; i < F; ++i)
    if (f == i) r = d.f[i];
  return r;
}

// Every field of d solved by ``iters`` Jacobi sweeps, or red-black
// iterations of two half-sweeps (RB), in ceil(sweeps / levels) passes
// with a grid-wide barrier after each; the blocks take the (field, tile)
// pairs in turn.  Pass i reads the guess (i = 0) or the buffer pass i - 1
// wrote, and writes out or tmp so that the last lands in out.  Jacobi
// writes every owned cell with its ghosts each pass, and level 0 of every
// pass reads the stored neighbours (the guess's ghosts, or the ones the
// pass before stored); red-black reads stored neighbours on the solve's
// first half-sweep only, writes the tile's interior until the last pass,
// and every owned cell with its ghosts then.  A block that keeps one pair
// for every pass keeps its x0 too.  ``smem`` holds three boxes (two for
// red-black).  The whole step's diffusions (LONE false) take x0 from the
// field itself and end with a barrier; a lone solve (the whole solve)
// reads its own x0, takes a NULL guess for zeros, and has no barrier
// after its last pass: compile-time choices, so that the step's code is
// the diffusion's alone.
template <typename T, bool RB, bool LONE, int F>
__device__ __forceinline__ void blocked_solve(cg::grid_group& grid,
                                              const BlockedSolve<T, F>& d,
                                              T* smem, int n) {
  const int N = n + 2;
  const int total = RB ? 2 * d.iters : d.iters;
  const int passes = (total + d.levels - 1) / d.levels;
  const bool resident = d.fields * d.tiles.count <= (int)gridDim.x;
  for (int pass = 0; pass < passes; ++pass) {
    const bool last = pass == passes - 1;
    const int h0 = pass * d.levels, H = min(d.levels, total - h0);
    for (int item = blockIdx.x; item < d.fields * d.tiles.count;
         item += gridDim.x) {
      const SolveField<T> f = field_of(d, item / d.tiles.count);
      const Box b = box_of(d.tiles, item % d.tiles.count, n);
      const int vol = b.cells();
      T* X0 = smem;
      T* cur = smem + vol;
      T* nxt = cur + vol;
      const T* src =
          pass == 0 ? f.x : ((passes - pass) & 1 ? f.tmp : f.out);
      T* dst = (passes - 1 - pass) & 1 ? f.tmp : f.out;
      // x0 over the same cells as the field (more than the levels read),
      // in the same loop
      const bool x0 = pass == 0 || !resident;
      const T* x0_src = LONE ? f.x0 : f.x;
      const Region r = widen(b, H, 0, n + 1);
      if (LONE && !src) {
        zero_box(cur, b);
        load_region<T>(X0, x0_src, nullptr, nullptr, b, r, N);
      } else {
        load_region(cur, src, x0 ? X0 : nullptr, x0 ? x0_src : nullptr, b,
                    r, N);
      }
      __syncthreads();
      const Signs sg = signs_for(f.b);
      for (int h = 0; h < H; ++h) {
        const Region lr = widen(b, H - 1 - h, 1, n);
        if (RB) {
          rb_level(cur, X0, b, lr, n, (h0 + h) & 1, h0 + h == 0, sg, f.a,
                   f.c_inv);
        } else {
          jacobi_level(cur, nxt, X0, b, lr, n, h == 0, sg, f.a, f.c_inv);
          T* t = cur;
          cur = nxt;
          nxt = t;
        }
        __syncthreads();
      }
      if (RB && !last)
        store_tile(cur, b, dst, N);
      else
        store_owned(cur, b, dst, n, f.b);
      __syncthreads();
    }
    if (!LONE || !last) grid.sync();
  }
}

}  // namespace tf
