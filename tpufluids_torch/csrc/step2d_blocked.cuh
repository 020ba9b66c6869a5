// The blocked Jacobi passes of the 2D kernels: the whole 2D step's
// diffusions (step2d.cu) and the whole 2D solve (grid2d.cu), and the
// tiles, boxes, levels and stores of the step's projection.
//
// Tiles and boxes.  A phase cuts the interior into tiles of tx x ty
// cells (the host chooses them: kernels.step2d_plan, solve2d_plan); a
// block's box is its tile widened by ``halo`` cells, clipped to the
// (n+2)^2 array, held in shared memory with y contiguous.  A pass loads
// the box from the buffer the previous pass wrote, runs H levels in it,
// a block barrier between levels, level h updating the tile widened by
// H-1-h, and writes its tile; the next pass starts after a grid-wide
// barrier.
//
// Ghosts (the rules of step_blocked.cuh, with set_bnd2d's corners).  A
// tap across a face of the grid is the cell's own value times the face's
// set_bnd2d sign, which is what the ghost holds after a sweep, except on
// level 0 of a pass, which reads the stored neighbours: the guess's own
// ghosts on the first pass (which need not be sign x interior: a raw
// guess, or a field after its sources are added; zeros for a zero
// guess), those the previous pass wrote on a later one.  A pass that
// writes a field's ghosts writes every output cell whose clamped cell
// lies in its tile, corners included: sx or sy times the clamped cell's
// value on an edge, and 0.5 (sy c + sx c) at a corner, c the diagonal
// interior cell (stam.set_bnd2d's corner average).
//
// Per cell the arithmetic is the plain version's, operation by operation
// with one rounding each (-fmad=false): the neighbour sum x-1, x+1, then
// y-1, then y+1, then (x0 + a nb) c_inv.  So a solve equals
// stam.lin_solve2d bit for bit (tests/test_torch_step2d_blocked.py and
// tests/test_torch_solve_blocked.py emulate the passes tile by tile).
// No pointer is __restrict__: a pass reads what the pass before wrote.
#pragma once

#include <cooperative_groups.h>

#include "grid2d.cuh"
#include "grid_common.cuh"

namespace tf2d {

namespace cg = cooperative_groups;

using tf::bnd;
using tf::bnd_for;
using tf::Bnd;

// ---------------------------------------------------------------------------
// tiles and boxes

// The tiles of a blocked phase: tx x ty interior cells, cy tiles a row
// of x, ``count`` in all, in C order; a box is a tile widened by
// ``halo``.
struct Tiles {
  int tx, ty, halo;
  int cy, count;
};

// One block's box: its tile, interior cells [x0, x1] x [y0, y1], and the
// box, nx x ny cells from array cell (bx, by), y contiguous.
struct Box {
  int x0, x1, y0, y1;
  int bx, by, nx, ny;
  __device__ __forceinline__ int at(int i, int j) const {
    return (i - bx) * ny + (j - by);
  }
  __device__ __forceinline__ int cells() const { return nx * ny; }
};

__device__ __forceinline__ Box box_of(const Tiles& t, int tile, int n) {
  Box b;
  const int iy = tile % t.cy, ix = tile / t.cy;
  b.x0 = 1 + ix * t.tx;
  b.y0 = 1 + iy * t.ty;
  b.x1 = min(b.x0 + t.tx - 1, n);
  b.y1 = min(b.y0 + t.ty - 1, n);
  b.bx = max(b.x0 - t.halo, 0);
  b.by = max(b.y0 - t.halo, 0);
  b.nx = min(b.x1 + t.halo, n + 1) - b.bx + 1;
  b.ny = min(b.y1 + t.halo, n + 1) - b.by + 1;
  return b;
}

// Cells [i0, i0 + ni) x [j0, j0 + nj).
struct Region {
  int i0, j0, ni, nj;
};

// The tile widened by e, clipped to [lo, hi] on both axes.
__device__ __forceinline__ Region widen(const Box& b, int e, int lo,
                                        int hi) {
  Region r;
  r.i0 = max(b.x0 - e, lo);
  r.j0 = max(b.y0 - e, lo);
  r.ni = min(b.x1 + e, hi) - r.i0 + 1;
  r.nj = min(b.y1 + e, hi) - r.j0 + 1;
  return r;
}

// The output cells whose clamped interior cell lies in the tile: the
// tile, and the ghosts beside it where it touches a face of the grid.
__device__ __forceinline__ Region owned(const Box& b, int n) {
  Region r;
  r.i0 = b.x0 == 1 ? 0 : b.x0;
  r.j0 = b.y0 == 1 ? 0 : b.y0;
  r.ni = (b.x1 == n ? n + 1 : b.x1) - r.i0 + 1;
  r.nj = (b.y1 == n ? n + 1 : b.y1) - r.j0 + 1;
  return r;
}

// How the threads of a block walk a region: each takes a run of rows
// along x of one column j, the columns cut into ``seg`` runs so that
// about every thread has one; a warp's threads hold neighbouring j, so
// their shared and device accesses are consecutive words.  A cell costs
// no index arithmetic beyond a step along the run.
struct Runs {
  int nj, seg, len;
  __device__ __forceinline__ explicit Runs(const Region& r) {
    nj = r.nj;
    seg = min(r.ni, max(1, (int)blockDim.x / nj));
    len = (r.ni + seg - 1) / seg;
  }
  __device__ __forceinline__ int count() const { return nj * seg; }
  // run t: column j, rows [i, i_end)
  __device__ __forceinline__ void at(const Region& r, int t, int& i,
                                     int& i_end, int& j) const {
    j = r.j0 + t % nj;
    i = r.i0 + (t / nj) * len;
    i_end = min(i + len, r.i0 + r.ni);
  }
};

// Box cells of region r from device memory: S0 from g0, and S1 from g1
// unless g1 is NULL; four rows of a run at a time, their loads in flight
// together.  The fields were written before the last grid barrier: loads
// through L2 (__ldcg), not the read-only path.
__device__ __forceinline__ void load_region(float* S0, const float* g0,
                                            float* S1, const float* g1,
                                            const Box& b, const Region& r,
                                            int N) {
  constexpr int kRows = 4;
  const Runs R(r);
  for (int t = threadIdx.x; t < R.count(); t += blockDim.x) {
    int i, ie, j;
    R.at(r, t, i, ie, j);
    int s = b.at(i, j), c = i * N + j;
    for (; i < ie; i += kRows, s += kRows * b.ny, c += kRows * N) {
      float v[kRows], w[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        if (i + q < ie) {
          v[q] = __ldcg(g0 + c + q * N);
          if (g1) w[q] = __ldcg(g1 + c + q * N);
        }
      }
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        if (i + q < ie) {
          S0[s + q * b.ny] = v[q];
          if (g1) S1[s + q * b.ny] = w[q];
        }
      }
    }
  }
}

// A Jacobi sweep over the interior cells of region r, from S into D:
// (x0 + a nb) c_inv, nb the neighbours x-1, x+1, y-1, y+1 summed in that
// order.  A run carries the cell and the one below it to the next row.
// ``first``: read the stored neighbours; else a tap across a face of the
// grid is the cell's own value times the face's sign.
__device__ __forceinline__ void jacobi_level(const float* S, float* D,
                                             const float* X0, const Box& b,
                                             const Region& r, int n,
                                             bool first, Bnd sg, float a,
                                             float c_inv) {
  const Runs R(r);
  const int sx = b.ny;
  for (int t = threadIdx.x; t < R.count(); t += blockDim.x) {
    int i, ie, j;
    R.at(r, t, i, ie, j);
    if (i >= ie) continue;
    const bool y_face = !first && (j == 1 || j == n);
    int s = b.at(i, j);
    float xm = S[s - sx], own = S[s];
    for (; i < ie; ++i, s += sx) {
      const float xp = S[s + sx];
      float ym = S[s - 1], yp = S[s + 1];
      float tm = xm, tp = xp;
      if (!first) {
        tm = i == 1 ? sg.sx * own : tm;
        tp = i == n ? sg.sx * own : tp;
      }
      if (y_face) {
        ym = j == 1 ? sg.sy * own : ym;
        yp = j == n ? sg.sy * own : yp;
      }
      float nb = tm + tp;
      nb = nb + ym;
      nb = nb + yp;
      D[s] = (X0[s] + a * nb) * c_inv;
      xm = own;
      own = xp;
    }
  }
}

// The tile's interior cells of S to dst.
__device__ __forceinline__ void store_tile(const float* S, const Box& b,
                                           float* dst, int n) {
  const Region r = widen(b, 0, 1, n);
  const Runs R(r);
  const int N = n + 2;
  for (int t = threadIdx.x; t < R.count(); t += blockDim.x) {
    int i, ie, j;
    R.at(r, t, i, ie, j);
    int s = b.at(i, j), c = i * N + j;
    for (; i < ie; ++i, s += b.ny, c += N) dst[c] = S[s];
  }
}

// The owned output cells to dst, each set_bnd2d(sg)'s value from its
// clamped cell in S.
__device__ __forceinline__ void store_owned(const float* S, const Box& b,
                                            float* dst, int n, Bnd sg) {
  const Region r = owned(b, n);
  const Runs R(r);
  const int N = n + 2;
  for (int t = threadIdx.x; t < R.count(); t += blockDim.x) {
    int i, ie, j;
    R.at(r, t, i, ie, j);
    const int cj = tf::clamp_interior(j, n);
    for (; i < ie; ++i) {
      const int ci = tf::clamp_interior(i, n);
      dst[i * N + j] = bnd(ci != i, cj != j, sg, S[b.at(ci, cj)]);
    }
  }
}

__device__ __forceinline__ void zero_box(float* S, const Box& b) {
  for (int t = threadIdx.x; t < b.cells(); t += blockDim.x) S[t] = 0.0f;
}

// ---------------------------------------------------------------------------
// the diffusions and the whole solve

constexpr int kFields = 4;

struct SolveField {
  const float* x;   // the initial guess, read by the first pass; NULL: zeros
  const float* x0;
  float *out, *tmp;  // the last pass lands in out; tmp alternates with it
  int b;
  float a, c_inv;
};

struct BlockedSolve {
  SolveField f[kFields];
  int fields, iters;
  int levels;  // sweeps a pass
  Tiles tiles;  // halo levels
};

// Field f of d by selects over constant indices: a runtime index into the
// parameter array would copy it to local memory.
__device__ __forceinline__ SolveField field_of(const BlockedSolve& d, int f) {
  SolveField r = d.f[0];
#pragma unroll
  for (int i = 1; i < kFields; ++i)
    if (f == i) r = d.f[i];
  return r;
}

// Every field of d solved by ``iters`` Jacobi sweeps, in ceil(iters /
// levels) passes with a grid-wide barrier after each (after the last too
// when ``barrier_last``); the blocks take the (field, tile) pairs in
// turn.  Pass i reads the guess (i = 0; NULL: a zero box) or the buffer
// pass i - 1 wrote, level 0 with its stored ghosts, and writes out or tmp
// so that the last lands in out, each owned cell with its ghosts and
// corners.  A block that keeps one (field, tile) pair for every pass
// keeps its x0.  ``smem`` holds three boxes.
__device__ __forceinline__ void blocked_solve(cg::grid_group& grid,
                                              const BlockedSolve& d,
                                              float* smem, int n,
                                              bool barrier_last) {
  const int N = n + 2;
  const int passes = (d.iters + d.levels - 1) / d.levels;
  const int items = d.fields * d.tiles.count;
  const bool resident = items <= (int)gridDim.x;
  for (int pass = 0; pass < passes; ++pass) {
    const int H = min(d.levels, d.iters - pass * d.levels);
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const SolveField f = field_of(d, item / d.tiles.count);
      const Box b = box_of(d.tiles, item % d.tiles.count, n);
      const int vol = b.cells();
      float* X0 = smem;
      float* cur = smem + vol;
      float* nxt = cur + vol;
      const float* src =
          pass == 0 ? f.x : ((passes - pass) & 1 ? f.tmp : f.out);
      float* dst = (passes - 1 - pass) & 1 ? f.tmp : f.out;
      // x0 over the same cells as the field, in the same loop
      const bool x0 = pass == 0 || !resident;
      const Region r = widen(b, H, 0, n + 1);
      if (src) {
        load_region(cur, src, x0 ? X0 : nullptr, x0 ? f.x0 : nullptr, b, r,
                    N);
      } else {
        zero_box(cur, b);
        load_region(X0, f.x0, nullptr, nullptr, b, r, N);
      }
      __syncthreads();
      const Bnd sg = bnd_for(f.b);
      for (int h = 0; h < H; ++h) {
        jacobi_level(cur, nxt, X0, b, widen(b, H - 1 - h, 1, n), n, h == 0,
                     sg, f.a, f.c_inv);
        float* t = cur;
        cur = nxt;
        nxt = t;
        __syncthreads();
      }
      store_owned(cur, b, dst, n, sg);
      __syncthreads();
    }
    if (pass + 1 < passes || barrier_last) grid.sync();
  }
}

// The tiles of an n^2 interior cut into tx x ty tiles, boxes widened by
// ``halo`` (kernels.Step2dTile).
inline Tiles tiles_of(int n, int tx, int ty, int halo) {
  const int cx = (n + tx - 1) / tx, cy = (n + ty - 1) / ty;
  return Tiles{tx, ty, halo, cy, cx * cy};
}

}  // namespace tf2d
