// The x-march shared by the streamed advection (advect.cu) and forcing
// (forcing.cu) kernels: how a block's cells, rows and outputs are laid
// out.  kernels.march_plan and the torch emulations of grid/kernels.py
// (advect3d_march, forcing3d_march) follow it.
//
// A block owns a (y, z) tile of TY x TZ interior cells (the tiles cover
// [1, n]^2; the last ones in each axis may be cut by the array) and a
// segment of ``seg`` centre rows, and marches along x through a ring of
// x-planes of its inputs in shared memory, each the tile widened by its
// stencil's halo and clipped to the array.  A centre row is a local row
// whose cells have a stencil (grid_common.cuh): its global row is
// interior and both x neighbours lie in the field.  They are the rows
// c_lo .. c_hi; the segments cut them from c_lo up.
//
// Every output cell is written by one thread: the thread that computes
// its clamped cell (grid_common.cuh), once for each output cell that
// clamps to it, times that cell's set_bnd sign (for_outputs).  So the y
// and z ghosts come from the tiles at the faces, and the x ghost rows (or
// a slab's rows past the grid) from the segment holding row 1 or n.  The
// rows without a stencil, a slab's outer rows, are written as 0 by the
// first and the last segment (zero_rows).
#pragma once

#include "grid_common.cuh"

namespace tf {

struct March {
  int c_lo, c_hi;   // the centre rows (c_lo > c_hi: none)
  int seg;          // centre rows a block
  int tiles_z;      // tiles along z
  int tiles;        // (y, z) tiles
  int blocks;       // tiles x segments
};

__host__ inline March march_of(int n, Place pl, int ty, int tz, int seg) {
  March m;
  m.c_lo = 1 - pl.gx0 > 1 ? 1 - pl.gx0 : 1;
  m.c_hi = n - pl.gx0 < pl.rows - 2 ? n - pl.gx0 : pl.rows - 2;
  m.seg = seg;
  m.tiles_z = (n + tz - 1) / tz;
  m.tiles = m.tiles_z * ((n + ty - 1) / ty);
  const int rows = m.c_hi - m.c_lo + 1;
  m.blocks = m.tiles * (rows > seg ? (rows + seg - 1) / seg : 1);
  return m;
}

// The part of the march a block runs: its tile's first interior cell
// (y0, z0) and last (y1, z1), and its centre rows s0 .. s1 (none when
// s0 > s1); ``first`` and ``last``: the first and the last segment.
struct BlockPart {
  int y0, z0, y1, z1, s0, s1;
  bool first, last;
};

template <int TY, int TZ>
__device__ __forceinline__ BlockPart block_part(const March& m, int n) {
  const int tile = blockIdx.x % m.tiles, s = blockIdx.x / m.tiles;
  BlockPart b;
  b.y0 = 1 + (tile / m.tiles_z) * TY;
  b.z0 = 1 + (tile % m.tiles_z) * TZ;
  b.y1 = min(b.y0 + TY - 1, n);
  b.z1 = min(b.z0 + TZ - 1, n);
  b.s0 = m.c_lo + s * m.seg;
  b.s1 = min(b.s0 + m.seg - 1, m.c_hi);
  b.first = s == 0;
  b.last = b.s1 >= m.c_hi;
  return b;
}

// The output rows that clamp to centre row c: c itself, and past the
// grid's face at global row 1 or n every row up to the slab's end.
__device__ __forceinline__ int rows_lo(int c, Place pl) {
  return pl.gx0 + c == 1 ? 0 : c;
}
__device__ __forceinline__ int rows_hi(int c, int n, Place pl) {
  return pl.gx0 + c == n ? pl.rows - 1 : c;
}

// The set_bnd sign of b for an output cell with the axis signs sx, sy, sz
// (as Cell::sign).
__device__ __forceinline__ float sign_of(int b, float sx, float sy,
                                         float sz) {
  return b == 1 ? sx : (b == 2 ? sy : (b == 3 ? sz : 1.0f));
}

// Calls put(o, sx, sy, sz) for each output cell o that clamps to interior
// cell (c, cj, ck), c a centre row, with its axis signs.
template <class Put>
__device__ __forceinline__ void for_outputs(int c, int cj, int ck, int n,
                                            Place pl, const Put& put) {
  const int N = n + 2;
  const int i_lo = rows_lo(c, pl), i_hi = rows_hi(c, n, pl);
  const int j_lo = cj == 1 ? 0 : cj, j_hi = cj == n ? N - 1 : cj;
  const int k_lo = ck == 1 ? 0 : ck, k_hi = ck == n ? N - 1 : ck;
  if (i_lo == i_hi && j_lo == j_hi && k_lo == k_hi) {
    put((c * N + cj) * N + ck, 1.0f, 1.0f, 1.0f);
    return;
  }
  for (int i = i_lo; i <= i_hi; ++i)
    for (int j = j_lo; j <= j_hi; ++j)
      for (int k = k_lo; k <= k_hi; ++k)
        put((i * N + j) * N + k, i != c ? -1.0f : 1.0f,
            j != cj ? -1.0f : 1.0f, k != ck ? -1.0f : 1.0f);
}

// Calls zero(o) for every output cell of the block's tile (its interior
// cells and the ghosts beside them) in the rows without a stencil: those
// below the first centre row (the first segment) and above the last (the
// last segment); with no centre row, every row.
template <int NT, class Zero>
__device__ __forceinline__ void zero_rows(const March& m, int n, Place pl,
                                          const BlockPart& b,
                                          const Zero& zero) {
  const int N = n + 2;
  const bool any = m.c_lo <= m.c_hi;
  const int below = b.first ? (any ? rows_lo(m.c_lo, pl) : pl.rows) : 0;
  const int above =
      b.last && any ? rows_hi(m.c_hi, n, pl) + 1 : pl.rows;
  const int j_lo = b.y0 == 1 ? 0 : b.y0, j_hi = b.y1 == n ? N - 1 : b.y1;
  const int k_lo = b.z0 == 1 ? 0 : b.z0, k_hi = b.z1 == n ? N - 1 : b.z1;
  const int KZ = k_hi - k_lo + 1, cells = (j_hi - j_lo + 1) * KZ;
  for (int r = 0; r < pl.rows; ++r) {
    if (r == below) r = above;
    if (r >= pl.rows) break;
    for (int t = threadIdx.x; t < cells; t += NT)
      zero((r * N + j_lo + t / KZ) * N + k_lo + t % KZ);
  }
}

// A 4-byte copy from device memory into shared memory, in flight until
// cp_async_wait (cp.async; no register holds the value).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most ``pending`` of this thread's last committed groups
// are in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
}

// Slot of plane p (p >= -1) in a ring of R planes.
template <int R>
__device__ __forceinline__ int slot_of(int p) {
  return (p + R) % R;
}

}  // namespace tf
