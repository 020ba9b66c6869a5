// Shared indexing for the grid kernels of tpufluids_torch.
//
// Every field is a dense (n+2)^3 float32 array, C order, z contiguous,
// with one ghost layer per face.  Every output cell is written by
// exactly one thread (no atomics), so results are deterministic: one
// thread per output cell, ghosts included, or, in the x-march of the
// advection and the forcing (stencil_march.cuh), the thread that
// computes the cell's clamped cell.
//
// A ghost cell never needs a second pass: stam.set_bnd3d writes the x
// faces, then the y faces, then the z faces, each face as a full plane,
// so the value it leaves in a ghost cell is the value at the clamped
// interior index times the sign of each out-of-range axis (-1 on axis a
// iff b == a + 1).  A thread that owns a ghost cell computes the
// interior value at the clamped index and applies that sign.
//
// Slabs.  The stencil kernels also take an x-slab of the sharded step: a
// (rows, n+2, n+2) field whose local row r is global row gx0 + r of the
// (n+2)^3 grid (Place).  x clamps and x ghosts then follow global rows:
// a cell at global row 0 or n + 1, or outside the grid, takes the value
// at its clamped global row.  A cell whose clamped row lacks a neighbour
// row in the slab (the slab's first or last row, unless the clamp moves
// it inward) has no stencil and is written as 0.  A cubic field is the
// slab {n + 2, 0}, where every cell has its stencil.
#pragma once

#include <cuda_runtime.h>

namespace tf {

constexpr int kThreads = 256;

// The signs are three floats picked by b, not an array indexed by it: a
// runtime index puts the whole Cell in local memory, a stack frame in
// every kernel that picks a sign by a runtime b (the Jacobi sweeps, the
// ghost pass, advection, the whole tier).
struct Cell {
  int i, j, k;       // the output cell (i the local row)
  int c;             // flat index of the clamped interior cell
  int gi;            // the global row of the clamped cell
  bool ok;           // the clamped cell's x neighbours lie in the field
  float sx, sy, sz;  // -1 on an axis where the output cell is clamped

  // set_bnd sign of the output cell for b = 0..3
  __device__ __forceinline__ float sign(int b) const {
    return b == 1 ? sx : (b == 2 ? sy : (b == 3 ? sz : 1.0f));
  }
};

// The x placement of a field: ``rows`` local rows, local row 0 at global
// row ``gx0``.
struct Place {
  int rows, gx0;
};

__host__ __device__ inline Place cubic(int n) { return {n + 2, 0}; }

__device__ __forceinline__ int clamp_interior(int i, int n) {
  return i < 1 ? 1 : (i > n ? n : i);
}

// Fills ``cell`` for output cell (i, j, k), i a local row of ``pl``.
__device__ __forceinline__ void cell_from(int i, int j, int k, int n,
                                          Place pl, Cell& cell) {
  const int N = n + 2;
  cell.i = i;
  cell.j = j;
  cell.k = k;
  const int g = pl.gx0 + i;
  cell.gi = clamp_interior(g, n);
  const int ci = cell.gi - pl.gx0;
  const int cj = clamp_interior(cell.j, n);
  const int ck = clamp_interior(cell.k, n);
  cell.ok = ci >= 1 && ci <= pl.rows - 2;
  cell.c = (ci * N + cj) * N + ck;
  cell.sx = cell.gi != g ? -1.0f : 1.0f;
  cell.sy = cj != cell.j ? -1.0f : 1.0f;
  cell.sz = ck != cell.k ? -1.0f : 1.0f;
}

__device__ __forceinline__ void cell_from(int i, int j, int k, int n,
                                          Cell& cell) {
  cell_from(i, j, k, n, cubic(n), cell);
}

// Decodes the flat output index; false past the end of the field.
__device__ __forceinline__ bool cell_at(int idx, int n, Place pl,
                                        Cell& cell) {
  const int N = n + 2;
  if (idx >= pl.rows * N * N) return false;
  cell_from(idx / (N * N), (idx / N) % N, idx % N, n, pl, cell);
  return true;
}

__device__ __forceinline__ bool cell_at(int idx, int n, Cell& cell) {
  return cell_at(idx, n, cubic(n), cell);
}

// The flat index of the output cell.
__device__ __forceinline__ int out_index(const Cell& cell, int n) {
  const int N = n + 2;
  return (cell.i * N + cell.j) * N + cell.k;
}

__device__ __forceinline__ bool is_interior(const Cell& cell, int N) {
  return cell.c == (cell.i * N + cell.j) * N + cell.k;
}

inline unsigned blocks_for(int n, Place pl) {
  const long long total = (long long)pl.rows * (n + 2) * (n + 2);
  return (unsigned)((total + kThreads - 1) / kThreads);
}

inline unsigned blocks_for(int n) { return blocks_for(n, cubic(n)); }

inline int launch_status() { return (int)cudaGetLastError(); }

}  // namespace tf
