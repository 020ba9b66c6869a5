// Shared indexing for the grid kernels of tpufluids_torch.
//
// Every field is a dense (n+2)^3 float32 array, C order, z contiguous,
// with one ghost layer per face.  The kernels run one thread per output
// cell, ghost cells included, and every output cell is written by
// exactly one thread (no atomics, no shared memory), so results are
// deterministic.
//
// A ghost cell never needs a second pass: stam.set_bnd3d writes the x
// faces, then the y faces, then the z faces, each face as a full plane,
// so the value it leaves in a ghost cell is the value at the clamped
// interior index times the sign of each out-of-range axis (-1 on axis a
// iff b == a + 1).  A thread that owns a ghost cell computes the
// interior value at the clamped index and applies that sign.
#pragma once

#include <cuda_runtime.h>

namespace tf {

constexpr int kThreads = 256;

struct Cell {
  int i, j, k;   // the output cell
  int c;         // flat index of the clamped interior cell
  float sign[4]; // set_bnd sign of the output cell for b = 0..3
};

__device__ __forceinline__ int clamp_interior(int i, int n) {
  return i < 1 ? 1 : (i > n ? n : i);
}

// Fills ``cell`` for output cell (i, j, k).
__device__ __forceinline__ void cell_from(int i, int j, int k, int n,
                                          Cell& cell) {
  const int N = n + 2;
  cell.i = i;
  cell.j = j;
  cell.k = k;
  const int ci = clamp_interior(cell.i, n);
  const int cj = clamp_interior(cell.j, n);
  const int ck = clamp_interior(cell.k, n);
  cell.c = (ci * N + cj) * N + ck;
  cell.sign[0] = 1.0f;
  cell.sign[1] = ci != cell.i ? -1.0f : 1.0f;
  cell.sign[2] = cj != cell.j ? -1.0f : 1.0f;
  cell.sign[3] = ck != cell.k ? -1.0f : 1.0f;
}

// Decodes the flat output index; false past the end of the grid.
__device__ __forceinline__ bool cell_at(int idx, int n, Cell& cell) {
  const int N = n + 2;
  if (idx >= N * N * N) return false;
  cell_from(idx / (N * N), (idx / N) % N, idx % N, n, cell);
  return true;
}

// The flat index of the output cell.
__device__ __forceinline__ int out_index(const Cell& cell, int n) {
  const int N = n + 2;
  return (cell.i * N + cell.j) * N + cell.k;
}

__device__ __forceinline__ bool is_interior(const Cell& cell, int N) {
  return cell.c == (cell.i * N + cell.j) * N + cell.k;
}

inline unsigned blocks_for(int n) {
  const long long total = (long long)(n + 2) * (n + 2) * (n + 2);
  return (unsigned)((total + kThreads - 1) / kThreads);
}

inline int launch_status() { return (int)cudaGetLastError(); }

}  // namespace tf
