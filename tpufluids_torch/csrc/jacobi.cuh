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
// The whole tier runs a whole solve, or more, in one cooperative launch
// with a grid-wide barrier between sweeps and phases.  66^3 cells (64^3)
// are more than the card keeps resident, so the threads stride over the
// cells, and the grid is sized by the occupancy query.  Inside a
// cooperative kernel no pointer is __restrict__: fields written in one
// phase are read in the next, and must not come through the non-coherent
// read-only path.
#pragma once

#include <cooperative_groups.h>

#include "divgrad.cuh"

namespace tf {

namespace cg = cooperative_groups;

// The Jacobi update of interior cell c from src (NULL: zeros).
__device__ __forceinline__ float jacobi_at(const float* src, const float* x0,
                                           int c, int N, float a,
                                           float c_inv) {
  float nb = 0.0f;
  if (src) {
    nb = src[c - N * N] + src[c + N * N];
    nb = nb + src[c - N];
    nb = nb + src[c + N];
    nb = nb + src[c - 1];
    nb = nb + src[c + 1];
  }
  return (x0[c] + a * nb) * c_inv;
}

// One output cell of a Jacobi sweep followed by set_bnd3d(b).
__device__ __forceinline__ void jacobi_cell(int idx, const float* src,
                                            const float* x0, float* dst,
                                            int n, int b, float a,
                                            float c_inv) {
  Cell cell;
  if (!cell_at(idx, n, cell)) return;
  dst[out_index(cell, n)] =
      cell.sign[b] * jacobi_at(src, x0, cell.c, n + 2, a, c_inv);
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
__device__ __forceinline__ void rb_cell(int t, const float* src,
                                        const float* x0, float* dst, int n,
                                        int p, bool first, float sx,
                                        float sy, float sz, float a,
                                        float c_inv) {
  const int half = (n + 1) / 2;
  if (t >= n * n * half) return;
  const int I = 1 + t / (n * half);
  const int J = 1 + (t / half) % n;
  const int q = t % half;
  const int odd = (p + I + J) & 1;
  const int N = n + 2;
  const int row = (I * N + J) * N;
  const int Ki = 2 * q + 2 - odd;
  if (first && Ki <= n) dst[row + Ki] = src ? src[row + Ki] : 0.0f;
  const int K = 2 * q + 1 + odd;
  if (K > n) return;
  const int c = row + K;
  if (first) {
    dst[c] = jacobi_at(src, x0, c, N, a, c_inv);
    return;
  }
  const float own = src[c];
  float nb = (I == 1 ? sx * own : src[c - N * N])
             + (I == n ? sx * own : src[c + N * N]);
  nb = nb + (J == 1 ? sy * own : src[c - N]);
  nb = nb + (J == n ? sy * own : src[c + N]);
  nb = nb + (K == 1 ? sz * own : src[c - 1]);
  nb = nb + (K == n ? sz * own : src[c + 1]);
  dst[c] = (x0[c] + a * nb) * c_inv;
}

// Ghost cells: the x faces (2 N^2 cells), then the y faces without the x
// ghosts (2 n N), then the z faces without either (2 n^2): N^3 - n^3.
__device__ __forceinline__ int ghost_threads(int n) {
  const int N = n + 2;
  return 2 * N * N + 2 * n * N + 2 * n * n;
}

// Ghost cell t of x set to the value set_bnd3d(b) gives it.
__device__ __forceinline__ void ghost_cell(int t, float* x, int n, int b) {
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
  x[out_index(cell, n)] = cell.sign[b] * x[cell.c];
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
__host__ __device__ inline float* sweep_dst(int s, int iters, float* out,
                                            float* tmp) {
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

constexpr int kMaxFields = 3;

struct DiffuseArgs {
  const float* in[kMaxFields];
  float* out[kMaxFields];
  float* tmp[kMaxFields];
  int b[kMaxFields];
  float a[kMaxFields];
  float c_inv[kMaxFields];
  int n, iters;
};

// K independent diffusions, x0 = the input field, every sweep of each,
// with a barrier after each sweep.  K is a template argument so that the
// field loop unrolls and the per-field arguments stay out of local memory
// (a runtime index would copy them to the stack).
template <int K>
__device__ __forceinline__ void diffuse_phase(cg::grid_group& grid,
                                              const GridLoop& loop,
                                              const DiffuseArgs& d) {
  const int cells = (d.n + 2) * (d.n + 2) * (d.n + 2);
  for (int s = 0; s < d.iters; ++s) {
#pragma unroll
    for (int f = 0; f < K; ++f) {
      const float* src =
          s == 0 ? d.in[f] : sweep_dst(s - 1, d.iters, d.out[f], d.tmp[f]);
      float* dst = sweep_dst(s, d.iters, d.out[f], d.tmp[f]);
      for (int idx = loop.start; idx < cells; idx += loop.stride)
        jacobi_cell(idx, src, d.in[f], dst, d.n, d.b[f], d.a[f],
                    d.c_inv[f]);
    }
    grid.sync();
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
  if (g.red_black) {
    const int active = rb_threads(n);
    for (int it = 0; it < g.iters; ++it) {
      for (int par = 0; par < 2; ++par) {
        const bool first = it == 0 && par == 0;
        for (int t = loop.start; t < active; t += loop.stride)
          rb_cell(t, first ? nullptr : g.p, g.div, g.p, n, par, first, 1.0f,
                  1.0f, 1.0f, 1.0f, g.c_inv);
        grid.sync();
      }
    }
    const int ghosts = ghost_threads(n);
    for (int t = loop.start; t < ghosts; t += loop.stride)
      ghost_cell(t, g.p, n, 0);
  } else {
    for (int s = 0; s < g.iters; ++s) {
      const float* src = s == 0 ? nullptr : sweep_dst(s - 1, g.iters, g.p,
                                                      g.p2);
      float* dst = sweep_dst(s, g.iters, g.p, g.p2);
      for (int idx = loop.start; idx < cells; idx += loop.stride)
        jacobi_cell(idx, src, g.div, dst, n, 0, 1.0f, g.c_inv);
      if (s + 1 < g.iters) grid.sync();
    }
  }
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
