// Pair-force pass of the base SPH variant: per home particle, the
// density sum sum_w and the pressure-gradient sum dpress over its
// 27-cell stencil (FluidGPU.cu:224-281), as two kernels that share one
// pair loop:
//
// * tf_sph_base_forces replaces base_forces_rowblock /
//   _base_rowblock_kernel (tpufluids/sph_pallas.py): the exact stencil,
//   with no capacity cap.
// * tf_sph_base_column replaces base_forces_pallas / _sph_kernel
//   (tpufluids/sph_pallas.py): the same pairs, capped as the column
//   family caps them.  A row at rank b or more in its (x, y) column gets
//   zeros, and only the first w_cap rows of each neighbour column are
//   candidates.  The TPU kernel's home and window tiles, DMA double
//   buffer, home chunks, z-skip and banded sweep are VMEM plumbing that
//   leave its results bitwise unchanged; none of it is carried over.
//
// Both take a stale mode, for the steps between two sorts of the sort
// cadence (sort_every > 1): the tables come from an earlier step's
// positions, so a row walks the whole (capped) neighbour columns of its
// stale column and keeps a candidate only if their current truncated
// cells differ by at most one on x, y and z (the column family's
// xy_cells masks, per row; ROADMAP Queue 3 states how the TPU row-block
// kernel's stale pair set differs).  Fresh, the candidates are cells
// z-1..z+1 of each neighbour column, from cell_start, with no per-pair
// cell test: the sorted ids are the current truncated cells.
//
// One thread owns one cell-sorted row and walks its candidates straight
// from device memory, in the 9 (dx, dy) columns of binning.RUN_OFFSETS,
// j ascending.  Consecutive threads hold rows of the same or adjacent
// cells, so a warp reads largely the same candidate rows and those reads
// hit L1/L2; the 37e6 pairs of a 262144-particle uniform fill are a few
// GFLOP, so the kernels are bound by those candidate loads and by the
// latency of their serial loop.  The stale walk reads whole columns,
// about g / 3 times the fresh candidates, for the same pairs.
//
// Each thread writes its own output row at its pool index order[i]
// (a permutation), with no atomics, so results are bitwise identical
// from run to run, and the four loops (fresh or stale, capped or not)
// run one pair body in one order: uncapped and capped kernels agree bit
// for bit when no column overflows, and stale and fresh on a just-sorted
// pool.  Built with -fmad=false, with the operations per pair of the
// plain version (tpufluids_torch/forces.py, _chunk_sums).
#include <cuda_runtime.h>
#include <math.h>

#include "sph_common.cuh"

namespace {

constexpr int kThreads = 128;

struct PairConsts {
  float h, two_h;
  float w_norm;    // PI_REF h^3
  float spiky;     // -45 / (PI_REF h^6)
  float mu_eps;    // 0.01 h^2
  float visc_a;    // alpha_fluid * sound
  float visc_q;    // visc_quadratic / sound
  float alpha_b;   // alpha_boundary
  float bdens;     // bdensfactor
};

// Sums of sorted row i over its candidates; c is its (stale) cell id,
// below the sentinel, so row i is alive and in the domain.
// rows: n x 12 floats as 3 float4 per row: (x, y, z, vx),
// (vy, vz, dens, press), (boundary, alive, 0, 0); see forces.pack_rows.
template <bool kCapped, bool kStale>
__device__ float4 home_sums(const float4* __restrict__ rows,
                            const int* __restrict__ cell_start, int i, int c,
                            int g, const PairConsts& k,
                            const tf_sph::Walk& w) {
  const int cz = c % g, cy = (c / g) % g, cx = c / (g * g);
  if (kCapped && i - cell_start[c - cz] >= w.b)
    return make_float4(0.f, 0.f, 0.f, 0.f);
  const int zlo = cz > 0 ? cz - 1 : 0;
  const int zhi = cz < g - 1 ? cz + 1 : g - 1;
  const float4 ha = rows[3 * i], hb = rows[3 * i + 1], hc = rows[3 * i + 2];
  float ci[3];
  if (kStale) tf_sph::cells_now(ha, w, ci);
  const float di = hb.z, pi_term = hb.w / (hb.z * hb.z);
  const bool fluid_i = !(hc.x > 0.5f);
  float sw = 0.f, px = 0.f, py = 0.f, pz = 0.f;
  for (int dx = -1; dx <= 1; ++dx) {
    const int nx = cx + dx;
    if (nx < 0 || nx >= g) continue;
    for (int dy = -1; dy <= 1; ++dy) {
      const int ny = cy + dy;
      if (ny < 0 || ny >= g) continue;
      const int base = (nx * g + ny) * g;
      int j0 = cell_start[kStale ? base : base + zlo];
      int j1 = cell_start[kStale ? base + g : base + zhi + 1];
      if (kCapped) {
        const int end = cell_start[base] + w.w_cap;
        j0 = min(j0, end);
        j1 = min(j1, end);
      }
      for (int j = j0; j < j1; ++j) {
        const float4 ja = rows[3 * j], jb = rows[3 * j + 1];
        const float4 jc = rows[3 * j + 2];
        if (!(jc.y > 0.5f)) continue;
        if (kStale && !tf_sph::near_now(ci, ja, w)) continue;
        const float rx = ha.x - ja.x, ry = ha.y - ja.y, rz = ha.z - ja.z;
        const float ds = sqrtf(rx * rx + ry * ry + rz * rz);
        if (!(ds > 0.f && ds <= k.two_h)) continue;
        const float vx = ha.w - ja.w, vy = hb.x - jb.x, vz = hb.y - jb.y;

        const float wk = tf_sph::w_cubic(ds, k.h, k.w_norm);
        const float dkf = tf_sph::spiky_over_ds(ds, k.h, k.spiky);

        // inline Monaghan viscosity with its quadratic term (:255)
        const float dj = jb.z, pj = jb.w;
        const float nb = (fluid_i && jc.x > 0.5f) ? 1.f : 0.f;
        const float d = vx * rx + vy * ry + vz * rz;
        const float mu = k.h * (d / (ds * ds + k.mu_eps));
        const float rho_bar = (di + dj) / 2.f;
        const float s = k.visc_a * (mu + k.visc_q * mu * mu) / rho_bar
                        * (d < 0.f ? 1.f : 0.f) * (1.f + nb * k.alpha_b);
        const float p_term = pj / (dj * dj) + pi_term + s;

        sw += wk * (1.f + nb * k.bdens);
        px += p_term * (dkf * rx);
        py += p_term * (dkf * ry);
        pz += p_term * (dkf * rz);
      }
    }
  }
  return make_float4(sw, px, py, pz);
}

// One thread per sorted row; dead and out-of-domain rows carry the
// sentinel id num_cells, sort last and get zeros.
template <bool kCapped, bool kStale>
__global__ void base_forces_kernel(const float4* __restrict__ rows,
                                   const int* __restrict__ cid,
                                   const int* __restrict__ cell_start,
                                   const long long* __restrict__ order,
                                   float* __restrict__ sum_w,
                                   float* __restrict__ dpress, int n, int g,
                                   PairConsts k, tf_sph::Walk w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = cid[i];
  const float4 r =
      c < g * g * g
          ? home_sums<kCapped, kStale>(rows, cell_start, i, c, g, k, w)
          : make_float4(0.f, 0.f, 0.f, 0.f);
  const long long p = order[i];
  sum_w[p] = r.x;
  dpress[3 * p] = r.y;
  dpress[3 * p + 1] = r.z;
  dpress[3 * p + 2] = r.w;
}

template <bool kCapped, bool kStale>
int launch(const float* rows, const int* cid, const int* cell_start,
           const long long* order, float* sum_w, float* dpress, int n, int g,
           const PairConsts& k, const tf_sph::Walk& w, void* stream) {
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  base_forces_kernel<kCapped, kStale>
      <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          reinterpret_cast<const float4*>(rows), cid, cell_start, order,
          sum_w, dpress, n, g, k, w);
  return (int)cudaGetLastError();
}

}  // namespace

// stale != 0: the tables are an earlier step's (see above); xmin, ymin,
// zmin and cs give the current cells then.
extern "C" int tf_sph_base_forces(const float* rows, const int* cid,
                                  const int* cell_start,
                                  const long long* order, float* sum_w,
                                  float* dpress, int n, int g, int stale,
                                  float xmin, float ymin, float zmin,
                                  float cs, float h, float two_h,
                                  float w_norm, float spiky, float mu_eps,
                                  float visc_a, float visc_q, float alpha_b,
                                  float bdens, void* stream) {
  const PairConsts k{h, two_h, w_norm, spiky, mu_eps,
                     visc_a, visc_q, alpha_b, bdens};
  const tf_sph::Walk w{0, 0, xmin, ymin, zmin, cs};
  return stale ? launch<false, true>(rows, cid, cell_start, order, sum_w,
                                     dpress, n, g, k, w, stream)
               : launch<false, false>(rows, cid, cell_start, order, sum_w,
                                      dpress, n, g, k, w, stream);
}

// b, w_cap: the column caps of config.column_caps.
extern "C" int tf_sph_base_column(const float* rows, const int* cid,
                                  const int* cell_start,
                                  const long long* order, float* sum_w,
                                  float* dpress, int n, int g, int b,
                                  int w_cap, int stale, float xmin,
                                  float ymin, float zmin, float cs, float h,
                                  float two_h, float w_norm, float spiky,
                                  float mu_eps, float visc_a, float visc_q,
                                  float alpha_b, float bdens, void* stream) {
  const PairConsts k{h, two_h, w_norm, spiky, mu_eps,
                     visc_a, visc_q, alpha_b, bdens};
  const tf_sph::Walk w{b, w_cap, xmin, ymin, zmin, cs};
  return stale ? launch<true, true>(rows, cid, cell_start, order, sum_w,
                                    dpress, n, g, k, w, stream)
               : launch<true, false>(rows, cid, cell_start, order, sum_w,
                                     dpress, n, g, k, w, stream);
}
