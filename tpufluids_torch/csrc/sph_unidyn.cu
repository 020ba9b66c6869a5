// Pair passes of the unidyn (two-phase sand/water) SPH variant: per home
// particle, over its 27-cell stencil (FluidGPU-unidyn.cu:249-401),
//   pass A: the mass-weighted density sum and pressure gradient, the
//           diffusion gradient, the raw velocity gradient and stress
//           acceleration, the drift velocities of both phases, the pair
//           count and, with merging on, the nearest eligible partner;
//   pass B: the mixture acceleration and the phase transport rates,
//           which read every candidate's drift velocity from pass A.
//
// Replaces unidyn_forces_resident (_unidyn_resident_kernel) and
// unidyn_forces_rowblock (_unidyn_rowblock_kernel_a / _b) of
// tpufluids/sph_pallas.py, whose pair bodies are _make_unidyn_a_body and
// _make_unidyn_b_body, with tf_unidyn_pass_a / _b; and the column family
// unidyn_forces_pallas (_unidyn_kernel_a / _b, the same bodies on capped
// column windows) with tf_unidyn_column_a / _b, the same passes capped:
// a row at rank b or more in its (x, y) column gets zeros, and only the
// first w_cap rows of each neighbour column are candidates.  The TPU
// kernels hold the packed pool or column windows in VMEM and sweep home
// blocks over candidate chunks; here a group of lanes owns one
// cell-sorted row and walks its candidates straight from device memory
// (the walk of sph_common.cuh, which the base pass shares).
// The two passes are two launches on one stream: pass A writes the drift
// velocities in sorted order (drift_sorted; zeros for a capped-out row),
// and pass B reads them there.  The resident and column wrappers launch
// the two back to back; the row-block wrapper runs the drift_fix hook
// between them and gathers the fixed drifts into drift_sorted itself.
//
// The lane schedule.  kLanes lanes of one warp own one cell-sorted home
// row: each computes the row's home-only terms, walks the same 9 runs
// (RUN_OFFSETS order, each the contiguous rows of its cells, z ascending;
// the octant sub-bin rule of an overfull home cell, FluidGPU-unidyn.cu:
// 579-583, and the column caps cut whole cells and rows) and takes the
// walked slots t = lane (mod kLanes), t counting every walked slot, pair
// or not: the split follows the bin tables, not the positions.  Each lane
// sums its pairs in its slot order; a shuffle butterfly at lane offsets
// kLanes/2, ..., 1 combines the lanes in one fixed order, and lane 0
// writes the row.  The merge partner is the lexicographic least (distance,
// sorted row) over the lanes: run order is ascending sorted row, so that
// is the plain version's first of equals.  forces.lane_sums emulates the
// schedule in torch.
//
// What bounds it on the card: not bytes (each candidate is four 16-byte
// loads of rows in pass A, six with drift_sorted in pass B, mostly L1/L2
// hits, since neighbouring rows share their candidates) nor the pairs'
// few hundred float operations, but the latency of each lane's serial
// candidate loop: a pool of 14040 rows at one thread a row left about 3
// warps on a multiprocessor, each walking up to 224 candidates.  kLanes
// lanes a row put kLanes times the warps in flight, each lane walking
// 1/kLanes of the candidates, at the price of the home terms computed
// kLanes times and log2(kLanes) shuffles a sum.  At kLanes = 32 a warp
// owns one row, so its lanes share the loop bounds and diverge only on
// the pair test.  kLanes and kThreads were chosen by a one-time probe on
// the card (PERF.md §6).
//
// Cells come from the binning's sorted ids (truncated cell coordinates),
// not from floored positions as in the Pallas kernel.
//
// Lane 0 of each row writes its output row at the pool index order[i] (a
// permutation), with no atomics, so results are bitwise identical from
// run to run.  Built with -fmad=false, with the operations per pair of
// the plain version (tpufluids_torch/forces.py, _unidyn_a_chunk and
// _unidyn_b_chunk); only the order of the sums differs.
#include <climits>
#include <cuda_runtime.h>
#include <math.h>

#include "sph_common.cuh"

namespace {

// The launch shape: kLanes lanes a home row (sph_kernels.UNIDYN_LANES),
// kThreads threads a block.
constexpr int kLanes = 32;
constexpr int kThreads = 128;
static_assert(32 % kLanes == 0 && kThreads % 32 == 0,
              "a row's lanes lie in one warp");
constexpr unsigned kWarp = 0xffffffffu;
constexpr int kACols = 26;   // forces.A_COLS
constexpr int kBCols = 5;    // forces.B_COLS

struct UnidynConsts {
  float h, two_h;
  float w_norm;        // PI_REF h^3
  float spiky;         // -45 / (PI_REF h^6)
  float mu_eps;        // 0.01 h^2
  float alpha_fluid, sound;
  float visc_q;        // visc_quadratic / sound
  float alpha_sb;      // alpha_sand_boundary
  float bdens;         // bdensfactor
  float mix_reg;       // mixfactor_reg
  float rho0, rho0_sand;
  float frac_min, frac_max;
  float mixpressure, mixbrownian;
  float gravity;
  float merge_dist;    // <= 0: merging off
};

// Rows (forces.pack_unidyn_rows): 16 floats as 4 float4 per sorted row:
// (x, y, z, vx), (vy, vz, dens, press), (boundary, alive, mass, solid),
// (fluid, merge eligibility, 0, 0).
struct Row {
  float4 a, b, c, d;
};

__device__ __forceinline__ Row load_row(const float4* __restrict__ rows,
                                        int i) {
  return Row{rows[4 * i], rows[4 * i + 1], rows[4 * i + 2], rows[4 * i + 3]};
}

// Calls f(j) for the sorted rows j of the 27-cell stencil of cell c that
// lane ``lane`` of the row's kLanes takes (tf_sph::for_each_candidate) on
// a grid of gx x planes (the cube, or a rank's x-slab) of g x g columns:
// each run the cells z-1..z+1 of its column.  With sub-binning on
// (threshold >= 0) and more than threshold rows in cell c, only the cells
// at offsets {0, dir} per axis.  Capped (the column family): only the
// first w_cap rows of each neighbour column.
template <bool kCapped, class F>
__device__ __forceinline__ void for_each_candidate(
    const int* __restrict__ cell_start, int c, int gx, int g, int threshold,
    int octant, int w_cap, int lane, F&& f) {
  const int cz = c % g, cy = (c / g) % g, cx = c / (g * g);
  const bool sub =
      threshold >= 0 && cell_start[c + 1] - cell_start[c] > threshold;
  const int dirx = (octant & 1) ? 1 : -1;
  const int diry = (octant & 2) ? 1 : -1;
  const int dirz = (octant & 4) ? -1 : 1;
  const int z0 = max(sub ? min(cz, cz + dirz) : cz - 1, 0);
  const int z1 = min(sub ? max(cz, cz + dirz) : cz + 1, g - 1);
  tf_sph::for_each_candidate<kLanes, kCapped>(
      cell_start, cx, cy, gx, g, w_cap, lane,
      [&](int dx, int dy, int, int& lo, int& hi) {
        if (sub && ((dx != 0 && dx != dirx) || (dy != 0 && dy != diry))) {
          return false;
        }
        lo = z0;
        hi = z1;
        return true;
      },
      f);
}

// Whether sorted row i, of cell c (sentinel: out of the domain), gets
// forces: in the domain and, capped, at rank below b in its column.
template <bool kCapped>
__device__ __forceinline__ bool is_home(const int* __restrict__ cell_start,
                                        int i, int c, int gx, int g, int b) {
  if (c >= gx * g * g) return false;
  return !kCapped || i - cell_start[c - c % g] < b;
}

// The merge-partner order (forces.nearer): nearer, or as near and earlier
// in run order, the smaller sorted row.
__device__ __forceinline__ bool nearer(float d, int j, float bd, int bj) {
  return d < bd || (d == bd && j < bj);
}

struct Geom {
  float r[3], v[3], dk[3];
  float ds, dkf;
};

// a[0] b[0] + a[1] b[1] + a[2] b[2], in the plain version's order
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// Pair geometry of home row hi and candidate row hj; false when the pair
// is masked out (dead or out-of-domain candidate, self, beyond 2h).
__device__ __forceinline__ bool pair_geom(const Row& hi, const Row& hj,
                                          const UnidynConsts& k, Geom& p) {
  if (!(hj.c.y > 0.5f)) return false;
  p.r[0] = hi.a.x - hj.a.x;
  p.r[1] = hi.a.y - hj.a.y;
  p.r[2] = hi.a.z - hj.a.z;
  p.ds = sqrtf(p.r[0] * p.r[0] + p.r[1] * p.r[1] + p.r[2] * p.r[2]);
  if (!(p.ds > 0.f && p.ds <= k.two_h)) return false;
  p.v[0] = hi.a.w - hj.a.w;
  p.v[1] = hi.b.x - hj.b.x;
  p.v[2] = hi.b.y - hj.b.y;
  p.dkf = tf_sph::spiky_over_ds(p.ds, k.h, k.spiky);
#pragma unroll
  for (int a = 0; a < 3; ++a) p.dk[a] = p.dkf * p.r[a];
  return true;
}

// The sorted row and lane of this thread.  Every lane of the warp runs
// to the butterfly: rows past n and rows that get no forces carry zeros.
struct Lane {
  int i, lane;
  bool in;
};

__device__ __forceinline__ Lane this_lane(int n) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int i = (int)(tid / kLanes);
  return Lane{i, (int)(threadIdx.x % kLanes), i < n};
}

template <int kCols>
__device__ __forceinline__ void butterfly(float (&acc)[kCols]) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2) {
#pragma unroll
    for (int m = 0; m < kCols; ++m) {
      acc[m] += __shfl_xor_sync(kWarp, acc[m], off);
    }
  }
}

template <bool kCapped>
__global__ void __launch_bounds__(kThreads) unidyn_pass_a_kernel(
    const float4* __restrict__ rows, const float* __restrict__ delpress,
    const float* __restrict__ stress, const int* __restrict__ cid,
    const int* __restrict__ cell_start, const long long* __restrict__ order,
    const int* __restrict__ octant, float* __restrict__ out_a,
    long long* __restrict__ partner, float4* __restrict__ drift_sorted,
    int n, int g, int gx, int threshold, int b, int w_cap, UnidynConsts k) {
  const Lane ln = this_lane(n);
  const int i = ln.i;
  const int c = ln.in ? cid[i] : 0;
  float acc[kACols];
#pragma unroll
  for (int m = 0; m < kACols; ++m) acc[m] = 0.f;
  float best_d = INFINITY;
  int best_j = INT_MAX;
  if (ln.in && is_home<kCapped>(cell_start, i, c, gx, g, b)) {
    const long long p = order[i];
    const Row hi = load_row(rows, i);
    const float vi[3] = {hi.a.w, hi.b.x, hi.b.y};
    const float di = hi.b.z, pi = hi.b.w, mi = hi.c.z;
    const float si = hi.c.w, fi = hi.d.x;
    const bool bi = hi.c.x > 0.5f;
    const bool merge_i = k.merge_dist > 0.f && hi.d.y > 0.5f;
    float sig[9];
#pragma unroll
    for (int m = 0; m < 9; ++m) sig[m] = stress[9 * p + m];
    // home-only terms of the viscosity and the drift velocities
    const float pi_term = pi / (di * di);
    const float alpha_s = ((si * 9.f + 1.f) * k.alpha_fluid) * k.sound;
    const float bfac_nb = 1.f + (1.f + 3.f * (fi * fi)) * k.alpha_sb;
    float denom = k.rho0_sand * si + k.rho0 * fi;
    denom = denom == 0.f ? 1.f : denom;
    const float msf = si * k.rho0_sand / denom;
    const float mff = fi * k.rho0 / denom;
    const bool gate = msf > k.frac_min && msf < k.frac_max &&
                      mff > k.frac_min && mff < k.frac_max;
    const float s_safe = si == 0.f ? 1.f : si;
    const float f_safe = fi == 0.f ? 1.f : fi;
    const float s_pref = di * (si - msf * si - mff * fi);
    const float f_pref = di * (fi - msf * si - mff * fi);
    // the literal 150 of FluidGPU-unidyn.cu:342-348; 150 / di as the
    // plain version's reciprocal times 150
    const float b150 = (1.f / di) * 150.f;
    const float body0[3] = {b150 * delpress[3 * p] + 0.f,
                            b150 * delpress[3 * p + 1] + 0.f,
                            b150 * delpress[3 * p + 2] + k.gravity};
    const int oct = octant != nullptr ? octant[i] : 0;

    for_each_candidate<kCapped>(cell_start, c, gx, g, threshold, oct,
                                w_cap, ln.lane, [&](int j) {
      const Row hj = load_row(rows, j);
      Geom q;
      if (!pair_geom(hi, hj, k, q)) return;
      const float dj = hj.b.z, pj = hj.b.w, mj = hj.c.z;
      const float sj = hj.c.w, fj = hj.d.x;
      const bool bj = hj.c.x > 0.5f;
      const bool nb = !bi && bj, both_fluid = !bi && !bj;

      // unidyn viscosity with the particle's own mass
      // (FluidGPU-unidyn.cu:307; PARITY.md deviation #7)
      const float d = q.v[0] * q.r[0] + q.v[1] * q.r[1] + q.v[2] * q.r[2];
      const float mu = k.h * (d / (q.ds * q.ds + k.mu_eps));
      const float rho_bar = (di + dj) / 2.f;
      const float s = d < 0.f ? alpha_s * (mi * mu + k.visc_q * mu * mu) /
                                    rho_bar * (nb ? bfac_nb : 1.f)
                              : 0.f;
      const float p_term = pj / (dj * dj) + pi_term + s;
      acc[0] += tf_sph::w_cubic(q.ds, k.h, k.w_norm) *
                (nb ? 1.f + k.bdens : 1.f) * mj;
#pragma unroll
      for (int a = 0; a < 3; ++a) acc[1 + a] += p_term * q.dk[a] * mj;
      if (both_fluid) {
#pragma unroll
        for (int a = 0; a < 3; ++a) acc[4 + a] += mj / dj * q.dk[a];
      }
      // mixfactor-gated velocity gradient and stress acceleration
      // (FluidGPU-unidyn.cu:368-381)
      const float mf = both_fluid && si > 0.f && sj > 0.f
                           ? 2.f * si * sj / (si + sj + k.mix_reg)
                           : 0.f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          acc[7 + 3 * a + b] += mf * q.dk[a] * q.v[b];
        }
      }
      const float t[3] = {(1.f + mf) * q.dk[0], (1.f + mf) * q.dk[1],
                          (1.f + mf) * q.dk[2]};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        acc[16 + a] += sig[3 * a] * t[0] + sig[3 * a + 1] * t[1] +
                       sig[3 * a + 2] * t[2];
      }
      // drift velocities (FluidGPU-unidyn.cu:314-356)
      if (both_fluid && gate) {
        const float v_dk =
            vi[0] * q.dk[0] + vi[1] * q.dk[1] + vi[2] * q.dk[2];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float sg = (sj - si) * q.dk[a];
          const float fg = (fj - fi) * q.dk[a];
          const float sbrown =
              sg / s_safe * (1.f - msf) - mff * fg / f_safe;
          const float fbrown =
              fg / f_safe * (1.f - mff) - msf * sg / s_safe;
          const float a_slip = (si * pi - sj * pj) * q.dk[a];
          const float b_slip = (fi * pi - fj * pj) * q.dk[a];
          const float sslip = a_slip * (1.f - msf) - mff * b_slip;
          const float fslip = b_slip * (1.f - mff) - msf * a_slip;
          const float body = body0[a] - v_dk * q.v[a];
          acc[19 + a] += k.mixpressure * (s_pref * body + sslip) -
                         k.mixbrownian * sbrown;
          acc[22 + a] += k.mixpressure * (f_pref * body + fslip) -
                         k.mixbrownian * fbrown;
        }
      }
      acc[25] += 1.f;
      // nearest eligible merge partner (FluidGPU-unidyn.cu:261-275); a
      // lane's slots come in run order
      if (merge_i && hj.d.y > 0.5f && q.ds <= k.merge_dist &&
          nearer(q.ds, j, best_d, best_j)) {
        best_d = q.ds;
        best_j = j;
      }
    });
  }
  butterfly(acc);
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2) {
    const float od = __shfl_xor_sync(kWarp, best_d, off);
    const int oj = __shfl_xor_sync(kWarp, best_j, off);
    if (nearer(od, oj, best_d, best_j)) {
      best_d = od;
      best_j = oj;
    }
  }
  if (!ln.in || ln.lane != 0) return;
  const long long p = order[i];
#pragma unroll
  for (int m = 0; m < kACols; ++m) out_a[kACols * p + m] = acc[m];
  if (partner != nullptr) {
    partner[p] = best_j != INT_MAX ? order[best_j] : -1;
  }
  if (drift_sorted != nullptr) {
    drift_sorted[2 * i] = make_float4(acc[19], acc[20], acc[21], acc[22]);
    drift_sorted[2 * i + 1] = make_float4(acc[23], acc[24], 0.f, 0.f);
  }
}

// drift_sorted: 8 floats as 2 float4 per sorted row: solid drift 0:3,
// fluid drift 3:6, then zeros.
template <bool kCapped>
__global__ void __launch_bounds__(kThreads) unidyn_pass_b_kernel(
    const float4* __restrict__ rows, const float4* __restrict__ drift_sorted,
    const int* __restrict__ cid, const int* __restrict__ cell_start,
    const long long* __restrict__ order, const int* __restrict__ octant,
    float* __restrict__ out_b, int n, int g, int gx, int threshold, int b,
    int w_cap, UnidynConsts k) {
  const Lane ln = this_lane(n);
  const int i = ln.i;
  const int c = ln.in ? cid[i] : 0;
  float acc[kBCols] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (ln.in && is_home<kCapped>(cell_start, i, c, gx, g, b)) {
    const Row hi = load_row(rows, i);
    const float4 e0 = drift_sorted[2 * i], e1 = drift_sorted[2 * i + 1];
    const float sdi[3] = {e0.x, e0.y, e0.z}, fdi[3] = {e0.w, e1.x, e1.y};
    const float di = hi.b.z, si = hi.c.w, fi = hi.d.x;
    const bool bi = hi.c.x > 0.5f;
    const int oct = octant != nullptr ? octant[i] : 0;

    for_each_candidate<kCapped>(cell_start, c, gx, g, threshold, oct,
                                w_cap, ln.lane, [&](int j) {
      const Row hj = load_row(rows, j);
      Geom q;
      if (!pair_geom(hi, hj, k, q)) return;
      const float4 f0 = drift_sorted[2 * j], f1 = drift_sorted[2 * j + 1];
      const float sdj[3] = {f0.x, f0.y, f0.z}, fdj[3] = {f0.w, f1.x, f1.y};
      const float dj = hj.b.z, sj = hj.c.w, fj = hj.d.x;
      const bool both_fluid = !bi && !(hj.c.x > 0.5f);
      const float ds_i = dot3(sdi, q.dk), ds_j = dot3(sdj, q.dk);
      const float df_i = dot3(fdi, q.dk), df_j = dot3(fdj, q.dk);
      // mixture acceleration (FluidGPU-unidyn.cu:391-398)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float term =
            (sj * dj) * (sj * sdj[a] * ds_j + si * sdi[a] * ds_i) +
            (fj * dj) * (fj * fdj[a] * df_j + fi * fdi[a] * df_i);
        acc[a] += -term / (di * dj);
      }
      // phase transport (FluidGPU-unidyn.cu:400-401): the divergence part
      // is boundary-gated, the drift part is not
      const float dk_vab = dot3(q.dk, q.v);
      const float drift_s = (si * sdi[0] + sj * sdj[0]) * q.dk[0] +
                            (si * sdi[1] + sj * sdj[1]) * q.dk[1] +
                            (si * sdi[2] + sj * sdj[2]) * q.dk[2];
      const float drift_f = (fi * fdi[0] + fj * fdj[0]) * q.dk[0] +
                            (fi * fdi[1] + fj * fdj[1]) * q.dk[1] +
                            (fi * fdi[2] + fj * fdj[2]) * q.dk[2];
      const float half = -0.5f / dj;
      acc[3] +=
          (both_fluid ? half * (si + sj) * dk_vab : 0.f) + -drift_s / dj;
      acc[4] +=
          (both_fluid ? half * (fi + fj) * dk_vab : 0.f) + -drift_f / dj;
    });
  }
  butterfly(acc);
  if (!ln.in || ln.lane != 0) return;
  const long long p = order[i];
#pragma unroll
  for (int m = 0; m < kBCols; ++m) out_b[kBCols * p + m] = acc[m];
}

unsigned blocks_for(int n) {
  return (unsigned)(((long long)n * kLanes + kThreads - 1) / kThreads);
}

template <bool kCapped>
int launch_a(const float* rows, const float* delpress, const float* stress,
             const int* cid, const int* cell_start, const long long* order,
             const int* octant, float* out_a, long long* partner,
             float* drift_sorted, int n, int g, int gx, int threshold, int b,
             int w_cap, const UnidynConsts& k, void* stream) {
  if (n == 0) return 0;
  unidyn_pass_a_kernel<kCapped>
      <<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
          reinterpret_cast<const float4*>(rows), delpress, stress, cid,
          cell_start, order, octant, out_a, partner,
          reinterpret_cast<float4*>(drift_sorted), n, g, gx, threshold, b,
          w_cap, k);
  return (int)cudaGetLastError();
}

template <bool kCapped>
int launch_b(const float* rows, const float* drift_sorted, const int* cid,
             const int* cell_start, const long long* order, const int* octant,
             float* out_b, int n, int g, int gx, int threshold, int b,
             int w_cap, float h, float two_h, float spiky, void* stream) {
  if (n == 0) return 0;
  UnidynConsts k{};
  k.h = h;
  k.two_h = two_h;
  k.spiky = spiky;
  unidyn_pass_b_kernel<kCapped>
      <<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
          reinterpret_cast<const float4*>(rows),
          reinterpret_cast<const float4*>(drift_sorted), cid, cell_start,
          order, octant, out_b, n, g, gx, threshold, b, w_cap, k);
  return (int)cudaGetLastError();
}

}  // namespace

#define TF_UNIDYN_A_ARGS                                                     \
  const float *rows, const float *delpress, const float *stress,             \
      const int *cid, const int *cell_start, const long long *order,         \
      const int *octant, float *out_a, long long *partner,                   \
      float *drift_sorted, int n, int g, int gx, int threshold
#define TF_UNIDYN_A_CONSTS                                                   \
  float h, float two_h, float w_norm, float spiky, float mu_eps,             \
      float alpha_fluid, float sound, float visc_q, float alpha_sb,          \
      float bdens, float mix_reg, float rho0, float rho0_sand,               \
      float frac_min, float frac_max, float mixpressure, float mixbrownian,  \
      float gravity, float merge_dist
#define TF_UNIDYN_A_K                                                        \
  UnidynConsts {                                                             \
    h, two_h, w_norm, spiky, mu_eps, alpha_fluid, sound, visc_q, alpha_sb,   \
        bdens, mix_reg, rho0, rho0_sand, frac_min, frac_max, mixpressure,    \
        mixbrownian, gravity, merge_dist                                     \
  }

// g: the grid's y/z extent; gx: its x planes (g for the cube, a rank's
// slab under sharding), the cell ids local to it.
extern "C" int tf_unidyn_pass_a(TF_UNIDYN_A_ARGS, TF_UNIDYN_A_CONSTS,
                                void* stream) {
  return launch_a<false>(rows, delpress, stress, cid, cell_start, order,
                         octant, out_a, partner, drift_sorted, n, g, gx,
                         threshold, 0, 0, TF_UNIDYN_A_K, stream);
}

extern "C" int tf_unidyn_pass_b(const float* rows, const float* drift_sorted,
                                const int* cid, const int* cell_start,
                                const long long* order, const int* octant,
                                float* out_b, int n, int g, int gx,
                                int threshold, float h, float two_h,
                                float spiky, void* stream) {
  return launch_b<false>(rows, drift_sorted, cid, cell_start, order, octant,
                         out_b, n, g, gx, threshold, 0, 0, h, two_h, spiky,
                         stream);
}

// The column family's passes: b, w_cap are the caps of
// config.column_caps; a row over the home cap gets zeros, and zero drift
// in drift_sorted for pass B.
extern "C" int tf_unidyn_column_a(TF_UNIDYN_A_ARGS, int b, int w_cap,
                                  TF_UNIDYN_A_CONSTS, void* stream) {
  return launch_a<true>(rows, delpress, stress, cid, cell_start, order,
                        octant, out_a, partner, drift_sorted, n, g, gx,
                        threshold, b, w_cap, TF_UNIDYN_A_K, stream);
}

extern "C" int tf_unidyn_column_b(const float* rows,
                                  const float* drift_sorted, const int* cid,
                                  const int* cell_start,
                                  const long long* order, const int* octant,
                                  float* out_b, int n, int g, int gx,
                                  int threshold, int b, int w_cap, float h,
                                  float two_h, float spiky, void* stream) {
  return launch_b<true>(rows, drift_sorted, cid, cell_start, order, octant,
                        out_b, n, g, gx, threshold, b, w_cap, h, two_h, spiky,
                        stream);
}

// The passes' launch shape: lanes a home row, threads a block, and the
// blocks of pass A and of pass B that one multiprocessor of the current
// device keeps resident.
extern "C" int tf_unidyn_info(int* lanes, int* threads, int* resident_a,
                              int* resident_b) {
  *lanes = kLanes;
  *threads = kThreads;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      resident_a, unidyn_pass_a_kernel<false>, kThreads, 0);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        resident_b, unidyn_pass_b_kernel<false>, kThreads, 0);
  }
  return (int)e;
}
