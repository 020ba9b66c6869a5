// Pair-force pass of the base SPH variant: per home particle, the
// density sum sum_w and the pressure-gradient sum dpress over its
// 27-cell stencil (FluidGPU.cu:224-281), as one kernel template with
// four instances, {uncapped, capped} x {fresh, stale}:
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
// * tf_sph_base_pack writes the sorted rows both read (forces.pack_rows)
//   in one launch, and in stale mode each row's current cells and each
//   column's z-cell shift.
//
// Fresh, the candidates of a home row are cells z-1..z+1 of each of its
// 9 neighbour columns, from cell_start, with no per-pair cell test: the
// sorted ids are the current truncated cells.  Stale (the steps between
// two sorts of the sort cadence, sort_every > 1), the tables come from
// an earlier step's positions, and a candidate of a stale neighbour
// column is kept only if its current truncated cells are within one of
// the home row's on x, y and z (the column family's xy_cells masks, per
// row; ROADMAP Queue 3 states how the TPU row-block kernel's stale pair
// set differs).  The stale walk does not read whole columns: the pack
// kernel records d, the largest |current - stale| z-cell of the rows of
// each column (forces.column_shift), and a kept candidate's stale z-cell
// then lies within 1 + d of the home row's current z-cell, a contiguous
// range of the column's rows (tf_sph::stale_window).  The pair set is
// the whole column's; on a just-sorted pool (d = 0) the window is the
// fresh walk's cells.
//
// The lane schedule (as sph_unidyn.cu's).  kLanes lanes of one warp own
// one cell-sorted home row: each computes the row's home terms, walks
// the same 9 runs (tf_sph::for_each_candidate, RUN_OFFSETS order) and
// takes the walked slots t = lane (mod kLanes), t counting every walked
// slot, pair or not.  Each lane sums its pairs in slot order, a shuffle
// butterfly at lane offsets kLanes/2, ..., 1 joins the four sums in one
// fixed order, and lane 0 writes the row at its pool index order[i] (a
// permutation): no atomics on floats, so the results are the same bits
// from run to run, and the four instances run one pair body in one
// order.  The capped and uncapped kernels agree bit for bit where no
// column overflows, and stale and fresh on a just-sorted pool.
// forces.base_lane_pass emulates the schedule in torch.  Built with
// -fmad=false, with the operations per pair of the plain version
// (tpufluids_torch/forces.py, _chunk_sums); only the order of the sums
// differs.
//
// What bounds it on the card: not bytes (a candidate is three 16-byte
// loads of rows, mostly L1/L2 hits, since neighbouring home rows share
// their candidates) nor the pairs' 64 float operations at the peak rate,
// but the instructions of the pair body (five correctly rounded
// divisions and a sqrt, over a hundred instructions a pair; the sixth
// division, press / dens^2, is done once a row by the pack kernel) and
// the divergence and latency of the candidate loop.  One thread a row
// left each warp's loop as long as its longest row; kLanes lanes a row
// split a row's walk, at the price of the row's setup (its home terms
// and the 9 runs' bounds from cell_start) done by every lane and
// log2(kLanes) shuffles a sum.  A row of the 262144 fill walks about 150
// slots: at 32 lanes the setup outweighs each lane's 5 slots, and one
// lane a row diverges most; a one-time probe on the card (PERF.md §6)
// found 4 lanes and 128 threads fastest.  The stale walk's near test
// reads each candidate's current cells, computed once a row (three
// divisions) by the pack kernel.
#include <cuda_runtime.h>
#include <math.h>

#include "sph_common.cuh"

namespace {

// The launch shape: kLanes lanes a home row (sph_kernels.BASE_LANES),
// kThreads threads a block, and at least kMinBlocks blocks resident on a
// multiprocessor (__launch_bounds__: up to 64 registers a thread; left
// to itself ptxas gives the capped fresh instance 48 and an 8-byte stack
// frame).
constexpr int kLanes = 4;
constexpr int kThreads = 128;
constexpr int kMinBlocks = 8;
static_assert(32 % kLanes == 0 && kThreads % 32 == 0,
              "a row's lanes lie in one warp");
constexpr unsigned kWarp = 0xffffffffu;
constexpr int kPackThreads = 256;

// The column caps of config.column_caps (0 uncapped).
struct Caps {
  int b, w_cap;
};

// The domain minimum and the cell size, for the current cells (stale).
struct Domain {
  float xmin, ymin, zmin, cs;
};

// A row's current truncated cells (x, y, z, 0), as binning.cell_trunc:
// trunc((x - xmin) / cs), a true division; NaN stays NaN.
__device__ __forceinline__ float4 cells_now(float x, float y, float z,
                                           const Domain& d) {
  return make_float4(truncf((x - d.xmin) / d.cs), truncf((y - d.ymin) / d.cs),
                     truncf((z - d.zmin) / d.cs), 0.f);
}

// The stale pair mask (forces.near_cells): current cells within one of
// each other on x, y and z.
__device__ __forceinline__ bool near(const float4& a, const float4& b) {
  return fabsf(a.x - b.x) <= 1.f && fabsf(a.y - b.y) <= 1.f &&
         fabsf(a.z - b.z) <= 1.f;
}

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

// Lane ``lane``'s sums (sum_w, dpress x, y, z) of sorted row i over its
// candidates; c is the row's (stale) cell id on a grid of gx x planes of
// g x g columns, below the sentinel, so row i is alive and in the
// domain.  rows: n x 12 floats as 3 float4 per row: (x, y, z, vx),
// (vy, vz, dens, press), (boundary, alive, press / dens^2, 0); see
// forces.pack_rows: the pack kernel computes
// each row's press / dens^2, the same IEEE operations the pair body
// would repeat for every pair.  Stale: cells, the rows' current cells,
// and shift, the stale columns' z-cell shifts, both from the pack
// kernel.
template <bool kCapped, bool kStale>
__device__ __forceinline__ void home_sums(
    const float4* __restrict__ rows, const float4* __restrict__ cells,
    const int* __restrict__ cell_start, const int* __restrict__ shift, int i,
    int c, int gx, int g, int lane, const PairConsts& k, const Caps& caps,
    float (&acc)[4]) {
  const int cz = c % g, cy = (c / g) % g, cx = c / (g * g);
  const float4 ha = rows[3 * i], hb = rows[3 * i + 1], hc = rows[3 * i + 2];
  const float4 ci = kStale ? cells[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float di = hb.z, pi_term = hc.z;
  const bool fluid_i = !(hc.x > 0.5f);
  tf_sph::for_each_candidate<kLanes, kCapped>(
      cell_start, cx, cy, gx, g, caps.w_cap, lane,
      [&](int, int, int col, int& z0, int& z1) {
        if (kStale) return tf_sph::stale_window(ci.z, shift[col], g, z0, z1);
        z0 = max(cz - 1, 0);
        z1 = min(cz + 1, g - 1);
        return true;
      },
      [&](int j) {
        const float4 ja = rows[3 * j], jb = rows[3 * j + 1];
        const float4 jc = rows[3 * j + 2];
        if (!(jc.y > 0.5f)) return;
        if (kStale && !near(ci, cells[j])) return;
        const float rx = ha.x - ja.x, ry = ha.y - ja.y, rz = ha.z - ja.z;
        const float ds = sqrtf(rx * rx + ry * ry + rz * rz);
        if (!(ds > 0.f && ds <= k.two_h)) return;
        const float vx = ha.w - ja.w, vy = hb.x - jb.x, vz = hb.y - jb.y;

        const float wk = tf_sph::w_cubic(ds, k.h, k.w_norm);
        const float dkf = tf_sph::spiky_over_ds(ds, k.h, k.spiky);

        // inline Monaghan viscosity with its quadratic term (:255)
        const float dj = jb.z;
        const float nb = (fluid_i && jc.x > 0.5f) ? 1.f : 0.f;
        const float d = vx * rx + vy * ry + vz * rz;
        const float mu = k.h * (d / (ds * ds + k.mu_eps));
        const float rho_bar = (di + dj) / 2.f;
        const float s = k.visc_a * (mu + k.visc_q * mu * mu) / rho_bar *
                        (d < 0.f ? 1.f : 0.f) * (1.f + nb * k.alpha_b);
        const float p_term = jc.z + pi_term + s;

        acc[0] += wk * (1.f + nb * k.bdens);
        acc[1] += p_term * (dkf * rx);
        acc[2] += p_term * (dkf * ry);
        acc[3] += p_term * (dkf * rz);
      });
}

// kLanes lanes a sorted row; dead and out-of-domain rows carry the
// sentinel id num_cells, sort last and get zeros, and so does a row over
// the home cap b (capped).  Every lane of the warp runs to the butterfly.
template <bool kCapped, bool kStale>
__global__ void __launch_bounds__(kThreads, kMinBlocks) base_forces_kernel(
    const float4* __restrict__ rows, const float4* __restrict__ cells,
    const int* __restrict__ cid, const int* __restrict__ cell_start,
    const int* __restrict__ shift, const long long* __restrict__ order,
    float* __restrict__ sum_w, float* __restrict__ dpress, int n, int g,
    int gx, PairConsts k, Caps caps) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int i = (int)(tid / kLanes);
  const int lane = (int)(threadIdx.x % kLanes);
  const int ncells = gx * g * g;
  const int c = i < n ? cid[i] : ncells;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (c < ncells && !(kCapped && i - cell_start[c - c % g] >= caps.b)) {
    home_sums<kCapped, kStale>(rows, cells, cell_start, shift, i, c, gx, g,
                               lane, k, caps, acc);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2) {
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[m] += __shfl_xor_sync(kWarp, acc[m], off);
  }
  if (i >= n || lane != 0) return;
  const long long p = order[i];
  sum_w[p] = acc[0];
  dpress[3 * p] = acc[1];
  dpress[3 * p + 1] = acc[2];
  dpress[3 * p + 2] = acc[3];
}

// One thread a sorted row i: the packed row of pool row order[i]
// (forces.pack_rows: alive is alive[p] and in_dom[i], as 0/1; then
// press / dens^2), and, when cells is not null (stale), the row's current
// cells into cells[i] and its |current - stale| z-cell, capped at g, into
// shift[its column] by integer atomicMax (forces.column_shift): rows in
// a column, alive, whose current z-cell is not NaN (a NaN row keeps no
// pair, so it widens no window).  Integer maxima do not depend on the
// order of the atomics.
__global__ void __launch_bounds__(kPackThreads) base_pack_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ dens, const float* __restrict__ press,
    const unsigned char* __restrict__ boundary,
    const unsigned char* __restrict__ alive,
    const long long* __restrict__ order,
    const unsigned char* __restrict__ in_dom, const int* __restrict__ cid,
    float4* __restrict__ rows, float4* __restrict__ cells,
    int* __restrict__ shift, int n, int g, int gx, Domain dom) {
  const int i = blockIdx.x * kPackThreads + threadIdx.x;
  if (i >= n) return;
  const long long p = order[i];
  const float x = pos[3 * p], y = pos[3 * p + 1], z = pos[3 * p + 2];
  const float d = dens[p], pr = press[p];
  const float live = alive[p] && in_dom[i] ? 1.f : 0.f;
  rows[3 * i] = make_float4(x, y, z, vel[3 * p]);
  rows[3 * i + 1] = make_float4(vel[3 * p + 1], vel[3 * p + 2], d, pr);
  rows[3 * i + 2] =
      make_float4(boundary[p] ? 1.f : 0.f, live, pr / (d * d), 0.f);
  if (cells == nullptr) return;
  const float4 now = cells_now(x, y, z, dom);
  cells[i] = now;
  const int c = cid[i];
  if (c >= gx * g * g || !(live > 0.5f) || isnan(now.z)) return;
  const int dz = (int)fminf(fabsf(now.z - (float)(c % g)), (float)g);
  if (dz > 0) atomicMax(&shift[c / g], dz);
}

template <bool kCapped, bool kStale>
int launch(const float* rows, const float* cells, const int* cid,
           const int* cell_start, const int* shift, const long long* order,
           float* sum_w, float* dpress, int n, int g, int gx,
           const PairConsts& k, const Caps& caps, void* stream) {
  if (n == 0) return 0;
  const unsigned blocks =
      (unsigned)(((long long)n * kLanes + kThreads - 1) / kThreads);
  base_forces_kernel<kCapped, kStale>
      <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          reinterpret_cast<const float4*>(rows),
          reinterpret_cast<const float4*>(cells), cid, cell_start, shift,
          order, sum_w, dpress, n, g, gx, k, caps);
  return (int)cudaGetLastError();
}

}  // namespace

#define TF_BASE_ARGS                                                        \
  const float *rows, const float *cells, const int *cid,                    \
      const int *cell_start, const int *shift, const long long *order,      \
      float *sum_w, float *dpress, int n, int g, int gx
#define TF_BASE_CONSTS                                                      \
  float h, float two_h, float w_norm, float spiky, float mu_eps,            \
      float visc_a, float visc_q, float alpha_b, float bdens
#define TF_BASE_K                                                           \
  PairConsts { h, two_h, w_norm, spiky, mu_eps, visc_a, visc_q, alpha_b, bdens }

// g: the grid's y/z extent; gx: its x planes (g for the cube, a rank's
// slab under sharding), the cell ids local to it.  cells and shift: the
// current cells and z-cell shifts of tf_sph_base_pack when the tables are
// an earlier step's (stale; see above), else null.
extern "C" int tf_sph_base_forces(TF_BASE_ARGS, TF_BASE_CONSTS,
                                  void* stream) {
  const Caps caps{0, 0};
  return cells ? launch<false, true>(rows, cells, cid, cell_start, shift,
                                     order, sum_w, dpress, n, g, gx,
                                     TF_BASE_K, caps, stream)
               : launch<false, false>(rows, cells, cid, cell_start, shift,
                                      order, sum_w, dpress, n, g, gx,
                                      TF_BASE_K, caps, stream);
}

// b, w_cap: the column caps of config.column_caps.
extern "C" int tf_sph_base_column(TF_BASE_ARGS, int b, int w_cap,
                                  TF_BASE_CONSTS, void* stream) {
  const Caps caps{b, w_cap};
  return cells ? launch<true, true>(rows, cells, cid, cell_start, shift,
                                    order, sum_w, dpress, n, g, gx,
                                    TF_BASE_K, caps, stream)
               : launch<true, false>(rows, cells, cid, cell_start, shift,
                                     order, sum_w, dpress, n, g, gx,
                                     TF_BASE_K, caps, stream);
}

// The rows (n x 12 floats) of the pool fields in sorted order, and, when
// cells is not null (n x 4 floats; shift: gx*g int32, zeroed by the
// caller), each row's current cells and each column's z-cell shift for
// the stale walk.
extern "C" int tf_sph_base_pack(const float* pos, const float* vel,
                                const float* dens, const float* press,
                                const unsigned char* boundary,
                                const unsigned char* alive,
                                const long long* order,
                                const unsigned char* in_dom, const int* cid,
                                float* rows, float* cells, int* shift, int n,
                                int g, int gx, float xmin, float ymin,
                                float zmin, float cs, void* stream) {
  if (n == 0) return 0;
  const Domain dom{xmin, ymin, zmin, cs};
  base_pack_kernel<<<(unsigned)((n + kPackThreads - 1) / kPackThreads),
                     kPackThreads, 0, (cudaStream_t)stream>>>(
      pos, vel, dens, press, boundary, alive, order, in_dom, cid,
      reinterpret_cast<float4*>(rows), reinterpret_cast<float4*>(cells),
      shift, n, g, gx, dom);
  return (int)cudaGetLastError();
}

// The force kernels' launch shape: lanes a home row, threads a block,
// and the blocks one multiprocessor of the current device keeps resident
// (the uncapped fresh instance).
extern "C" int tf_sph_base_info(int* lanes, int* threads, int* resident) {
  *lanes = kLanes;
  *threads = kThreads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      resident, base_forces_kernel<false, false>, kThreads, 0);
}
