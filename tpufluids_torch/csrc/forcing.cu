// Buoyancy + vorticity confinement in one launch.
//
// Replaces forcing3d_pallas / _force_kernel / _forcing_stage
// (tpufluids/grid/pallas_kernels.py), which does both in one pass with a
// halo of 2 planes held in VMEM.  So does this kernel, in shared memory:
// the confinement at a cell needs |curl| at its neighbours, and each
// |curl| needs u, v and w' (w after buoyancy) at its own neighbours, two
// cells from the first.
//
// What bounds it on the H100.  One pass over the fields: u, v, w, dens
// and temp in, u, v and w out, 8 field passes (0.164 ms at 256^3), or 5
// without buoyancy.  The design this replaces cut the halo of 2 into two
// launches through two scratch fields (w' and |curl|), 14 field passes,
// and recomputed w' four times a cell.
//
// Design.  The x-march of stencil_march.cuh: a block owns a TY x TZ
// (y, z) tile and a segment of centre rows.  Its shared memory holds a
// ring of 6 x-planes of u, v and w', each the tile widened by 2, and a
// ring of 4 planes of |curl|, each the tile widened by 1.  w' is computed
// once a staged cell (w itself without buoyancy; with it, buoyant_value at
// the clamped cell times the z ghost sign, as w_prime gives it), between
// the registers a plane is read into and the ring.  At step x a block
// reads plane x + 3 into registers, computes |curl| on plane x + 1 (0 off
// the interior), stores plane x + 3, passes one barrier and writes the
// confined cells of plane x: the rings are deep enough that a warp a step
// ahead never overwrites what a warp behind still reads, so one barrier a
// step is enough.  A thread owns one cell of the tile.  The cell arithmetic is
// forcing.cuh's, which the whole step of step.cu shares.
//
// The shape, 8 x 32 cells, one a thread, segments of 32 rows, 64
// registers (four blocks a multiprocessor), came from a one-time probe on
// the card (PERF.md), as did what holds it at about twice its
// bound: reading the planes alone takes 0.19 ms at 256^3 and the confined
// cells' compute and writes add 0.15 ms, little of it overlapped; reading
// plane x + 4 a step ahead into a second register set was slower (96
// registers, or spills at 64).
//
// The bits.  The values equal the two launches of half A (w', |curl|) and
// half B that the whole step still runs, and forcing3d_plain: on a slab,
// half B reads half A's w' as 0 on the rows without a stencil, and its
// |curl| as 0 off the interior (the slab's outer two rows a side get what
// those zeros give).  With buoyancy and no vorticity the launch is one
// elementwise pass writing w' (half A).
#include "forcing.cuh"
#include "stencil_march.cuh"

namespace {

// A compiled shape: a TY x TZ tile, a cell a thread, SEG centre rows a
// segment (kernels.FORCING_TILE names it to the Python side: change both
// together), at most 65536 / (NT MINB) registers a thread.
template <int TY_, int TZ_, int SEG_, int MINB_>
struct Shape {
  static constexpr int TY = TY_, TZ = TZ_, SEG = SEG_;
  static constexpr int MINB = MINB_;  // resident blocks the registers allow
  static constexpr int NT = TY * TZ;
  static constexpr int H2 = TY + 4, W2 = TZ + 4;  // u, v, w': halo 2
  static constexpr int P2 = H2 * W2;
  static constexpr int H1 = TY + 2, W1 = TZ + 2;  // |curl|: halo 1
  static constexpr int P1 = H1 * W1;
  static constexpr int RING = 6, MRING = 4;
  static constexpr int LOADS = (P2 + NT - 1) / NT;
  static constexpr int MAGS = (P1 + NT - 1) / NT;
  static constexpr int SMEM = (RING * 3 * P2 + MRING * P1) * 4;
};

using Shipped = Shape<8, 32, 32, 4>;

// The writes of a confined cell: every output cell that clamps to it,
// u, v and w times their set_bnd signs (a functor, not a lambda, so that
// it is always inlined).
struct PutCell {
  float* uo;
  float* vo;
  float* wo;
  float fu, fv, fw;
  __device__ __forceinline__ void operator()(int o, float sx, float sy,
                                             float sz) const {
    uo[o] = sx * fu;
    vo[o] = sy * fv;
    wo[o] = sz * fw;
  }
};

struct ZeroCell {
  float* uo;
  float* vo;
  float* wo;
  __device__ __forceinline__ void operator()(int o) const {
    uo[o] = vo[o] = wo[o] = 0.0f;
  }
};

// What a thread does in the march of one block.
template <bool BUOY, class S>
struct Marcher {
  const float *u, *v, *w, *dens, *temp;
  const int n, N, NN;
  const tf::Buoyancy bu;
  const float eps_h, inv_h;
  const tf::Place pl;
  const tf::BlockPart b;
  float* const ring;  // [RING][u, v, w'][P2]
  float* const mags;  // [MRING][P1]
  // the staged cells of this thread (thread + l NT of a plane): raw and
  // clamped (y, z) offsets (raw -1: not staged), the z ghost sign of w';
  // a plane's values in flight
  int off[S::LOADS], coff[S::LOADS];
  float zsign[S::LOADS];
  float ru[S::LOADS], rv[S::LOADS], rw[S::LOADS], rd[S::LOADS],
      rt[S::LOADS];
  // this thread's cell: (cj, ck) at (ty, tz) of the tile
  int ty, tz, cj, ck;

  __device__ __forceinline__ Marcher(const float* u_, const float* v_,
                                     const float* w_, const float* dens_,
                                     const float* temp_, int n_,
                                     tf::Buoyancy bu_, float eps_h_,
                                     float inv_h_, tf::Place pl_,
                                     const tf::BlockPart& b_, float* smem)
      : u(u_), v(v_), w(w_), dens(dens_), temp(temp_), n(n_), N(n_ + 2),
        NN((n_ + 2) * (n_ + 2)), bu(bu_), eps_h(eps_h_), inv_h(inv_h_),
        pl(pl_), b(b_), ring(smem), mags(smem + S::RING * 3 * S::P2) {
    const int ylim = min(b.y1 + 2, N - 1), zlim = min(b.z1 + 2, N - 1);
#pragma unroll
    for (int l = 0; l < S::LOADS; ++l) {
      const int t = threadIdx.x + l * S::NT;
      const int y = b.y0 - 2 + t / S::W2, z = b.z0 - 2 + t % S::W2;
      const bool in =
          t < S::P2 && y >= 0 && y <= ylim && z >= 0 && z <= zlim;
      const int cz = tf::clamp_interior(z, n);
      off[l] = in ? y * N + z : -1;
      coff[l] = tf::clamp_interior(y, n) * N + cz;
      zsign[l] = cz != z ? -1.0f : 1.0f;
    }
    ty = threadIdx.x / S::TZ;
    tz = threadIdx.x % S::TZ;
    cj = b.y0 + ty;
    ck = b.z0 + tz;
  }

  // plane p of u, v (raw) and of w, dens, temp (at the clamped row with
  // buoyancy) into registers
  __device__ __forceinline__ void load(int p) {
    const int cp = min(max(tf::clamp_interior(pl.gx0 + p, n) - pl.gx0, 0),
                       pl.rows - 1);
#pragma unroll
    for (int l = 0; l < S::LOADS; ++l) {
      if (off[l] < 0) continue;
      ru[l] = __ldg(u + p * NN + off[l]);
      rv[l] = __ldg(v + p * NN + off[l]);
      if (BUOY) {
        const int c = cp * NN + coff[l];
        rw[l] = __ldg(w + c);
        rd[l] = __ldg(dens + c);
        rt[l] = __ldg(temp + c);
      } else {
        rw[l] = __ldg(w + p * NN + off[l]);
      }
    }
  }

  // plane p is one the block stages
  __device__ __forceinline__ bool staged(int p) const {
    return p <= b.s1 + 2 && p <= pl.rows - 1;
  }

  __device__ __forceinline__ float* plane(int p) const {
    return ring + tf::slot_of<S::RING>(p) * 3 * S::P2;
  }

  __device__ __forceinline__ float* mag(int p) const {
    return mags + (p & (S::MRING - 1)) * S::P1;
  }

  // the registers into plane p's slot, w' computed
  __device__ __forceinline__ void store(int p) {
    float* const at = plane(p);
#pragma unroll
    for (int l = 0; l < S::LOADS; ++l) {
      if (off[l] < 0) continue;
      const int t = threadIdx.x + l * S::NT;
      at[t] = ru[l];
      at[S::P2 + t] = rv[l];
      at[2 * S::P2 + t] =
          BUOY ? zsign[l] * tf::buoyant_value(rw[l], rd[l], rt[l], bu)
               : rw[l];
    }
  }

  // |curl| on plane p over the tile widened by 1: 0 off the interior
  __device__ __forceinline__ void curl_plane(int p) {
    const bool inter = p >= 1 && p <= pl.rows - 2 && pl.gx0 + p >= 1 &&
                       pl.gx0 + p <= n;
    const float* const pc = plane(p);
    const float* const pm = plane(p - 1);
    const float* const pp = plane(p + 1);
    float* const dst = mag(p);
#pragma unroll
    for (int s = 0; s < S::MAGS; ++s) {
      const int t = threadIdx.x + s * S::NT;
      if (t >= S::P1) break;
      const int my = t / S::W1, mz = t % S::W1;
      const int y = b.y0 - 1 + my, z = b.z0 - 1 + mz;
      float mg = 0.0f;
      if (inter && y >= 1 && y <= n && z >= 1 && z <= n) {
        const int a = (my + 1) * S::W2 + mz + 1;
        const float* const pv = pc + S::P2;
        const float* const pw = pc + 2 * S::P2;
        float cx, cy, cz;
        tf::curl_of(pc[a + S::W2], pc[a - S::W2], pc[a + 1], pc[a - 1],
                    pv[a + 1], pv[a - 1], pp[S::P2 + a], pm[S::P2 + a],
                    pw[a + S::W2], pw[a - S::W2], pp[2 * S::P2 + a],
                    pm[2 * S::P2 + a], inv_h, cx, cy, cz);
        mg = tf::curl_mag(cx, cy, cz);
      }
      dst[t] = mg;
    }
  }

  // a row has a stencil: half B reads half A's w' there, 0 elsewhere
  __device__ __forceinline__ bool has_stencil(int r) const {
    const int c = tf::clamp_interior(pl.gx0 + r, n) - pl.gx0;
    return c >= 1 && c <= pl.rows - 2;
  }

  // the thread's confined cell of centre row x into every output cell
  // that clamps to it
  __device__ __forceinline__ void centre(int x, float* uo, float* vo,
                                         float* wo) {
    const float* const pc = plane(x);
    const float* const pm = plane(x - 1);
    const float* const pp = plane(x + 1);
    const float* const mc = mag(x);
    const float* const mm = mag(x - 1);
    const float* const mp = mag(x + 1);
    const bool w_xp = !BUOY || has_stencil(x + 1);
    const bool w_xm = !BUOY || has_stencil(x - 1);
    const float* const pv = pc + S::P2;
    const float* const pw = pc + 2 * S::P2;
    const int a = (ty + 2) * S::W2 + tz + 2;
    const int a1 = (ty + 1) * S::W1 + tz + 1;
    float cx, cy, cz;
    PutCell put{uo, vo, wo, 0.0f, 0.0f, 0.0f};
    tf::curl_of(pc[a + S::W2], pc[a - S::W2], pc[a + 1], pc[a - 1],
                pv[a + 1], pv[a - 1], pp[S::P2 + a], pm[S::P2 + a],
                pw[a + S::W2], pw[a - S::W2],
                w_xp ? pp[2 * S::P2 + a] : 0.0f,
                w_xm ? pm[2 * S::P2 + a] : 0.0f, inv_h, cx, cy, cz);
    tf::confine(pc[a], pv[a], pw[a], cx, cy, cz, mp[a1], mm[a1],
                mc[a1 + S::W1], mc[a1 - S::W1], mc[a1 + 1], mc[a1 - 1],
                bu.dt, eps_h, inv_h, put.fu, put.fv, put.fw);
    tf::for_outputs(x, cj, ck, n, pl, put);
  }
};

template <bool BUOY, class S>
__global__ void __launch_bounds__(S::NT, S::MINB) forcing_march_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ dens,
    const float* __restrict__ temp, float* __restrict__ uo,
    float* __restrict__ vo, float* __restrict__ wo, int n, tf::Buoyancy bu,
    float eps_h, float inv_h, tf::Place pl, tf::March m) {
  extern __shared__ __align__(16) float smem[];
  const tf::BlockPart b = tf::block_part<S::TY, S::TZ>(m, n);
  tf::zero_rows<S::NT>(m, n, pl, b, ZeroCell{uo, vo, wo});
  if (b.s0 > b.s1) return;
  Marcher<BUOY, S> t(u, v, w, dens, temp, n, bu, eps_h, inv_h, pl, b, smem);
  for (int p = b.s0 - 2; p <= b.s0 + 2; ++p)
    if (p >= 0 && p <= pl.rows - 1) {
      t.load(p);
      t.store(p);
    }
  __syncthreads();
  t.curl_plane(b.s0 - 1);
  t.curl_plane(b.s0);
  for (int x = b.s0; x <= b.s1; ++x) {
    const bool next = t.staged(x + 3);
    if (next) t.load(x + 3);
    t.curl_plane(x + 1);
    if (next) t.store(x + 3);
    __syncthreads();
    if (t.cj <= b.y1 && t.ck <= b.z1) t.centre(x, uo, vo, wo);
  }
}

// Buoyancy alone: w' at every output cell, one thread a cell.
__global__ void buoyancy_kernel(const float* __restrict__ w,
                                const float* __restrict__ dens,
                                const float* __restrict__ temp,
                                float* __restrict__ w_out, int n,
                                tf::Buoyancy b, tf::Place pl) {
  tf::forcing_a_cell(blockIdx.x * blockDim.x + threadIdx.x, nullptr, nullptr,
                     w, dens, temp, w_out, nullptr, n, 1, 0, b, 0.0f, pl);
}

template <class S>
int forcing(const float* u, const float* v, const float* w,
            const float* dens, const float* temp, float* uo, float* vo,
            float* wo, int n, tf::Place pl, int buoy, tf::Buoyancy bu,
            float eps_h, float inv_h, cudaStream_t st) {
  const tf::March m = tf::march_of(n, pl, S::TY, S::TZ, S::SEG);
  auto kern = buoy ? forcing_march_kernel<true, S>
                   : forcing_march_kernel<false, S>;
  if (S::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<m.blocks, S::NT, S::SMEM, st>>>(u, v, w, dens, temp, uo, vo, wo, n,
                                         bu, eps_h, inv_h, pl, m);
  return tf::launch_status();
}

}  // namespace

// One launch.  With ``vort``: the confined u, v, w into uo, vo, wo, from
// w' (``buoy``) or w; without: w' into wo (uo, vo unused).  An x-slab of
// ``rows`` rows at global row ``gx0`` (grid_common.cuh) or a cubic field
// ({n + 2, 0}).
extern "C" int tf_forcing3d(const float* u, const float* v, const float* w,
                            const float* dens, const float* temp, float* uo,
                            float* vo, float* wo, int n, int rows, int gx0,
                            int buoy, int vort, float dt, float alpha,
                            float beta, float t_amb, float eps_h, float inv_h,
                            void* stream) {
  const tf::Place pl{rows, gx0};
  const tf::Buoyancy bu{dt, alpha, beta, t_amb};
  cudaStream_t st = (cudaStream_t)stream;
  if (vort)
    return forcing<Shipped>(u, v, w, dens, temp, uo, vo, wo, n, pl, buoy, bu,
                            eps_h, inv_h, st);
  if (!buoy) return (int)cudaErrorInvalidValue;
  buoyancy_kernel<<<tf::blocks_for(n, pl), tf::kThreads, 0, st>>>(
      w, dens, temp, wo, n, bu, pl);
  return tf::launch_status();
}

// The compiled shape: TY, TZ, cells a thread (1), SEG, threads and shared
// memory a block.
extern "C" void tf_forcing3d_shape(int* out) {
  using S = Shipped;
  const int shape[6] = {S::TY, S::TZ, 1, S::SEG, S::NT, S::SMEM};
  for (int i = 0; i < 6; ++i) out[i] = shape[i];
}
