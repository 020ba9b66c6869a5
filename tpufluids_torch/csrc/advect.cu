// 27-tap stencil semi-Lagrangian advection of K fields by (u, v, w).
//
// Replaces advect3d_multi_pallas / _advect_kernel / _advect_stage
// (tpufluids/grid/pallas_kernels.py).  Like the TPU kernel it computes
// the per-cell backtrace weights once and applies them to all K fields
// (K = 3 for the velocity self-advection, 2 for dens/temp).  Unlike it,
// it reads the stored ghost cells of its inputs instead of rebuilding
// the z ghosts, so it reproduces the dense stam.advect3d_stencil.  On an
// x-slab of the sharded step (rows, gx0: grid_common.cuh) the x
// backtrace clamp and the x ghosts follow global rows, as
// advect3d_multi_pallas's gx0/gn do.
//
// What bounds it on the H100.  One pass over the fields: the K fields
// and the velocity in (the same three fields when a velocity advects
// itself) and K out, 6 field passes at K = 3 (0.123 ms at 256^3) and 7 at
// K = 2 (0.144 ms); and, with every tap a multiply and an add (-fmad=false),
// 27 (2 + 2K) + 51 operations a cell.  The design this replaces ran one
// thread a cell that loaded its 27 taps of each field from device memory,
// 27K + 3 loads a cell, and was bound by the load pipe, not by bytes.
//
// Design.  The x-march of stencil_march.cuh: a block owns a TY x TZ
// (y, z) tile and a segment of centre rows, and keeps a ring of 5
// x-planes of each of the K fields in shared memory, each the tile
// widened by one cell (the stencil's halo).  Planes come straight from
// device memory into their slot by cp.async, two steps ahead: at step x
// plane x + 3 goes in flight, plane x is computed from planes x - 1, x
// and x + 1, then the block waits for plane x + 2 and passes one barrier.
// So every input value is loaded from device memory once a block (its
// halo twice), and each tap is read from shared memory.  (TMA's tiled
// copies need 16-byte row strides; a row of n + 2 floats has one only
// when n + 2 is a multiple of 4.)  A thread owns two consecutive z-cells:
// a tap row of their 4 values is two 64-bit shared loads, shared by both
// (4 cells a thread took more registers and were slower).  The velocity is the centre plane of the ring when the fields
// are (u, v, w) themselves; otherwise it is read from device memory a
// step ahead.
//
// The shape, 8 x 64 cells, 2 a thread, segments of 8 rows, 80 registers
// (three blocks a multiprocessor), came from a one-time probe on the card
// (PERF.md).  It is bound by the multiprocessor's instruction rate, not by
// bytes: the planes alone stream in 0.09 ms at 256^3, and each tap costs
// a multiply for its weight and a multiply and an add a field, which
// -fmad=false keeps apart.
//
// The cell arithmetic is advect.cuh's (advect_hats, advect_tap), which the
// whole step of step.cu shares: each cell sums its taps in the order dx,
// dy, dz, so only where a tap's value comes from differs.
#include "advect.cuh"
#include "stencil_march.cuh"

namespace {

// A compiled shape: a TY x TZ tile, Z = 2 consecutive z-cells a thread, SEG
// centre rows a segment (kernels.ADVECT_TILE names it to the Python side:
// change both together), at most 65536 / (NT MINB) registers a thread.
// A plane row holds the tile's TZ + 2 cells from offset 0, in W floats,
// so a thread's tap row starts Z-aligned.
template <int TY_, int TZ_, int SEG_, int MINB_>
struct Shape {
  static constexpr int TY = TY_, TZ = TZ_, SEG = SEG_;
  static constexpr int Z = 2;
  static constexpr int MINB = MINB_;  // resident blocks the registers allow
  static constexpr int NT = TY * TZ / Z;
  static constexpr int H = TY + 2;
  static constexpr int W = (TZ + 2 + 3) / 4 * 4;
  static constexpr int PLANE = H * W;
  static constexpr int RING = 5;
  static constexpr int LOADS = (H * (TZ + 2) + NT - 1) / NT;
  template <int K>
  static constexpr int smem() {
    return RING * K * PLANE * 4;
  }
  static_assert(TZ % Z == 0, "a thread's cells tile the row");
};

using Shipped = Shape<8, 64, 8, 3>;

// The 4 values of a tap row of two cells from shared memory, p 8-byte
// aligned: two 64-bit loads.
__device__ __forceinline__ void tap_row(const float* p, float (&r)[4]) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  const float2 c = *reinterpret_cast<const float2*>(p + 2);
  r[0] = a.x;
  r[1] = a.y;
  r[2] = c.x;
  r[3] = c.y;
}

// The writes of a computed cell: every output cell that clamps to it,
// each field times its set_bnd sign (a functor, not a lambda, so that it
// is always inlined and the values stay in registers).
template <int K>
struct PutCell {
  const tf::AdvectFields& f;
  float val[K];
  __device__ __forceinline__ void operator()(int o, float sx, float sy,
                                             float sz) const {
#pragma unroll
    for (int q = 0; q < K; ++q)
      f.out[q][o] = tf::sign_of(f.bnd[q], sx, sy, sz) * val[q];
  }
};

template <int K>
struct ZeroCell {
  const tf::AdvectFields& f;
  __device__ __forceinline__ void operator()(int o) const {
#pragma unroll
    for (int q = 0; q < K; ++q) f.out[q][o] = 0.0f;
  }
};

// What a thread does in the march of one block.
template <int K, bool SELF, class S>
struct Marcher {
  const float *u, *v, *w;
  const tf::AdvectFields& f;
  const int n, N, NN;
  const float dt0;
  const tf::Place pl;
  const tf::BlockPart b;
  float* const ring;  // [RING][K][PLANE]
  // the staged cells of this thread: (y, z) offset (-1: not staged) and
  // place in a plane
  int src[S::LOADS], dst[S::LOADS];
  // this thread's cells: (cj, ck0 .. ck0 + Z - 1) at (ty, tz * Z) of the
  // tile; their velocity (not SELF)
  int ty, tz, cj, ck0;
  bool mine;
  float vel[3][S::Z];

  __device__ __forceinline__ Marcher(const float* u_, const float* v_,
                                   const float* w_,
                                   const tf::AdvectFields& f_, int n_,
                                   float dt0_, tf::Place pl_,
                                   const tf::BlockPart& b_, float* ring_)
      : u(u_), v(v_), w(w_), f(f_), n(n_), N(n_ + 2),
        NN((n_ + 2) * (n_ + 2)), dt0(dt0_), pl(pl_), b(b_), ring(ring_) {
#pragma unroll
    for (int l = 0; l < S::LOADS; ++l) {
      const int t = threadIdx.x + l * S::NT;
      const int ry = t / (S::TZ + 2), rz = t % (S::TZ + 2);
      const int y = b.y0 - 1 + ry, z = b.z0 - 1 + rz;
      src[l] = t < S::H * (S::TZ + 2) && y <= b.y1 + 1 && z <= b.z1 + 1
                   ? y * N + z
                   : -1;
      dst[l] = ry * S::W + rz;
    }
    constexpr int per_row = S::TZ / S::Z;
    ty = threadIdx.x / per_row;
    tz = threadIdx.x % per_row;
    cj = b.y0 + ty;
    ck0 = b.z0 + tz * S::Z;
    mine = cj <= b.y1;
  }

  // plane p straight into its slot, in flight until cp_async_wait
  __device__ __forceinline__ void copy(int p) {
    float* const at = ring + (p % S::RING) * K * S::PLANE;
#pragma unroll
    for (int q = 0; q < K; ++q)
#pragma unroll
      for (int l = 0; l < S::LOADS; ++l)
        if (src[l] >= 0)
          tf::cp_async4(at + q * S::PLANE + dst[l], f.in[q] + p * NN + src[l]);
  }

  __device__ __forceinline__ void load_vel(int p) {
    const float* const uvw[3] = {u, v, w};
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int z = 0; z < S::Z; ++z)
        if (mine && ck0 + z <= b.z1)
          vel[a][z] = __ldg(uvw[a] + p * NN + cj * N + ck0 + z);
  }

  // the thread's cells of centre row x, from ring planes x - 1 .. x + 1,
  // into every output cell that clamps to them
  __device__ __forceinline__ void centre(int x) {
    const float* const at = ring + (ty + 1) * S::W + tz * S::Z;
    float hat[S::Z][3][3];
#pragma unroll
    for (int z = 0; z < S::Z; ++z) {
      float ux, vy, wz;
      if (SELF) {
        const float* const c = at + (x % S::RING) * K * S::PLANE;
        ux = c[z + 1];
        vy = c[S::PLANE + z + 1];
        wz = c[2 * S::PLANE + z + 1];
      } else {
        ux = vel[0][z];
        vy = vel[1][z];
        wz = vel[2][z];
      }
      tf::advect_hats(ux, vy, wz, pl.gx0 + x, cj, ck0 + z, n, dt0, hat[z]);
    }
    if (!SELF && x < b.s1) load_vel(x + 1);
    float acc[K][S::Z];
#pragma unroll
    for (int q = 0; q < K; ++q)
#pragma unroll
      for (int z = 0; z < S::Z; ++z) acc[q][z] = 0.0f;
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const float* const pd = at + ((x + dx) % S::RING) * K * S::PLANE;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int q = 0; q < K; ++q) {
          float r[S::Z + 2];
          tap_row(pd + q * S::PLANE + dy * S::W, r);
#pragma unroll
          for (int z = 0; z < S::Z; ++z)
#pragma unroll
            for (int dz = -1; dz <= 1; ++dz)
              acc[q][z] =
                  tf::advect_tap(acc[q][z], hat[z], dx, dy, dz, r[z + 1 + dz]);
        }
    }
#pragma unroll
    for (int z = 0; z < S::Z; ++z) {
      if (ck0 + z > b.z1) break;
      PutCell<K> put{f, {}};
#pragma unroll
      for (int q = 0; q < K; ++q) put.val[q] = acc[q][z];
      tf::for_outputs(x, cj, ck0 + z, n, pl, put);
    }
  }
};

template <int K, bool SELF, class S>
__global__ void __launch_bounds__(S::NT, S::MINB) advect_march_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ w, const tf::AdvectFields f, int n,
    float dt0, tf::Place pl, tf::March m) {
  extern __shared__ __align__(16) float ring[];
  const tf::BlockPart b = tf::block_part<S::TY, S::TZ>(m, n);
  tf::zero_rows<S::NT>(m, n, pl, b, ZeroCell<K>{f});
  if (b.s0 > b.s1) return;
  Marcher<K, SELF, S> t(u, v, w, f, n, dt0, pl, b, ring);
  // planes s0 - 1 .. s0 + 1 land first; then at step x plane x + 3 goes in
  // flight and plane x + 2 lands
  for (int p = b.s0 - 1; p <= b.s0 + 1; ++p) t.copy(p);
  tf::cp_async_commit();
  if (b.s0 + 2 <= b.s1 + 1) t.copy(b.s0 + 2);
  tf::cp_async_commit();
  if (!SELF) t.load_vel(b.s0);
  tf::cp_async_wait<1>();
  __syncthreads();
  for (int x = b.s0; x <= b.s1; ++x) {
    if (x + 3 <= b.s1 + 1) t.copy(x + 3);
    tf::cp_async_commit();
    if (t.mine) t.centre(x);
    tf::cp_async_wait<1>();
    __syncthreads();
  }
}

template <int K, bool SELF, class S>
int launch(const float* u, const float* v, const float* w,
           const tf::AdvectFields& f, int n, float dt0, tf::Place pl,
           cudaStream_t st) {
  const tf::March m = tf::march_of(n, pl, S::TY, S::TZ, S::SEG);
  constexpr int smem = S::template smem<K>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        advect_march_kernel<K, SELF, S>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  advect_march_kernel<K, SELF, S>
      <<<m.blocks, S::NT, smem, st>>>(u, v, w, f, n, dt0, pl, m);
  return tf::launch_status();
}

template <class S>
int advect(const float* u, const float* v, const float* w,
           const tf::AdvectFields& f, int k, int n, float dt0, tf::Place pl,
           cudaStream_t st) {
  switch (k) {
    case 1: return launch<1, false, S>(u, v, w, f, n, dt0, pl, st);
    case 2: return launch<2, false, S>(u, v, w, f, n, dt0, pl, st);
    case 3:
      // a velocity advecting itself: the ring's centre plane is (u, v, w)
      if (f.in[0] == u && f.in[1] == v && f.in[2] == w)
        return launch<3, true, S>(u, v, w, f, n, dt0, pl, st);
      return launch<3, false, S>(u, v, w, f, n, dt0, pl, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int tf_advect3d(const float* u, const float* v, const float* w,
                           const float* q0, const float* q1, const float* q2,
                           float* o0, float* o1, float* o2, int k, int b0,
                           int b1, int b2, int n, int rows, int gx0,
                           float dt0, void* stream) {
  const tf::AdvectFields f{{q0, q1, q2}, {o0, o1, o2}, {b0, b1, b2}};
  return advect<Shipped>(u, v, w, f, k, n, dt0, tf::Place{rows, gx0},
                         (cudaStream_t)stream);
}

// The compiled shape: TY, TZ, Z, SEG, threads a block and shared memory a
// block at K = 3.
extern "C" void tf_advect3d_shape(int* out) {
  using S = Shipped;
  const int shape[6] = {S::TY, S::TZ, S::Z, S::SEG, S::NT, S::smem<3>()};
  for (int i = 0; i < 6; ++i) out[i] = shape[i];
}
