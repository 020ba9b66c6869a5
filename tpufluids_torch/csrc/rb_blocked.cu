// The temporally blocked red-black pass: H <= K red-black half-sweeps of
// (x0 + a * sum of the six neighbours) / c in one launch, on a cubic
// (n+2)^3 field or on a deep-padded x-slab of the sharded step.  The
// route of both float32 red-black solves and of the bfloat16 one.
//
// Replaces (tpufluids/grid/pallas_kernels.py):
//   lin_solve3d_rb_packed / _solve_rb_packed_*_kernel   (the dense solve)
//   lin_solve3d_rb_shard / _solve_rb_shard_kernel       (the slab passes)
//   lin_solve3d_pallas(red_black=True, dtype=bfloat16) / _solve_kernel
//                                          (the streamed bfloat16 solve)
// all through tf_rb_blocked_pass; the dense solves end with tf_rb_ghosts
// (jacobi.cu), the slab solve with tf_rb_shard_finish (jacobi_shard.cu).
//
// What bounds it on the H100.  A half-sweep does 8 flops a cell and has
// to see x and x0.  At one device-memory pass per half-sweep that is 3
// fields, 12 B a cell, per half-sweep.  Here a pass reads x and x0 once,
// each with its halo, and writes the result once, for H half-sweeps:
// (2 * halo overhead + 1) / H field passes a half-sweep.  With the bytes
// cut that far the pass is bound by the multiprocessor's work a level:
// each level is a barrier-separated phase of shared-memory stencil work
// whose cost is the latency of its shared loads and stores and of the
// barrier, not its arithmetic (without the arithmetic a level of the
// 256^3 pass still cost 0.038 of 0.041 ms; bf16x2 halving it did not move
// the level either) nor its instruction count (four cells a slot, a
// 16-byte word, cost 0.046-0.049 ms a level where pairs cost 0.040: half
// the warps hide less latency).  What pays is more warps a barrier, fewer
// barriers and device loads long in flight: a 32 x 64 tile with 768
// threads, one block a multiprocessor (not 16 x 64 with 512, two), no
// barrier after a step's last level, the pass compiled for its
// half-sweep count H (tf_rb_blocked_pass picks the instance by h), a
// plane's loads all issued as the plane before leaves the registers, and
// each slot's x + 1 neighbours taken from the level before, in
// registers.  A pass of 4 half-sweeps at 256^3 then takes 0.194 ms
// against 0.227, a level 0.034-0.037 ms against 0.040 (PERF.md, with the
// probe's other tiles, threads, slots, K and staging).  Where the grid is
// too small for the large tile to fill the card (n <= 64), a pass is the
// latency of one block's steps, and a 16 x 32 tile of 256 threads takes
// it from 0.0145 to 0.0083 ms at 32^3 and from 0.0151 to 0.0138 at 64^3
// (2 iterations).  A wavefront skewed by two planes a level needs one
// barrier a step, not K, but a ring of 2K + 3 planes, and its device
// loads then wait: it was no faster.
//
// Design.  A block owns a (y, z) tile of TY x TZ cells and a chunk of x
// rows [c0, c1), and streams along x.  Its shared memory holds a ring of
// K + 4 planes of x and of x0, each the tile with a K-deep y/z halo
// (zeros outside the array).  At streaming step s, plane s + 2 is stored
// from registers into the ring and plane s + 3 is read from device
// memory into the same registers; a barrier publishes plane s + 1 (and
// plane s - H, final at the step before, goes to dst if the chunk owns
// it); then level h = 0 .. H-1 updates plane s - h in place, with a
// barrier after each level but the last.  The levels of the last step
// read plane s_end + 1 at most, yet the last two steps fetch planes
// s_end + 2 and s_end + 3 (those inside the array), about 3% of a pass's
// bytes at 256^3 (kernels.RbChunks.rows; chip_smoke.py counts these
// planes).
//
// Why in place is right.  Level h updates the cells of parity p_h =
// parity + h and reads only cells of parity 1 - p_h (its six neighbours;
// the cell itself for a ghost tap), which must hold their level h-1
// values.  In plane q = s - h those were written by level h-1 at step
// s-1, and level h+1 reaches plane q only at step s+1.  Plane q+1's were
// written by level h-1 earlier in this step (plane s - h + 1), and plane
// q-1's by level h-1 at step s-2, while level h+1 rewrites them only after
// level h in this step.  So no second buffer is needed inside the ring.
// Without a barrier after the last level a warp may store plane s + 3 at
// step s + 1 while a slower one still reads planes s - H .. s - H + 2 (and
// stores plane s - H) at step s: plane s + 3 takes the ring slot of plane
// s - K - 1, so the ring holds K + 4 planes.
//
// The halo cone.  Level h updates the tile widened by e = H-1-h cells in
// y and z, and the chunk widened by e rows, clipped to the cells a
// half-sweep updates (interior J, K; rows 1 .. rows-2 whose global row is
// interior).  Each level reads one cell further out than it writes, so
// the K-deep halo feeds level 0 and the tile and chunk come out exact.
// Chunks read H extra rows each side.  Blocks read their neighbours' tiles
// from device memory, so a pass reads one buffer and writes another; the
// caller alternates them.  Rows outside [r_lo, r_hi] and ghost cells of
// dst are not written: no later half-sweep reads them (the dense ghost
// pass and the slab's exchange rewrite them).
//
// Per cell the arithmetic is tf::cell_update's, with the ghost rule of
// the streamed kernels: on the solve's first half-sweep (level 0 of the
// first pass) the stored neighbours, ghosts included, or zeros for a zero
// guess; afterwards a tap across a domain face is the cell's own value
// times the face's set_bnd sign.  So a pass equals H launches of the
// streamed half-sweep bit for bit.
//
// Layout.  A ring plane is two colour arrays: halo cell (jy, kz) lies in
// array (jy + kz) & 1 at (jy, kz / 2), the packed checkerboard of the TPU
// kernel.  A level's active cells are one array, their y and z neighbours
// the other, their x neighbours the same array of the planes beside: a
// warp reads consecutive words, with no bank conflict, and the second
// array starts 16 banks on so that storing a plane has none either.  A
// thread owns slots of two neighbouring active cells, read and written as
// one float2 or __nv_bfloat162 and updated together (tf::Pair); which of
// a slot's cells lie in each level's cone, and whether it may touch a
// face, is worked out once per launch.  A slot's x + 1 neighbours at
// level h are its own cells on plane q + 1, which this thread updated at
// level h-1 earlier in the step (unless q is the last row): they come
// from registers, not from the ring.
//
// Loads go through registers (__ldg, then a store into the ring), not
// cp.async or TMA: a row of n + 2 floats starts 16-byte aligned only when
// n + 2 is a multiple of 4, which TMA needs of every stride, and a 4-byte
// cp.async per cell was no faster.
//
// Storage.  The kernel is compiled for float and for __nv_bfloat16 (the
// reference's bfloat16 solve): two Tiles for float (by n), one for
// bfloat16.  In bfloat16 a slot is
// one 4-byte word, so a warp's slots are 32 consecutive banks; a level
// does each of its 8 operations as one bf16x2 instruction for two cells
// (tf::cell_update on __nv_bfloat162), rounded as the plain version
// rounds; of a slot's two z taps one is a word and the other straddles
// two words (a byte permute).  A ring plane takes half the float32
// bytes, and the bfloat16 tile spends them on more rows (48 x 64, 1024
// threads, one block a multiprocessor): the schedule, the chunks and the
// halo cone are the float32 ones.
#include "jacobi.cuh"

namespace {

template <int K_, int TY_, int TZ_, int NT_, typename T_>
struct Tile {
  using T = T_;  // the storage type
  static constexpr int K = K_, TY = TY_, TZ = TZ_;
  static constexpr int NT = NT_;  // threads a block
  static constexpr int W = TZ + 2 * K;  // a halo row's cells (even)
  static constexpr int HW = W / 2;      // ... of one colour
  static constexpr int ROWS = TY + 2 * K;
  static constexpr int EPW = 4 / (int)sizeof(T);  // cells a 4-byte bank
  // a plane is two colour arrays (ROWS, HW), the second 16 banks on
  static constexpr int CS =
      ((ROWS * HW / EPW + 16 + 31) / 32 * 32 - 16) * EPW;
  static constexpr int PLANE = 2 * CS;
  // planes in the ring: at step s, s - K .. s + 1 being updated, read or
  // written out, s + 2 going in, and s - K - 1, which a warp still on the
  // step before may read (no barrier follows a step's last level)
  static constexpr int RING = K + 4;
  static constexpr int SMEM = 2 * RING * PLANE * (int)sizeof(T);
  // a slot (two cells) and the y neighbours' slots are whole words
  static_assert(HW % 2 == 0 && ROWS * HW % EPW == 0, "pairs straddle words");
  // per thread: the slots of two cells of one colour it updates, the
  // cells it loads
  static constexpr int SLOTS = (ROWS * HW / 2 + NT - 1) / NT;
  static constexpr int LOADS = (ROWS * W + NT - 1) / NT;
  // resident blocks a multiprocessor the registers must allow: as many
  // as 1024 threads, or the shared memory (227 KB), allow
  static constexpr int MIN_BLOCKS =
      1024 / NT < 232448 / SMEM ? 1024 / NT : 232448 / SMEM;
};

template <typename T>
struct PassArgs {
  const T* src;  // NULL: a zero guess (first pass only)
  const T* x0;
  T* dst;
  int rows, gx0, n, r_lo, r_hi, chunk, parity, first;
  float sx, sy, sz, a, c_inv;
};

// (r + d) mod RING for a ring slot r and |d| <= RING.
template <class Tl>
__device__ __forceinline__ int ring(int r, int d) {
  const int v = r + d;
  return v >= Tl::RING ? v - Tl::RING : v < 0 ? v + Tl::RING : v;
}

// Halo cell (jy, kz) of a plane lives in colour array (jy + kz) & 1 at
// (jy, kz / 2).
template <class Tl>
__device__ __forceinline__ int packed(int jy, int kz) {
  return ((jy + kz) & 1) * Tl::CS + jy * Tl::HW + (kz >> 1);
}

// What a thread does in every plane, fixed for the launch.  Loads: the
// cells j * (n+2) + k it reads (-1 outside the array) and their packed
// places (-1 past the plane).  Slots: two neighbouring cells (jy, m) and
// (jy, m + 1) of one colour array, m even, at c = jy * HW + m; which of
// the two lie in level h's cone when the active colour is ``act`` is bit
// pair (act * K + h) of ``cone``, bit FACE marks a slot that may hold a
// cell on a y or z face of the grid, and bit ROW is jy's parity (one
// word a slot: registers are what the tile's size is bound by).
template <class Tl>
struct Lanes {
  static constexpr int FACE = 30, ROW = 31;
  static_assert(4 * Tl::K <= FACE, "cone bits overlap the flags");
  int load[Tl::LOADS], place[Tl::LOADS];
  int c[Tl::SLOTS];
  unsigned cone[Tl::SLOTS];

  __device__ Lanes(int n, int H, int ty0, int tz0) {
    const int N = n + 2;
    const int ys = ty0 - Tl::K, zs = tz0 - Tl::K;
#pragma unroll
    for (int i = 0; i < Tl::LOADS; ++i) {
      const int idx = threadIdx.x + i * Tl::NT;
      const int jy = idx / Tl::W, kz = idx % Tl::W;
      const int J = ys + jy, Kc = zs + kz;
      const bool in_plane = idx < Tl::ROWS * Tl::W;
      load[i] = in_plane && J >= 0 && J < N && Kc >= 0 && Kc < N
                    ? J * N + Kc
                    : -1;
      place[i] = in_plane ? packed<Tl>(jy, kz) : -1;
    }
#pragma unroll
    for (int i = 0; i < Tl::SLOTS; ++i) {
      const int t = threadIdx.x + i * Tl::NT;
      const bool in_plane = t < Tl::ROWS * Tl::HW / 2;
      const int row = in_plane ? t / (Tl::HW / 2) : 0;
      const int m = 2 * (t % (Tl::HW / 2));
      c[i] = row * Tl::HW + m;
      unsigned bits = 0;
      for (int act = 0; act < 2; ++act) {
        const int kz = 2 * m + ((act + row) & 1);
        for (int h = 0; h < H; ++h) {
          const int e = H - 1 - h;
          const int jlo = max(1, ty0 - e) - ys;
          const int jhi = min(n, ty0 + Tl::TY - 1 + e) - ys;
          const int zlo = max(1, tz0 - e) - zs;
          const int zhi = min(n, tz0 + Tl::TZ - 1 + e) - zs;
          const bool rok = in_plane && row >= jlo && row <= jhi;
          const unsigned ok0 = rok && kz >= zlo && kz <= zhi;
          const unsigned ok1 = rok && kz + 2 >= zlo && kz + 2 <= zhi;
          bits |= (ok0 | ok1 << 1) << 2 * (act * Tl::K + h);
        }
      }
      const int J = ys + row, K0 = zs + 2 * m;
      const bool face = J == 1 || J == n || (K0 <= 1 && K0 + 3 >= 1) ||
                        (K0 <= n && K0 + 3 >= n);
      cone[i] = bits | (unsigned)face << FACE | (unsigned)(row & 1) << ROW;
    }
  }
};

// A plane of x and x0 on its way from device memory, in registers.
template <class Tl>
struct Staged {
  typename Tl::T x[Tl::LOADS], x0[Tl::LOADS];
};

// Reads this thread's share of plane q of x and x0 (the tile and its
// halo; zeros outside the array) into registers.
template <class Tl>
__device__ __forceinline__ void fetch_plane(Staged<Tl>& r,
                                            const PassArgs<typename Tl::T>& g,
                                            const Lanes<Tl>& L, int q) {
  using T = typename Tl::T;
  const T zero = tf::Store<T>::round(0.0f);
  const int N = g.n + 2;
  const bool in = q < g.rows;
  const T* xq = g.src ? g.src + (size_t)q * N * N : nullptr;
  const T* x0q = g.x0 + (size_t)q * N * N;
#pragma unroll
  for (int i = 0; i < Tl::LOADS; ++i) {
    const int off = L.load[i];
    const bool ok = in && off >= 0;
    r.x[i] = ok && xq ? __ldg(xq + off) : zero;
    r.x0[i] = ok ? __ldg(x0q + off) : zero;
  }
}

// Stores a fetched plane into ring slot ``at``, in the packed layout.
template <class Tl>
__device__ __forceinline__ void put_plane(typename Tl::T* xr,
                                          typename Tl::T* x0r,
                                          const Staged<Tl>& r,
                                          const Lanes<Tl>& L, int at) {
  typename Tl::T* xs = xr + at * Tl::PLANE;
  typename Tl::T* x0s = x0r + at * Tl::PLANE;
#pragma unroll
  for (int i = 0; i < Tl::LOADS; ++i) {
    const int p = L.place[i];
    if (p >= 0) {
      xs[p] = r.x[i];
      x0s[p] = r.x0[i];
    }
  }
}

// Level h on plane q (x in ring slot ``at``, its x neighbours in the
// slots around it): the cells of colour ``act`` inside the cone, in
// place.  Their neighbours in y and z are in the other colour array, in x
// in the same array of planes q - 1 and q + 1: a warp reads consecutive
// words of each.  A slot is two cells, read and written as one word
// (float2, or __nv_bfloat162) and updated by the paired cell_update; a
// slot with no cell on a face of the grid (nearly all) takes no ghost
// select.  ``last`` holds each slot's result of the level before, on
// plane q + 1: its x + 1 neighbours where ``chained``; the level leaves
// its own there.
template <class Tl>
__device__ __forceinline__ void update_plane(
    typename Tl::T* xr, const typename Tl::T* x0r,
    const PassArgs<typename Tl::T>& g, const Lanes<Tl>& L,
    typename tf::Pair<typename Tl::T>::V (&last)[Tl::SLOTS], bool chained,
    int h, int q, int at, int act, bool first, int ys, int zs) {
  using T = typename Tl::T;
  using P = tf::Pair<T>;
  using V = typename P::V;
  constexpr int HW = Tl::HW;
  const int n = g.n, I = g.gx0 + q;
  T* A = xr + at * Tl::PLANE + act * Tl::CS;  // the active cells
  const T* B = xr + at * Tl::PLANE + (1 - act) * Tl::CS;
  const T* Am = xr + ring<Tl>(at, -1) * Tl::PLANE + act * Tl::CS;
  const T* Ap = xr + ring<Tl>(at, 1) * Tl::PLANE + act * Tl::CS;
  const T* X0 = x0r + at * Tl::PLANE + act * Tl::CS;
  const bool xface = I == 1 || I == n;
  const int shift = 2 * (act * Tl::K + h);
#pragma unroll
  for (int i = 0; i < Tl::SLOTS; ++i) {
    const unsigned ok = L.cone[i] >> shift & 3u;
    if (!ok) continue;
    const int c = L.c[i];
    // cell (jy, m) has kz = 2 m + b
    const int b = (act + (L.cone[i] >> Lanes<Tl>::ROW)) & 1;
    const V x0c = P::load(X0 + c);
    const V xm = P::load(Am + c);
    const V xp = chained ? last[i] : P::load(Ap + c);
    const V ym = P::load(B + c - HW), yp = P::load(B + c + HW);
    // the z neighbours B[c - 1 + b], B[c + b] (shared) and B[c + 1 + b]
    V zm, zp;
    P::z_taps(B, c - 1 + b, zm, zp);
    V v;
    if (first || !(xface || (L.cone[i] >> Lanes<Tl>::FACE & 1u))) {
      v = tf::cell_update(x0c, xm, xp, ym, yp, zm, zp, g.a, g.c_inv);
    } else {
      // a tap across a face: the cell's own value times the face's sign
      const V own = P::load(A + c);
      const int J = c / HW + ys, K0 = 2 * (c % HW) + b + zs, K1 = K0 + 2;
      v = tf::cell_update(x0c, P::tap(xm, own, g.sx, I == 1, I == 1),
                          P::tap(xp, own, g.sx, I == n, I == n),
                          P::tap(ym, own, g.sy, J == 1, J == 1),
                          P::tap(yp, own, g.sy, J == n, J == n),
                          P::tap(zm, own, g.sz, K0 == 1, K1 == 1),
                          P::tap(zp, own, g.sz, K0 == n, K1 == n), g.a,
                          g.c_inv);
    }
    last[i] = v;
    if (ok == 3u)
      P::store(A + c, v);
    else if (ok == 1u)
      A[c] = P::lo(v);
    else
      A[c + 1] = P::hi(v);
  }
}

// The tile cells of the plane in ring slot ``at``, global row q, to dst.
template <class Tl>
__device__ __forceinline__ void store_plane(const typename Tl::T* xr,
                                            const PassArgs<typename Tl::T>& g,
                                            int q, int at, int ty0, int tz0) {
  const int N = g.n + 2;
  const typename Tl::T* P = xr + at * Tl::PLANE;
  typename Tl::T* dq = g.dst + (size_t)q * N * N;
  for (int i = threadIdx.x; i < Tl::TY * Tl::TZ; i += Tl::NT) {
    const int jy = i / Tl::TZ, kz = i % Tl::TZ;
    const int J = ty0 + jy, Kc = tz0 + kz;
    if (J <= g.n && Kc <= g.n)
      dq[J * N + Kc] = P[packed<Tl>(jy + Tl::K, kz + Tl::K)];
  }
}

// A pass of H half-sweeps, compiled for that count.
template <class Tl, int H>
__global__ void __launch_bounds__(Tl::NT, Tl::MIN_BLOCKS)
    rb_blocked_kernel(const PassArgs<typename Tl::T> g) {
  using T = typename Tl::T;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xr = reinterpret_cast<T*>(smem);
  T* x0r = xr + Tl::RING * Tl::PLANE;
  const int ty0 = 1 + blockIdx.y * Tl::TY, tz0 = 1 + blockIdx.x * Tl::TZ;
  const int ys = ty0 - Tl::K, zs = tz0 - Tl::K;  // halo cell (0, 0)
  const int c0 = g.r_lo + blockIdx.z * g.chunk;
  const int c1 = min(c0 + g.chunk, g.r_hi + 1);
  const int s0 = max(c0 - (H - 1), g.r_lo);
  // level h updates plane s - h at step s; plane s - (H-1) is then final
  const int s_end = c1 + H - 2;
  const Lanes<Tl> L(g.n, H, ty0, tz0);
  // planes s0 - 1 .. s0 + 1 in ring slots 0 .. 2, s0 + 2 in registers
  Staged<Tl> next;
  for (int i = 0; i < 3; ++i) {
    fetch_plane<Tl>(next, g, L, s0 - 1 + i);
    put_plane<Tl>(xr, x0r, next, L, i);
  }
  fetch_plane<Tl>(next, g, L, s0 + 2);
  // each slot's cells as the level before left them on plane s - h + 1
  typename tf::Pair<T>::V last[Tl::SLOTS];
  int at = 1;  // plane s's ring slot
  for (int s = s0; s <= s_end; ++s, at = ring<Tl>(at, 1)) {
    // plane s + 2 goes in (no level of this step reads it), and plane
    // s + 3 comes into the registers it left, all of its loads in flight
    // while the block waits at the barrier and runs the levels; the
    // barrier publishes plane s + 1, and plane s - H, final at the step
    // before, which goes to dst now
    put_plane<Tl>(xr, x0r, next, L, ring<Tl>(at, 2));
    fetch_plane<Tl>(next, g, L, s + 3);
    __syncthreads();
    if (s - H >= c0) store_plane<Tl>(xr, g, s - H, ring<Tl>(at, -H), ty0, tz0);
    // level h updates parity parity + h on row gx0 + s - h: in halo
    // coordinates one colour for every level of the step
    const int act = (g.parity + g.gx0 + s + ys + zs + 1) & 1;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int q = s - h, e = H - 1 - h;
      // level h-1 updated plane q + 1 in this step unless q is the last
      // row (then plane q + 1 is the input's)
      if (q >= max(c0 - e, g.r_lo) && q <= min(c1 - 1 + e, g.r_hi))
        update_plane<Tl>(xr, x0r, g, L, last, h > 0 && q < g.r_hi, h, q,
                         ring<Tl>(at, -h), act, g.first && h == 0, ys, zs);
      // the next step's first barrier follows the last level
      if (h < H - 1) __syncthreads();
    }
  }
  __syncthreads();
  if (s_end - (H - 1) >= c0)
    store_plane<Tl>(xr, g, s_end - (H - 1), ring<Tl>(at, -H), ty0, tz0);
}

using bf16 = __nv_bfloat16;

// The compiled shapes of each storage type (kernels.RB_TILE,
// RB_TILE_SMALL and RB_TILE_BF16 name them to the Python side): the
// fastest of the probe's shapes at 256^3 in float32 and at 512^3 in
// bfloat16, each one block a multiprocessor with no spill, and for
// float32 fields of n <= SMALL_N (multigrid's coarse levels, the 64^3
// plume) a 16 x 32 tile of 256 threads, three blocks a multiprocessor:
// there the large tile leaves most multiprocessors idle and a pass is
// the latency of a block's steps, which a smaller block shortens
// (PERF.md).
template <typename T>
struct ShapeOf {
  using type = Tile<4, 32, 64, 768, float>;
  using small = Tile<4, 16, 32, 256, float>;
};
template <>
struct ShapeOf<bf16> {
  using type = Tile<4, 48, 64, 1024, bf16>;
  using small = type;
};
template <typename T>
using Shape = typename ShapeOf<T>::type;
template <typename T>
using SmallShape = typename ShapeOf<T>::small;
constexpr int SMALL_N = 64;  // kernels.RB_SMALL_N

// The instances of H = 1 .. K half-sweeps: each sets its shared-memory
// attribute (allow_smem), or the one of ``h`` launches (launch_levels).
template <class Tl, int H = 1>
cudaError_t allow_smem() {
  if constexpr (H > Tl::K) {
    return cudaSuccess;
  } else {
    const cudaError_t e = cudaFuncSetAttribute(
        rb_blocked_kernel<Tl, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tl::SMEM);
    return e != cudaSuccess ? e : allow_smem<Tl, H + 1>();
  }
}

template <class Tl, int H = 1>
int launch_levels(int h, dim3 grid, const PassArgs<typename Tl::T>& g,
                  cudaStream_t stream) {
  if constexpr (H > Tl::K) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (h != H) return launch_levels<Tl, H + 1>(h, grid, g, stream);
    rb_blocked_kernel<Tl, H><<<grid, Tl::NT, Tl::SMEM, stream>>>(g);
    return tf::launch_status();
  }
}

template <class Tl>
int pass_of(const void* src, const void* x0, void* dst, int rows, int gx0,
            int n, int r_lo, int r_hi, int chunk, int chunks, int h,
            int parity, int first, int b, float a, float c_inv,
            cudaStream_t stream) {
  using T = typename Tl::T;
  if (h < 1 || h > Tl::K || chunks < 1 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const tf::Signs s = tf::signs_for(b);
  const PassArgs<T> g{(const T*)src, (const T*)x0, (T*)dst, rows, gx0, n,
                      r_lo, r_hi, chunk, parity, first, s.x, s.y, s.z, a,
                      c_inv};
  const dim3 grid((n + Tl::TZ - 1) / Tl::TZ, (n + Tl::TY - 1) / Tl::TY,
                  chunks);
  return launch_levels<Tl>(h, grid, g, stream);
}

template <typename T>
int blocked_pass(const void* src, const void* x0, void* dst, int rows,
                 int gx0, int n, int r_lo, int r_hi, int chunk, int chunks,
                 int h, int parity, int first, int b, float a, float c_inv,
                 cudaStream_t stream) {
  return n <= SMALL_N
             ? pass_of<SmallShape<T>>(src, x0, dst, rows, gx0, n, r_lo,
                                      r_hi, chunk, chunks, h, parity, first,
                                      b, a, c_inv, stream)
             : pass_of<Shape<T>>(src, x0, dst, rows, gx0, n, r_lo, r_hi,
                                 chunk, chunks, h, parity, first, b, a,
                                 c_inv, stream);
}

template <class Tl>
int info_of(int* slots, int* smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = allow_smem<Tl>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rb_blocked_kernel<Tl, Tl::K>, Tl::NT, Tl::SMEM);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *slots = sms * per_sm;
  *smem = Tl::SMEM;
  return 0;
}

template <typename T>
int blocked_info(int n, int* slots, int* smem) {
  return n <= SMALL_N ? info_of<SmallShape<T>>(slots, smem)
                      : info_of<Shape<T>>(slots, smem);
}

}  // namespace

// One pass of ``h`` half-sweeps, parities parity, parity + 1, ..., from
// src (NULL: zeros) into dst, over local rows r_lo .. r_hi of a (rows,
// n+2, n+2) field at global row gx0, in ``chunks`` x-chunks of ``chunk``
// rows; ``first``: the first half-sweep is the solve's first.  The fields
// hold float, or bfloat16 when ``bf16_storage``; the shape follows the
// storage type and n.  The shared-memory attribute it needs is set by
// tf_rb_blocked_info for the same storage type and n, which must have run
// on the device first (a launch without it is refused).
extern "C" int tf_rb_blocked_pass(const void* src, const void* x0,
                                  void* dst, int rows, int gx0, int n,
                                  int r_lo, int r_hi, int chunk, int chunks,
                                  int h, int parity, int first, int b,
                                  int bf16_storage, float a, float c_inv,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return bf16_storage
             ? blocked_pass<bf16>(src, x0, dst, rows, gx0, n, r_lo, r_hi,
                                  chunk, chunks, h, parity, first, b, a,
                                  c_inv, st)
             : blocked_pass<float>(src, x0, dst, rows, gx0, n, r_lo, r_hi,
                                   chunk, chunks, h, parity, first, b, a,
                                   c_inv, st);
}

// Sets the kernel's dynamic shared memory attribute on the current
// device for the shape of the storage type (bfloat16 when
// ``bf16_storage``) and n, on each of its instances; gives the blocks the
// card keeps resident at once and the dynamic shared memory of one.
extern "C" int tf_rb_blocked_info(int bf16_storage, int n, int* slots,
                                  int* smem) {
  return bf16_storage ? blocked_info<bf16>(n, slots, smem)
                      : blocked_info<float>(n, slots, smem);
}
