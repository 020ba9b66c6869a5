// The temporally blocked Jacobi pass in bfloat16: up to F Jacobi sweeps
// of (x0 + a * sum of the six neighbours) / c, each followed by
// set_bnd3d(b), in one launch on a cubic (n+2)^3 field; every operation
// rounds to bfloat16.
//
// Replaces (tpufluids/grid/pallas_kernels.py):
//   lin_solve3d_pallas(dtype=bfloat16) / _solve_kernel (Jacobi), which
//   the bfloat16 route calls with fuse = 2 (tpufluids/grid/stam.py:281):
//   two sweeps a pass through a VMEM window with a halo.  So F is 2 here;
//   a solve of an odd number of sweeps ends with a pass of one.
//
// What bounds it on the H100.  A sweep does 8 operations a cell and has
// to see x and x0: at one device-memory pass a sweep (the design this
// replaces) 6 B a cell a sweep, and that kernel, one thread a cell with
// an index decode and two conversions an operation, ran at 3.9x even
// that floor, bound by instruction issue.  Here a pass reads x and x0
// once, each with a halo of F cells, writes the result once, and does F
// sweeps in shared memory between; two cells go through each operation
// at once as bf16x2 (tf::cell_update on __nv_bfloat162).  Measured, the
// pass is then bound by the multiprocessor, as rb_blocked.cu's: each
// level costs about as much as the loads and stores of a step (PERF.md).
// Two sweeps a pass were faster than one pass a sweep, and than four.
//
// Design.  As rb_blocked.cu: a block owns a (y, z) tile of TY x TZ cells
// and a chunk of x rows [c0, c1), and streams along x.  At step s, plane
// s + 2 of x and x0 goes from registers into rings of F + 2 planes, a
// barrier publishes plane s + 1, and level h = 0 .. H-1 computes sweep h
// on plane s - h, a barrier after each level; plane s + 3 comes into
// registers a share at a time between the levels.  Jacobi is out of
// place: level h reads level h-1's planes q - 1, q and q + 1 and must not
// overwrite them, so every level below the last writes its own ring of
// three planes (the next level reads them one step later).  The cones are
// rb_blocked.cu's: level h computes the tile widened by H-1-h cells in y
// and z, and the chunk widened by H-1-h rows, clipped to the interior,
// reading one cell further out.
//
// Ghosts.  Level 0 reads the pass's input with its stored ghosts (the
// solve's input, or the previous pass's output, which has every ghost),
// or zeros for a zero guess, through x0 + a * 0 as tf::jacobi_at does.
// A later level's tap across a face is the cell's own level h-1 value
// times the face's sign, which is what set_bnd3d left in the ghost.  The
// last level writes a slot with no cell on a face straight to dst, and
// the rest to an output plane; a block whose tile or plane lies on a face
// of the grid then stores those cells and every ghost whose clamped
// interior cell is one of them, times the set_bnd3d(b) sign, as
// tf::jacobi_cell does.  So every output cell is written, ghosts
// included, and equals that of F launches of the one-cell sweep.
//
// Layout.  A ring plane is the tile with an F-deep halo, z contiguous,
// and in z one cell more a side: tiles start at odd K (1, 1 + TZ, ...), so
// the plane's rows start at even K and a slot is an aligned pair of cells
// (2m, 2m + 1) of the global row, one 4-byte word; the pairs at the
// tile's two z ends hold one of its cells each.  A warp's slots are
// consecutive words: x and y neighbours, x0 and the cell's own pair are
// whole words, the two z taps each straddle two words (a byte permute).
// A slot is loaded from and stored to device memory as one word where its
// offset is even (every row when n + 2 is even), else as two halves;
// cells outside the array are zeros, read by no level.
#include "jacobi.cuh"

namespace {

using bf16 = __nv_bfloat16;
using V = __nv_bfloat162;
using P = tf::Pair<bf16>;

template <int F_, int TY_, int TZ_, int NT_>
struct JTile {
  static constexpr int F = F_, TY = TY_, TZ = TZ_;
  static constexpr int NT = NT_;          // threads a block
  static constexpr int W = TZ + 2 * F + 2;  // a halo row's cells
  static constexpr int PW = W / 2;        // ... in pairs (words)
  static constexpr int ROWS = TY + 2 * F;
  static constexpr int PAIRS = ROWS * PW;  // words a plane
  // x and x0: planes s - 1 .. s + 1 read by level 0, s - F + 1 of x0 by
  // the last level, s + 2 going in
  static constexpr int RING = F + 2;
  static constexpr int MID = 3;  // planes q - 1 .. q + 1 of a level's output
  // the rings, and the last level's output plane
  static constexpr int SMEM = (2 * RING + MID * (F - 1) + 1) * PAIRS * 4;
  static constexpr int SLOTS = (PAIRS + NT - 1) / NT;  // slots a thread
  // resident blocks a multiprocessor the registers must allow: as many
  // as 1024 threads, or the shared memory (227 KB), allow
  static constexpr int MIN_BLOCKS =
      1024 / NT < 232448 / SMEM ? 1024 / NT : 232448 / SMEM;
  static_assert(F >= 2 && F % 2 == 0 && TZ % 2 == 0,
                "a halo row must start at even global K");
};

struct JArgs {
  const bf16* src;  // NULL: a zero guess (first pass only)
  const bf16* x0;
  bf16* dst;
  int n, r_lo, r_hi, chunk, h, b;
  float sx, sy, sz, a, c_inv;
};

// What a thread does in every plane, fixed for the launch.  Slot i is
// pair t = threadIdx.x + i NT of the halo plane: word ``w`` there (-1
// past the plane), cells (J, K0) and (J, K0 + 1) of the global row at
// plane offset ``off`` = J (n+2) + K0; bit l of ``in`` says that lane l
// lies in the array, bit pair h of ``cone`` which lanes lie in level h's
// cone, and ``face`` that a lane may touch a y or z face.
template <class Tl>
struct JLanes {
  int w[Tl::SLOTS], off[Tl::SLOTS];
  unsigned in[Tl::SLOTS], cone[Tl::SLOTS];
  bool face[Tl::SLOTS];

  __device__ JLanes(int n, int H, int ty0, int tz0) {
    const int N = n + 2;
    const int ys = ty0 - Tl::F, zs = tz0 - Tl::F - 1;
#pragma unroll
    for (int i = 0; i < Tl::SLOTS; ++i) {
      const int t = threadIdx.x + i * Tl::NT;
      const bool in_plane = t < Tl::PAIRS;
      const int J = ys + t / Tl::PW, K0 = zs + 2 * (t % Tl::PW);
      w[i] = in_plane ? t : -1;
      off[i] = J * N + K0;
      const bool jin = in_plane && J >= 0 && J < N;
      in[i] = (unsigned)(jin && K0 >= 0 && K0 < N) |
              (unsigned)(jin && K0 + 1 >= 0 && K0 + 1 < N) << 1;
      unsigned bits = 0;
      for (int h = 0; h < H; ++h) {
        const int e = H - 1 - h;
        const bool rok = in_plane && J >= max(1, ty0 - e) &&
                         J <= min(n, ty0 + Tl::TY - 1 + e);
        const int zlo = max(1, tz0 - e), zhi = min(n, tz0 + Tl::TZ - 1 + e);
        const unsigned ok0 = rok && K0 >= zlo && K0 <= zhi;
        const unsigned ok1 = rok && K0 + 1 >= zlo && K0 + 1 <= zhi;
        bits |= (ok0 | ok1 << 1) << 2 * h;
      }
      cone[i] = bits;
      face[i] = J == 1 || J == n || K0 == 0 || K0 == 1 || K0 == n - 1 ||
                K0 == n;
    }
  }
};

// A plane of x and x0 on its way from device memory, in registers: a
// word (two cells) a slot.
template <class Tl>
struct JStaged {
  unsigned x[Tl::SLOTS], x0[Tl::SLOTS];
};

// The lanes ``m`` of the pair at p + o as a word, the others zero.
__device__ __forceinline__ unsigned pair_bits(const bf16* p, size_t o,
                                              unsigned m) {
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p) + o;
  if (m == 3u && !(o & 1))
    return __ldg(reinterpret_cast<const unsigned*>(h));
  const unsigned lo = m & 1u ? __ldg(h) : 0u;
  const unsigned hi = m & 2u ? __ldg(h + 1) : 0u;
  return lo | hi << 16;
}

// Reads slots [lo, hi) of this thread's share of plane q of x and x0 (the
// tile and its halo; zeros outside the array) into registers.
template <class Tl>
__device__ __forceinline__ void fetch_plane(JStaged<Tl>& r, const JArgs& g,
                                            const JLanes<Tl>& L, int q,
                                            int lo, int hi) {
  const int N = g.n + 2;
  const size_t base = (size_t)q * N * N;
#pragma unroll
  for (int i = 0; i < Tl::SLOTS; ++i) {
    if (i < lo || i >= hi) continue;
    const unsigned m = q < N ? L.in[i] : 0u;
    const size_t o = base + L.off[i];
    r.x[i] = m && g.src ? pair_bits(g.src, o, m) : 0u;
    r.x0[i] = m ? pair_bits(g.x0, o, m) : 0u;
  }
}

template <class Tl>
__device__ __forceinline__ void put_plane(unsigned* xs, unsigned* x0s,
                                          const JStaged<Tl>& r,
                                          const JLanes<Tl>& L) {
#pragma unroll
  for (int i = 0; i < Tl::SLOTS; ++i) {
    if (L.w[i] >= 0) {
      xs[L.w[i]] = r.x[i];
      x0s[L.w[i]] = r.x0[i];
    }
  }
}

// Level h on plane q: sweep h of the cells of its cone, from the planes
// q - 1, q, q + 1 of its input (Sm, S0, Sp: the pass's input for level 0,
// level h-1's ring after) and x0's plane q, into ``out``: level h's ring
// plane, or the last level's output plane.  On the last level (``dq``:
// dst's plane q) a slot with no cell on a face goes to dst at once.
// ``taps``: a tap across a face is the cell's own value times the sign
// (every level but the first).
template <class Tl>
__device__ __forceinline__ void update_level(
    const unsigned* Sm, const unsigned* S0, const unsigned* Sp,
    const unsigned* X0, unsigned* out, unsigned short* dq, const JArgs& g,
    const JLanes<Tl>& L, int h, int q, bool taps, int ys, int zs) {
  constexpr int PW = Tl::PW;
  const int n = g.n;
  const bool xface = q == 1 || q == n;
#pragma unroll
  for (int i = 0; i < Tl::SLOTS; ++i) {
    const unsigned ok = L.cone[i] >> 2 * h & 3u;
    if (!ok) continue;
    const int w = L.w[i];
    const unsigned own = S0[w];
    const V x0c = P::of_bits(X0[w]);
    const V xm = P::of_bits(Sm[w]), xp = P::of_bits(Sp[w]);
    const V ym = P::of_bits(S0[w - PW]), yp = P::of_bits(S0[w + PW]);
    // cells 2m - 1, 2m and 2m + 1, 2m + 2 of the row
    const V zm = P::straddle(S0[w - 1], own);
    const V zp = P::straddle(own, S0[w + 1]);
    V v;
    const bool face = xface || L.face[i];
    if (taps && face) {
      const V o = P::of_bits(own);
      const int J = ys + w / PW, K0 = zs + 2 * (w % PW), K1 = K0 + 1;
      v = tf::cell_update(x0c, P::tap(xm, o, g.sx, q == 1, q == 1),
                          P::tap(xp, o, g.sx, q == n, q == n),
                          P::tap(ym, o, g.sy, J == 1, J == 1),
                          P::tap(yp, o, g.sy, J == n, J == n),
                          P::tap(zm, o, g.sz, K0 == 1, K1 == 1),
                          P::tap(zp, o, g.sz, K0 == n, K1 == n), g.a,
                          g.c_inv);
    } else {
      v = tf::cell_update(x0c, xm, xp, ym, yp, zm, zp, g.a, g.c_inv);
    }
    if (dq && !face) {
      unsigned short* d = dq + L.off[i];
      if (ok == 3u && !(reinterpret_cast<size_t>(d) & 3))
        *reinterpret_cast<unsigned*>(d) = P::bits(v);
      else if (ok == 3u)
        d[0] = (unsigned short)P::bits(v), d[1] = P::bits(v) >> 16;
      else
        d[ok >> 1] = (unsigned short)(P::bits(v) >> (ok >> 1) * 16);
      continue;
    }
    if (ok == 3u)
      out[w] = P::bits(v);
    else
      reinterpret_cast<bf16*>(out)[2 * w + (ok >> 1)] =
          ok == 1u ? P::lo(v) : P::hi(v);
  }
}

// The cells of plane q of dst that the last level left in its output
// plane S (those of slots on a face), and every ghost whose clamped
// interior cell is one of them, times its set_bnd3d(b) sign
// (tf::jacobi_cell's rule): the ghost row or column beside a face of the
// tile, and at q = 1 or n the x ghost plane too.  A thread takes pairs
// (K0, K0 + 1), K0 even, of rows ty0 - 1 .. ty0 + TY and cells tz0 - 1 ..
// tz0 + TZ (the tile and a cell beside it, a ghost at a face), skipping
// those the last level wrote: one word where the pair is aligned in dst
// and holds two of the tile's interior cells.
template <class Tl>
__device__ __forceinline__ void store_plane(const unsigned* S,
                                            const JArgs& g, int q, int ty0,
                                            int tz0, int ys, int zs) {
  constexpr int PR = Tl::TZ / 2 + 1, PW = Tl::PW;
  const int n = g.n, N = n + 2;
  const unsigned short* Sh = reinterpret_cast<const unsigned short*>(S);
  unsigned short* dh = reinterpret_cast<unsigned short*>(g.dst);
  // the output rows and cells: the tile's, and a ghost beside a face
  const int jlo = ty0 == 1 ? 0 : ty0;
  const int jhi = ty0 + Tl::TY - 1 >= n ? n + 1 : ty0 + Tl::TY - 1;
  const int klo = tz0 == 1 ? 0 : tz0;
  const int khi = tz0 + Tl::TZ - 1 >= n ? n + 1 : tz0 + Tl::TZ - 1;
  const size_t plane = (size_t)q * N * N, NN = (size_t)N * N;
  // at q = 1 or n the x ghost plane too, negated for b = 1
  const unsigned xneg = g.b == 1 ? 0x80008000u : 0u;
  const auto put = [&](size_t at, unsigned u, unsigned lanes) {
    if (lanes == 3u && !(at & 1)) {
      *reinterpret_cast<unsigned*>(dh + at) = u;
    } else {
      if (lanes & 1u) dh[at] = (unsigned short)u;
      if (lanes & 2u) dh[at + 1] = (unsigned short)(u >> 16);
    }
  };
  for (int t = threadIdx.x; t < (Tl::TY + 2) * PR; t += Tl::NT) {
    const int j = ty0 - 1 + t / PR, K0 = tz0 - 1 + 2 * (t % PR);
    if (j < jlo || j > jhi) continue;
    // two interior cells of a slot with none on a face: the last level
    // wrote them
    if (!(q == 1 || q == n || j <= 1 || j >= n || K0 <= 1 || K0 >= n - 1))
      continue;
    const size_t o = plane + (size_t)j * N + K0;
    unsigned v, lanes;
    if (j >= 1 && j <= n && K0 >= klo && K0 >= 1 && K0 + 1 <= khi &&
        K0 + 1 <= n) {
      // two interior cells of the tile
      v = S[(j - ys) * PW + (K0 - zs) / 2];
      lanes = 3u;
    } else {
      // each lane from its clamped cell, negated where set_bnd3d(b)
      // negates it
      const int cj = tf::clamp_interior(j, n);
      v = lanes = 0;
      for (int l = 0; l < 2; ++l) {
        const int K = K0 + l;
        if (K < klo || K > khi) continue;
        const int ck = tf::clamp_interior(K, n);
        const bool neg = (g.b == 2 && j != cj) || (g.b == 3 && K != ck);
        v |= (Sh[2 * (cj - ys) * PW + ck - zs] ^ (neg ? 0x8000u : 0u))
             << 16 * l;
        lanes |= 1u << l;
      }
    }
    put(o, v, lanes);
    if (q == 1) put(o - NN, v ^ xneg, lanes);
    if (q == n) put(o + NN, v ^ xneg, lanes);
  }
}

template <class Tl>
__global__ void __launch_bounds__(Tl::NT, Tl::MIN_BLOCKS)
    jacobi_blocked_kernel(const JArgs g) {
  constexpr int PAIRS = Tl::PAIRS, RING = Tl::RING;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* xr = reinterpret_cast<unsigned*>(smem);
  unsigned* x0r = xr + RING * PAIRS;
  unsigned* mid = x0r + RING * PAIRS;  // level h's ring at h * MID planes
  unsigned* last = mid + (Tl::F - 1) * Tl::MID * PAIRS;  // the output plane
  const int H = g.h;
  const int ty0 = 1 + blockIdx.y * Tl::TY, tz0 = 1 + blockIdx.x * Tl::TZ;
  const int ys = ty0 - Tl::F, zs = tz0 - Tl::F - 1;  // halo cell (0, 0)
  const int c0 = g.r_lo + blockIdx.z * g.chunk;
  const int c1 = min(c0 + g.chunk, g.r_hi + 1);
  const int s0 = max(c0 - (H - 1), g.r_lo);
  // level h computes plane s - h at step s; the last writes it out
  const int s_end = c1 + H - 2;
  const JLanes<Tl> L(g.n, H, ty0, tz0);
  const bool edge = ty0 == 1 || ty0 + Tl::TY - 1 >= g.n || tz0 == 1 ||
                    tz0 + Tl::TZ - 1 >= g.n;
  // planes s0 - 1 .. s0 + 1 in the rings, s0 + 2 in registers
  JStaged<Tl> next;
  for (int p = s0 - 1; p <= s0 + 1; ++p) {
    fetch_plane<Tl>(next, g, L, p, 0, Tl::SLOTS);
    put_plane<Tl>(xr + p % RING * PAIRS, x0r + p % RING * PAIRS, next, L);
  }
  fetch_plane<Tl>(next, g, L, s0 + 2, 0, Tl::SLOTS);
  for (int s = s0; s <= s_end; ++s) {
    // plane s + 2 goes in (no level of this step reads it); the barrier
    // publishes plane s + 1
    const int at = (s + 2) % RING;
    put_plane<Tl>(xr + at * PAIRS, x0r + at * PAIRS, next, L);
    __syncthreads();
#pragma unroll
    for (int h = 0; h < Tl::F; ++h) {
      // plane s + 3 comes into registers a share at a time between the
      // levels (as rb_blocked.cu)
      fetch_plane<Tl>(next, g, L, s + 3, h * Tl::SLOTS / Tl::F,
                      (h + 1) * Tl::SLOTS / Tl::F);
      if (h < H) {
        const int q = s - h, e = H - 1 - h;
        if (q >= max(c0 - e, g.r_lo) && q <= min(c1 - 1 + e, g.r_hi)) {
          const unsigned* src = h == 0 ? xr : mid + (h - 1) * Tl::MID * PAIRS;
          const int r = h == 0 ? RING : Tl::MID;
          unsigned* out = h == H - 1
                              ? last
                              : mid + (h * Tl::MID + q % Tl::MID) * PAIRS;
          unsigned short* dq =
              h == H - 1 ? reinterpret_cast<unsigned short*>(g.dst) +
                               (size_t)q * (g.n + 2) * (g.n + 2)
                         : nullptr;
          update_level<Tl>(src + (q - 1) % r * PAIRS, src + q % r * PAIRS,
                           src + (q + 1) % r * PAIRS, x0r + q % RING * PAIRS,
                           out, dq, g, L, h, q, h > 0, ys, zs);
        }
        __syncthreads();
      }
    }
    // plane s - (H-1), final: the cells on a face and the ghosts to dst,
    // if the chunk owns it and the tile or the plane lies on a face (the
    // output plane is next written after the next step's first barrier)
    const int q = s - (H - 1);
    if (q >= c0 && (edge || q == 1 || q == g.n))
      store_plane<Tl>(last, g, q, ty0, tz0, ys, zs);
  }
}

// The one compiled shape; kernels.JACOBI_TILE names it to the Python side.
using Shape = JTile<2, 16, 128, 512>;

}  // namespace

// One pass of ``h`` bfloat16 Jacobi sweeps from src (NULL: zeros) into
// dst, every output cell written, over interior rows r_lo .. r_hi of an
// (n+2)^3 field in ``chunks`` x-chunks of ``chunk`` rows.  The
// shared-memory attribute it needs is set by tf_jacobi_blocked_info,
// which must have run on the device first.
extern "C" int tf_jacobi_blocked_pass(const void* src, const void* x0,
                                      void* dst, int n, int r_lo, int r_hi,
                                      int chunk, int chunks, int h, int b,
                                      float a, float c_inv, void* stream) {
  if (h < 1 || h > Shape::F || chunks < 1 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const tf::Signs s = tf::signs_for(b);
  const JArgs g{(const bf16*)src, (const bf16*)x0, (bf16*)dst, n, r_lo,
                r_hi, chunk, h, b, s.x, s.y, s.z, a, c_inv};
  const dim3 grid((n + Shape::TZ - 1) / Shape::TZ,
                  (n + Shape::TY - 1) / Shape::TY, chunks);
  jacobi_blocked_kernel<Shape>
      <<<grid, Shape::NT, Shape::SMEM, (cudaStream_t)stream>>>(g);
  return tf::launch_status();
}

// As tf_rb_blocked_info, for this kernel.
extern "C" int tf_jacobi_blocked_info(int* slots, int* smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(jacobi_blocked_kernel<Shape>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Shape::SMEM);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, jacobi_blocked_kernel<Shape>, Shape::NT, Shape::SMEM);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *slots = sms * per_sm;
  *smem = Shape::SMEM;
  return 0;
}
