// The temporally blocked Jacobi pass: up to F Jacobi sweeps of (x0 + a *
// sum of the six neighbours) / c, each followed by set_bnd3d(b), in one
// launch on a cubic (n+2)^3 field, stored as float or as __nv_bfloat16
// (every operation rounded to the storage type).
//
// Replaces (tpufluids/grid/pallas_kernels.py):
//   lin_solve3d_pallas / _solve_kernel (Jacobi), in both storage types:
//   the reference routes float32 and bfloat16 Jacobi with fuse = 2 when
//   the sweep count is even (tpufluids/grid/stam.py:275-287), two sweeps
//   a pass through a VMEM window with a halo.  A solve of an odd number
//   of sweeps ends with a pass of one.
//
// What bounds it on the H100.  A sweep does 8 operations a cell and has
// to see x and x0: at one device-memory pass a sweep (the design this
// replaces: one launch a sweep, one thread a cell with an index decode)
// 12 B a cell a sweep in float32, 6 B in bfloat16, and those kernels
// were bound by instruction issue, short of even that floor.  Here a
// pass reads x and x0 once, each with a halo of F cells, writes the
// result once, and does F sweeps in shared memory between, V cells a
// thread at once (tf::cell_update lane by lane, four in float32; in
// bfloat16 one bf16x2 instruction for two).  Measured, the pass is then
// bound by the multiprocessor's work a level: a slot's control and
// addressing outnumber its arithmetic, and the barriers between levels
// expose their latency (PERF.md).  So a pass of F sweeps is compiled for
// that count, and float32 takes four cells a slot.
//
// Design.  As rb_blocked.cu: a block owns a (y, z) tile of TY x TZ cells
// and a chunk of x rows [c0, c1), and streams along x.  At step s, plane
// s + 2 of x and x0 goes from registers into rings of F + 2 planes (at
// least four: s - 1 .. s + 2), a barrier publishes plane s + 1, and
// level h = 0 .. H-1 computes sweep h on plane s - h, a barrier after
// each level; plane s + 3 comes into registers a share at a time between
// the levels.  Jacobi is out of place: level h reads level h-1's planes
// q - 1, q and q + 1 and must not overwrite them, so every level below
// the last writes its own ring of three planes (the next level reads
// them one step later).  The cones are rb_blocked.cu's: level h computes
// the tile widened by H-1-h cells in y and z, and the chunk widened by
// H-1-h rows, clipped to the interior, reading one cell further out.
//
// Ghosts.  Level 0 reads the pass's input with its stored ghosts (the
// solve's input, or the previous pass's output, which has every ghost),
// or zeros for a zero guess, through x0 + a * 0 as the plain solve does.
// A later level's tap across a face is the cell's own level h-1 value
// times the face's sign, which is what set_bnd3d left in the ghost.  The
// last level writes a slot with no cell on a face straight to dst, and
// the rest to an output plane; a block with such a slot (its tile or
// plane on a face of the grid, or its tile's last slot reaching one)
// then stores those cells and every ghost whose clamped interior cell is
// one of them, times the set_bnd3d(b) sign (tf::ghost_cell's rule).  So
// every output cell is written, ghosts included, and equals that of F
// one-cell sweeps.
//
// Layout.  A ring plane is the tile with a halo of F rows in y and at
// least F + 1 cells a side in z (one more than the levels read), z
// contiguous: tiles start at K = 1 mod V and the left halo is 1 mod V
// cells, so the plane's rows start at K = 0 mod V and a slot is an
// aligned run of V cells (K0 .. K0 + V - 1) of the global row, one word
// (16 bytes in float32 quads, 4 in bfloat16 pairs); the
// slots at the tile's two z ends hold one cell or more of it.  A warp's
// slots are consecutive words: x and y neighbours, x0 and the cell's own
// slot are whole words, the two z taps a cell of the words either side
// (in bfloat16 a byte permute of two words).  A slot is loaded from and
// stored to device memory as one word where its address allows (every
// row when n + 2 is a multiple of V), else in halves or cells; cells
// outside the array are zeros, read by no level.
#include <tuple>
#include <type_traits>

#include "jacobi.cuh"

namespace {

using bf16 = __nv_bfloat16;

// A slot of V cells of storage type T: its bits (W, one word; C a cell's
// bits) and its values (X) for the arithmetic, lane by lane.
template <typename T, int V>
struct Slot;

template <>
struct Slot<bf16, 2> {
  using P = tf::Pair<bf16>;
  using C = unsigned short;
  using W = unsigned;
  using X = P::V;
  static constexpr C kSign = 0x8000u;
  static __device__ __forceinline__ C lane(W w, int l) {
    return (C)(w >> 16 * l);
  }
  // every lane's sign bit xor s (kSign or 0)
  static __device__ __forceinline__ W flip(W w, C s) {
    return w ^ ((unsigned)s | (unsigned)s << 16);
  }
  static __device__ __forceinline__ W make(const C (&c)[2]) {
    return c[0] | (unsigned)c[1] << 16;
  }
  static __device__ __forceinline__ X of(W w) { return P::of_bits(w); }
  static __device__ __forceinline__ W bits(X x) { return P::bits(x); }
  // the z taps of the slot at word w of plane S, its own bits ``own``
  static __device__ __forceinline__ void z_taps(const W* S, int w, W own,
                                                X& zm, X& zp) {
    zm = P::straddle(S[w - 1], own);
    zp = P::straddle(own, S[w + 1]);
  }
  // lane by lane: ``stored``, or where bit l of m the own value times s
  static __device__ __forceinline__ X tap(X stored, X own, float s,
                                          unsigned m) {
    return P::tap(stored, own, s, m & 1u, m & 2u);
  }
  static __device__ __forceinline__ X update(X x0c, X xm, X xp, X ym, X yp,
                                             X zm, X zp, float a,
                                             float c_inv) {
    return tf::cell_update(x0c, xm, xp, ym, yp, zm, zp, a, c_inv);
  }
};

template <>
struct Slot<float, 4> {
  using C = unsigned;
  using W = uint4;
  using X = float4;
  static constexpr C kSign = 0x80000000u;
  static __device__ __forceinline__ C lane(W w, int l) {
    return l == 0 ? w.x : l == 1 ? w.y : l == 2 ? w.z : w.w;
  }
  static __device__ __forceinline__ W flip(W w, C s) {
    return make_uint4(w.x ^ s, w.y ^ s, w.z ^ s, w.w ^ s);
  }
  static __device__ __forceinline__ W make(const C (&c)[4]) {
    return make_uint4(c[0], c[1], c[2], c[3]);
  }
  static __device__ __forceinline__ X of(W w) {
    return make_float4(__uint_as_float(w.x), __uint_as_float(w.y),
                       __uint_as_float(w.z), __uint_as_float(w.w));
  }
  static __device__ __forceinline__ W bits(X x) {
    return make_uint4(__float_as_uint(x.x), __float_as_uint(x.y),
                      __float_as_uint(x.z), __float_as_uint(x.w));
  }
  static __device__ __forceinline__ void z_taps(const W* S, int w, W own,
                                                X& zm, X& zp) {
    const float* f = reinterpret_cast<const float*>(S);
    const X o = of(own);
    zm = make_float4(f[4 * w - 1], o.x, o.y, o.z);
    zp = make_float4(o.y, o.z, o.w, f[4 * w + 4]);
  }
  static __device__ __forceinline__ float tap1(float stored, float own,
                                               float s, bool l) {
    return l ? tf::mul_rn(s, own) : stored;
  }
  static __device__ __forceinline__ X tap(X stored, X own, float s,
                                          unsigned m) {
    return make_float4(tap1(stored.x, own.x, s, m & 1u),
                       tap1(stored.y, own.y, s, m & 2u),
                       tap1(stored.z, own.z, s, m & 4u),
                       tap1(stored.w, own.w, s, m & 8u));
  }
  static __device__ __forceinline__ X update(X x0c, X xm, X xp, X ym, X yp,
                                             X zm, X zp, float a,
                                             float c_inv) {
    using tf::cell_update;
    return make_float4(
        cell_update(x0c.x, xm.x, xp.x, ym.x, yp.x, zm.x, zp.x, a, c_inv),
        cell_update(x0c.y, xm.y, xp.y, ym.y, yp.y, zm.y, zp.y, a, c_inv),
        cell_update(x0c.z, xm.z, xp.z, ym.z, yp.z, zm.z, zp.z, a, c_inv),
        cell_update(x0c.w, xm.w, xp.w, ym.w, yp.w, zm.w, zp.w, a, c_inv));
  }
};

// The least halo >= h cells whose count is 1 mod V (a left halo), or
// that with ``from`` cells before it fills whole words (a right halo).
constexpr int halo_left(int h, int V) { return h + ((1 - h) % V + V) % V; }
constexpr int halo_right(int h, int from, int V) {
  return h + ((-(from + h)) % V + V) % V;
}

// A shape: F sweeps a pass on a TY x TZ tile, NT threads a block, V
// cells a slot, fields stored as T.
template <int F_, int TY_, int TZ_, int NT_, typename T_, int V_>
struct JTile {
  using T = T_;
  using S = Slot<T_, V_>;
  using W = typename S::W;
  static constexpr int F = F_, TY = TY_, TZ = TZ_, V = V_;
  static constexpr int NT = NT_;  // threads a block
  static constexpr unsigned ALL = (1u << V) - 1;  // every lane of a slot
  static constexpr int ZL = halo_left(F + 1, V);  // z halo cells, left
  static constexpr int ZR = halo_right(F + 1, ZL + TZ, V);  // ... right
  static constexpr int PW = (ZL + TZ + ZR) / V;  // a halo row's words
  static constexpr int ROWS = TY + 2 * F;
  static constexpr int WORDS = ROWS * PW;  // a plane's
  // x and x0: planes s - 1 .. s + 1 read by level 0, s - F + 1 of x0 by
  // the last level, s + 2 going in
  static constexpr int RING = F + 2 > 4 ? F + 2 : 4;
  static constexpr int MID = 3;  // planes q - 1 .. q + 1 of a level's output
  // the rings, and the last level's output plane
  static constexpr int SMEM =
      (2 * RING + MID * (F - 1) + 1) * WORDS * (int)sizeof(W);
  static constexpr int SLOTS = (WORDS + NT - 1) / NT;  // slots a thread
  // resident blocks a multiprocessor the registers must allow: as many
  // as 1024 threads, or the shared memory (227 KB), allow
  static constexpr int MIN_BLOCKS =
      1024 / NT < 232448 / SMEM ? 1024 / NT : 232448 / SMEM;
  static_assert(F >= 1 && F * V <= 32 && TZ % V == 0,
                "a halo row must start at global K = 0 mod V");
  static_assert(SMEM <= 232448, "more shared memory than a block may take");
};

template <typename T>
struct JArgs {
  const T* src;  // NULL: a zero guess (first pass only)
  const T* x0;
  T* dst;
  int n, r_lo, r_hi, chunk, h, b;
  float sx, sy, sz, a, c_inv;
};

// What a thread does in every plane, fixed for the launch.  Slot i is
// word t = threadIdx.x + i NT of the halo plane: ``w`` = t there (-1
// past the plane), cells (J, K0 .. K0 + V - 1) of the global row at
// plane offset ``off`` = J (n+2) + K0; bit l of ``in`` says that lane l
// lies in the array, bits h V .. h V + V - 1 of ``cone`` which lanes lie
// in level h's cone, and ``face`` that a lane may touch a y or z face.
template <class Tl>
struct JLanes {
  int w[Tl::SLOTS], off[Tl::SLOTS];
  unsigned in[Tl::SLOTS], cone[Tl::SLOTS];
  bool face[Tl::SLOTS];

  __device__ JLanes(int n, int H, int ty0, int tz0) {
    constexpr int V = Tl::V;
    const int N = n + 2;
    const int ys = ty0 - Tl::F, zs = tz0 - Tl::ZL;
#pragma unroll
    for (int i = 0; i < Tl::SLOTS; ++i) {
      const int t = threadIdx.x + i * Tl::NT;
      const bool in_plane = t < Tl::WORDS;
      const int J = ys + t / Tl::PW, K0 = zs + V * (t % Tl::PW);
      w[i] = in_plane ? t : -1;
      off[i] = J * N + K0;
      const bool jin = in_plane && J >= 0 && J < N;
      unsigned m = 0;
      for (int l = 0; l < V; ++l)
        m |= (unsigned)(jin && K0 + l >= 0 && K0 + l < N) << l;
      in[i] = m;
      unsigned bits = 0;
      for (int h = 0; h < H; ++h) {
        const int e = H - 1 - h;
        const bool rok = in_plane && J >= max(1, ty0 - e) &&
                         J <= min(n, ty0 + Tl::TY - 1 + e);
        const int zlo = max(1, tz0 - e), zhi = min(n, tz0 + Tl::TZ - 1 + e);
        for (int l = 0; l < V; ++l)
          bits |= (unsigned)(rok && K0 + l >= zlo && K0 + l <= zhi)
                  << (V * h + l);
      }
      cone[i] = bits;
      face[i] = J == 1 || J == n || K0 <= 1 || K0 + V - 1 >= n;
    }
  }
};

// A plane of x and x0 on its way from device memory, in registers: a
// word a slot.
template <class Tl>
struct JStaged {
  typename Tl::W x[Tl::SLOTS], x0[Tl::SLOTS];
};

// The lanes ``m`` of the slot at p as a word, the others zero: one load
// where its address is aligned to the word, else halves or cells.
template <class Tl>
__device__ __forceinline__ typename Tl::W slot_bits(const typename Tl::T* p,
                                                    unsigned m) {
  using S = typename Tl::S;
  using C = typename S::C;
  using W = typename S::W;
  const C* h = reinterpret_cast<const C*>(p);
  const size_t a = reinterpret_cast<size_t>(p);
  if (m == Tl::ALL && !(a % sizeof(W)))
    return __ldg(reinterpret_cast<const W*>(h));
  if constexpr (Tl::V == 4) {
    if (m == Tl::ALL && !(a % 8)) {
      const uint2 lo = __ldg(reinterpret_cast<const uint2*>(h));
      const uint2 hi = __ldg(reinterpret_cast<const uint2*>(h + 2));
      return make_uint4(lo.x, lo.y, hi.x, hi.y);
    }
  }
  C c[Tl::V];
#pragma unroll
  for (int l = 0; l < Tl::V; ++l) c[l] = m >> l & 1u ? __ldg(h + l) : C(0);
  return S::make(c);
}

// The lanes ``m`` of word u to the slot at d (device memory), as
// slot_bits reads it.
template <class Tl>
__device__ __forceinline__ void put_slot(typename Tl::S::C* d,
                                         typename Tl::W u, unsigned m) {
  using S = typename Tl::S;
  using W = typename S::W;
  const size_t a = reinterpret_cast<size_t>(d);
  if (m == Tl::ALL && !(a % sizeof(W))) {
    *reinterpret_cast<W*>(d) = u;
    return;
  }
  if constexpr (Tl::V == 4) {
    if (m == Tl::ALL && !(a % 8)) {
      reinterpret_cast<uint2*>(d)[0] = make_uint2(u.x, u.y);
      reinterpret_cast<uint2*>(d)[1] = make_uint2(u.z, u.w);
      return;
    }
  }
#pragma unroll
  for (int l = 0; l < Tl::V; ++l)
    if (m >> l & 1u) d[l] = S::lane(u, l);
}

// Reads slots [lo, hi) of this thread's share of plane q of x and x0 (the
// tile and its halo; zeros outside the array) into registers.
template <class Tl>
__device__ __forceinline__ void fetch_plane(JStaged<Tl>& r,
                                            const JArgs<typename Tl::T>& g,
                                            const JLanes<Tl>& L, int q,
                                            int lo, int hi) {
  using W = typename Tl::W;
  const int N = g.n + 2;
  const size_t base = (size_t)q * N * N;
#pragma unroll
  for (int i = 0; i < Tl::SLOTS; ++i) {
    if (i < lo || i >= hi) continue;
    const unsigned m = q < N ? L.in[i] : 0u;
    const size_t o = base + L.off[i];
    r.x[i] = m && g.src ? slot_bits<Tl>(g.src + o, m) : W{};
    r.x0[i] = m ? slot_bits<Tl>(g.x0 + o, m) : W{};
  }
}

template <class Tl>
__device__ __forceinline__ void put_plane(typename Tl::W* xs,
                                          typename Tl::W* x0s,
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
    const typename Tl::W* Sm, const typename Tl::W* S0,
    const typename Tl::W* Sp, const typename Tl::W* X0, typename Tl::W* out,
    typename Tl::S::C* dq, const JArgs<typename Tl::T>& g,
    const JLanes<Tl>& L, int h, int q, bool taps, int ys, int zs) {
  using S = typename Tl::S;
  using W = typename S::W;
  using X = typename S::X;
  constexpr int PW = Tl::PW, V = Tl::V;
  const int n = g.n;
  const bool xface = q == 1 || q == n;
#pragma unroll
  for (int i = 0; i < Tl::SLOTS; ++i) {
    const unsigned ok = L.cone[i] >> V * h & Tl::ALL;
    if (!ok) continue;
    const int w = L.w[i];
    const W own = S0[w];
    const X x0c = S::of(X0[w]);
    const X xm = S::of(Sm[w]), xp = S::of(Sp[w]);
    const X ym = S::of(S0[w - PW]), yp = S::of(S0[w + PW]);
    X zm, zp, v;
    S::z_taps(S0, w, own, zm, zp);
    const bool face = xface || L.face[i];
    if (taps && face) {
      const X o = S::of(own);
      const int J = ys + w / PW, K0 = zs + V * (w % PW);
      // the lanes of cells K = 1 and K = n
      unsigned k1 = 0, kn = 0;
#pragma unroll
      for (int l = 0; l < V; ++l) {
        k1 |= (unsigned)(K0 + l == 1) << l;
        kn |= (unsigned)(K0 + l == n) << l;
      }
      v = S::update(x0c, S::tap(xm, o, g.sx, q == 1 ? Tl::ALL : 0u),
                    S::tap(xp, o, g.sx, q == n ? Tl::ALL : 0u),
                    S::tap(ym, o, g.sy, J == 1 ? Tl::ALL : 0u),
                    S::tap(yp, o, g.sy, J == n ? Tl::ALL : 0u),
                    S::tap(zm, o, g.sz, k1), S::tap(zp, o, g.sz, kn), g.a,
                    g.c_inv);
    } else {
      v = S::update(x0c, xm, xp, ym, yp, zm, zp, g.a, g.c_inv);
    }
    const W u = S::bits(v);
    if (dq && !face) {
      put_slot<Tl>(dq + L.off[i], u, ok);
      continue;
    }
    auto* oc = reinterpret_cast<typename S::C*>(out) + V * w;
    if (ok == Tl::ALL) {
      out[w] = u;
    } else if constexpr (V == 2) {
      // one lane: at a tile's z end
      oc[ok >> 1] = S::lane(u, ok >> 1);
    } else {
#pragma unroll
      for (int l = 0; l < V; ++l)
        if (ok >> l & 1u) oc[l] = S::lane(u, l);
    }
  }
}

// The cells of plane q of dst that the last level left in its output
// plane Sw (those of slots on a face), and every ghost whose clamped
// interior cell is one of them, times its set_bnd3d(b) sign
// (tf::ghost_cell's rule): the ghost row or column beside a face of the
// tile, and at q = 1 or n the x ghost plane too.  A thread takes slots
// (K0 .. K0 + V - 1), K0 = 0 mod V, of rows ty0 - 1 .. ty0 + TY and
// cells tz0 - 1 .. tz0 + TZ (the tile and a cell beside it, a ghost at a
// face), skipping those the last level wrote: one word where the slot
// holds V of the tile's interior cells.
template <class Tl>
__device__ __forceinline__ void store_plane(const typename Tl::W* Sw,
                                            const JArgs<typename Tl::T>& g,
                                            int q, int ty0, int tz0, int ys,
                                            int zs) {
  using S = typename Tl::S;
  using W = typename S::W;
  using C = typename S::C;
  constexpr int V = Tl::V, PR = Tl::TZ / V + 1, PW = Tl::PW;
  const int n = g.n, N = n + 2;
  const C* Sh = reinterpret_cast<const C*>(Sw);
  C* dh = reinterpret_cast<C*>(g.dst);
  // the output rows and cells: the tile's, and a ghost beside a face
  const int jlo = ty0 == 1 ? 0 : ty0;
  const int jhi = ty0 + Tl::TY - 1 >= n ? n + 1 : ty0 + Tl::TY - 1;
  const int klo = tz0 == 1 ? 0 : tz0;
  const int khi = tz0 + Tl::TZ - 1 >= n ? n + 1 : tz0 + Tl::TZ - 1;
  const size_t plane = (size_t)q * N * N, NN = (size_t)N * N;
  // at q = 1 or n the x ghost plane too, negated for b = 1
  const C xneg = g.b == 1 ? S::kSign : C(0);
  for (int t = threadIdx.x; t < (Tl::TY + 2) * PR; t += Tl::NT) {
    const int j = ty0 - 1 + t / PR, K0 = tz0 - 1 + V * (t % PR);
    if (j < jlo || j > jhi) continue;
    // interior cells of a slot with none on a face: the last level wrote
    // them
    if (!(q == 1 || q == n || j <= 1 || j >= n || K0 <= 1 ||
          K0 + V - 1 >= n))
      continue;
    const size_t o = plane + (size_t)j * N + K0;
    W v;
    unsigned lanes;
    if (j >= 1 && j <= n && K0 >= klo && K0 >= 1 && K0 + V - 1 <= khi &&
        K0 + V - 1 <= n) {
      // V interior cells of the tile
      v = Sw[(j - ys) * PW + (K0 - zs) / V];
      lanes = Tl::ALL;
    } else {
      // each lane from its clamped cell, negated where set_bnd3d(b)
      // negates it
      const int cj = tf::clamp_interior(j, n);
      C c[V];
      lanes = 0;
#pragma unroll
      for (int l = 0; l < V; ++l) {
        const int K = K0 + l;
        c[l] = 0;
        if (K < klo || K > khi) continue;
        const int ck = tf::clamp_interior(K, n);
        const bool neg = (g.b == 2 && j != cj) || (g.b == 3 && K != ck);
        c[l] = (C)(Sh[V * (cj - ys) * PW + ck - zs] ^
                   (neg ? S::kSign : C(0)));
        lanes |= 1u << l;
      }
      v = S::make(c);
    }
    put_slot<Tl>(dh + o, v, lanes);
    if (q == 1) put_slot<Tl>(dh + o - NN, S::flip(v, xneg), lanes);
    if (q == n) put_slot<Tl>(dh + o + NN, S::flip(v, xneg), lanes);
  }
}

// A pass of H = HC sweeps, or of g.h when HC is 0: with H known at
// compile time every level's role (its input ring, whether it writes to
// dst, whether its taps cross faces) is too, and those branches go.
template <class Tl, int HC>
__device__ __forceinline__ void jacobi_pass(const JArgs<typename Tl::T>& g) {
  using W = typename Tl::W;
  using C = typename Tl::S::C;
  constexpr int WORDS = Tl::WORDS, RING = Tl::RING;
  extern __shared__ __align__(16) unsigned char smem[];
  W* xr = reinterpret_cast<W*>(smem);
  W* x0r = xr + RING * WORDS;
  W* mid = x0r + RING * WORDS;  // level h's ring at h * MID planes
  W* last = mid + (Tl::F - 1) * Tl::MID * WORDS;  // the output plane
  const int H = HC ? HC : g.h;
  const int ty0 = 1 + blockIdx.y * Tl::TY, tz0 = 1 + blockIdx.x * Tl::TZ;
  const int ys = ty0 - Tl::F, zs = tz0 - Tl::ZL;  // halo cell (0, 0)
  const int c0 = g.r_lo + blockIdx.z * g.chunk;
  const int c1 = min(c0 + g.chunk, g.r_hi + 1);
  const int s0 = max(c0 - (H - 1), g.r_lo);
  // level h computes plane s - h at step s; the last writes it out
  const int s_end = c1 + H - 2;
  const JLanes<Tl> L(g.n, H, ty0, tz0);
  // a slot of the last level may hold a cell on a face: the tile's first
  // or last row, its first cell, or its last slot's last cell
  const bool edge = ty0 == 1 || ty0 + Tl::TY - 1 >= g.n || tz0 == 1 ||
                    tz0 + Tl::TZ - 1 >= g.n + 1 - Tl::V;
  // planes s0 - 1 .. s0 + 1 in the rings, s0 + 2 in registers
  JStaged<Tl> next;
  for (int p = s0 - 1; p <= s0 + 1; ++p) {
    fetch_plane<Tl>(next, g, L, p, 0, Tl::SLOTS);
    put_plane<Tl>(xr + p % RING * WORDS, x0r + p % RING * WORDS, next, L);
  }
  fetch_plane<Tl>(next, g, L, s0 + 2, 0, Tl::SLOTS);
  for (int s = s0; s <= s_end; ++s) {
    // plane s + 2 goes in (no level of this step reads it); the barrier
    // publishes plane s + 1
    const int at = (s + 2) % RING;
    put_plane<Tl>(xr + at * WORDS, x0r + at * WORDS, next, L);
    __syncthreads();
#pragma unroll
    for (int h = 0; h < Tl::F; ++h) {
      // plane s + 3 comes into registers a share at a time between the
      // levels
      fetch_plane<Tl>(next, g, L, s + 3, h * Tl::SLOTS / Tl::F,
                      (h + 1) * Tl::SLOTS / Tl::F);
      if (h < H) {
        const int q = s - h, e = H - 1 - h;
        if (q >= max(c0 - e, g.r_lo) && q <= min(c1 - 1 + e, g.r_hi)) {
          const W* src = h == 0 ? xr : mid + (h - 1) * Tl::MID * WORDS;
          const int r = h == 0 ? RING : Tl::MID;
          W* out = h == H - 1 ? last
                              : mid + (h * Tl::MID + q % Tl::MID) * WORDS;
          C* dq = h == H - 1 ? reinterpret_cast<C*>(g.dst) +
                                   (size_t)q * (g.n + 2) * (g.n + 2)
                             : nullptr;
          update_level<Tl>(src + (q - 1) % r * WORDS, src + q % r * WORDS,
                           src + (q + 1) % r * WORDS, x0r + q % RING * WORDS,
                           out, dq, g, L, h, q, h > 0, ys, zs);
        }
        __syncthreads();
      }
    }
    // plane s - (H-1), final: the cells on a face and the ghosts to dst,
    // if the chunk owns it and a slot of it may hold a face cell (the
    // output plane is next written after the next step's first barrier)
    const int q = s - (H - 1);
    if (q >= c0 && (edge || q == 1 || q == g.n))
      store_plane<Tl>(last, g, q, ty0, tz0, ys, zs);
  }
}

// Every pass but a solve's last of fewer sweeps runs F.
template <class Tl>
__global__ void __launch_bounds__(Tl::NT, Tl::MIN_BLOCKS)
    jacobi_blocked_kernel(const JArgs<typename Tl::T> g) {
  if constexpr (Tl::F == 1) {
    jacobi_pass<Tl, 1>(g);
  } else {
    if (g.h == Tl::F)
      jacobi_pass<Tl, Tl::F>(g);
    else
      jacobi_pass<Tl, 0>(g);
  }
}

// The compiled shape of each storage type (kernels.JACOBI_TILE and
// JACOBI_TILE_BF16 name them to the Python side): in float32 the fastest
// of the probe's shapes at 256^3, 20 sweeps (PERF.md: two sweeps a pass,
// four cells a slot, three blocks of 192 threads a multiprocessor); in
// bfloat16 two sweeps a pass on a 16 x 128
// tile (faster at 512^3 than one pass a sweep, or four), two blocks of
// 384 threads a multiprocessor: at 512 threads this code spills in the
// 64 registers two blocks allow, and at 384 it is as fast at 512^3 as
// the bfloat16-only kernel it replaced was at 512 (PERF.md).
template <typename T>
struct ShapeOf {
  using type = JTile<2, 16, 64, 192, float, 4>;
};
template <>
struct ShapeOf<bf16> {
  using type = JTile<2, 16, 128, 384, bf16, 2>;
};
template <typename T>
using Shape = typename ShapeOf<T>::type;

// The float32 shapes the probe times (chip_smoke.py's check_jacobi_probe):
// sweeps a pass, tiles, threads a block and cells a slot; the shipped one
// among them.
using Probe = std::tuple<
    JTile<1, 16, 64, 128, float, 4>, JTile<2, 16, 64, 128, float, 4>,
    JTile<2, 16, 64, 192, float, 4>, JTile<3, 16, 64, 256, float, 4>,
    JTile<4, 16, 64, 512, float, 4>, JTile<2, 24, 64, 256, float, 4>,
    JTile<2, 16, 128, 384, float, 4>, JTile<2, 32, 64, 512, float, 4>>;
constexpr int kProbes = (int)std::tuple_size<Probe>::value;

template <class Tl>
int blocked_pass(const void* src, const void* x0, void* dst, int n,
                 int r_lo, int r_hi, int chunk, int chunks, int h, int b,
                 float a, float c_inv, cudaStream_t stream) {
  using T = typename Tl::T;
  if (h < 1 || h > Tl::F || chunks < 1 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const tf::Signs s = tf::signs_for(b);
  const JArgs<T> g{(const T*)src, (const T*)x0, (T*)dst, n, r_lo, r_hi,
                   chunk, h, b, s.x, s.y, s.z, a, c_inv};
  const dim3 grid((n + Tl::TZ - 1) / Tl::TZ, (n + Tl::TY - 1) / Tl::TY,
                  chunks);
  jacobi_blocked_kernel<Tl><<<grid, Tl::NT, Tl::SMEM, stream>>>(g);
  return tf::launch_status();
}

template <class Tl>
int blocked_info(int* slots, int* smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(jacobi_blocked_kernel<Tl>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tl::SMEM);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, jacobi_blocked_kernel<Tl>, Tl::NT, Tl::SMEM);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *slots = sms * per_sm;
  *smem = Tl::SMEM;
  return 0;
}

// Probe shape ``shape``'s pass (past the list cudaErrorInvalidValue), or
// its shape, resident blocks and shared memory (blocked_info; past the
// list -1).
template <int I = 0>
int probe_pass(int shape, const void* src, const void* x0, void* dst, int n,
               int r_lo, int r_hi, int chunk, int chunks, int h, int b,
               float a, float c_inv, cudaStream_t stream) {
  if constexpr (I == kProbes) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (shape == I)
      return blocked_pass<std::tuple_element_t<I, Probe>>(
          src, x0, dst, n, r_lo, r_hi, chunk, chunks, h, b, a, c_inv,
          stream);
    return probe_pass<I + 1>(shape, src, x0, dst, n, r_lo, r_hi, chunk,
                             chunks, h, b, a, c_inv, stream);
  }
}

template <int I = 0>
int probe_info(int shape, int* dims, int* slots, int* smem) {
  if constexpr (I == kProbes) {
    return -1;
  } else {
    using Tl = std::tuple_element_t<I, Probe>;
    if (shape != I) return probe_info<I + 1>(shape, dims, slots, smem);
    dims[0] = Tl::F;
    dims[1] = Tl::TY;
    dims[2] = Tl::TZ;
    dims[3] = Tl::NT;
    dims[4] = Tl::V;
    dims[5] = std::is_same<Tl, Shape<float>>::value;
    return blocked_info<Tl>(slots, smem);
  }
}

}  // namespace

// One pass of ``h`` Jacobi sweeps from src (NULL: zeros) into dst, every
// output cell written, over interior rows r_lo .. r_hi of an (n+2)^3
// field in ``chunks`` x-chunks of ``chunk`` rows.  The fields hold float,
// or bfloat16 when ``bf16_storage``.  The shared-memory attribute it
// needs is set by tf_jacobi_blocked_info for the same storage type, which
// must have run on the device first.
extern "C" int tf_jacobi_blocked_pass(const void* src, const void* x0,
                                      void* dst, int n, int r_lo, int r_hi,
                                      int chunk, int chunks, int h, int b,
                                      int bf16_storage, float a, float c_inv,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return bf16_storage
             ? blocked_pass<Shape<bf16>>(src, x0, dst, n, r_lo, r_hi, chunk,
                                         chunks, h, b, a, c_inv, st)
             : blocked_pass<Shape<float>>(src, x0, dst, n, r_lo, r_hi,
                                          chunk, chunks, h, b, a, c_inv, st);
}

// As tf_rb_blocked_info, for this kernel.
extern "C" int tf_jacobi_blocked_info(int bf16_storage, int* slots,
                                      int* smem) {
  return bf16_storage ? blocked_info<Shape<bf16>>(slots, smem)
                      : blocked_info<Shape<float>>(slots, smem);
}

// The probe's float32 shapes: shape ``shape``'s (F, TY, TZ, threads,
// cells a slot, shipped) into dims[0..5], with its resident blocks and
// shared memory a block (setting its shared-memory attribute); -1 past
// the last.
extern "C" int tf_jacobi_probe_info(int shape, int* dims, int* slots,
                                    int* smem) {
  return probe_info(shape, dims, slots, smem);
}

// tf_jacobi_blocked_pass in float32 storage on probe shape ``shape``.
extern "C" int tf_jacobi_probe_pass(int shape, const void* src,
                                    const void* x0, void* dst, int n,
                                    int r_lo, int r_hi, int chunk,
                                    int chunks, int h, int b, float a,
                                    float c_inv, void* stream) {
  return probe_pass(shape, src, x0, dst, n, r_lo, r_hi, chunk, chunks, h, b,
                    a, c_inv, (cudaStream_t)stream);
}
