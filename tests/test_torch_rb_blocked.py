"""The temporally blocked red-black passes (csrc/rb_blocked.cu), on the
CPU: the pass schedule and x-chunks of tpufluids_torch.grid.kernels, and
a torch emulation of the kernel's schedule held against the plain
solves, in float32 and in bfloat16 storage.

The emulation does what one block of the kernel does, in the same order
and in its layout: it streams the planes of its chunk and its halo rows
into the packed colour arrays, and at step s level h = 0 .. H-1 (H the
pass's half-sweep count, for which the kernel is compiled) updates plane
s - h in place, slot by slot (two cells of one colour, each read from the
words the kernel reads), inside the cone of the tile and chunk widened by
H-1-h cells, one level after another (a barrier between levels in the
kernel); plane s - (H-1) of its tile is then final, and goes to dst (in
the kernel after the next step's first barrier).
Passes alternate between two buffers that start as NaN, so a read of a
cell that no pass wrote shows in the result.  Tolerance: bit for bit
against lin_solve3d_rb_plain, lin_solve3d_rb_bf16_plain and the plain
slab solve, which do the same operations in the same order (in
bfloat16 each rounded to bfloat16, as the kernel's bf16x2 operations
round), and the bfloat16 emulation bit for bit against interpret-mode
lin_solve3d_pallas(dtype=bfloat16) on the interior of set_bnd-consistent
inputs, as tests/test_torch_bf16.py holds the plain solve."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpufluids.grid import pallas_kernels as pk
from tpufluids_torch.grid import kernels, stam


# a slot of the kernel: two neighbouring cells of one colour (tf::Pair),
# in float32 and in bfloat16
CELLS = 2


def halo_width(tile, cells=CELLS):
    """The cells of a halo row of the kernel's planes (its Tile::W): the
    tile and k cells a side, widened to whole slots of both colours where
    a test's tile needs it (the kernel compiles no such shape)."""
    return -(-(tile.tz + 2 * tile.k) // (2 * cells)) * 2 * cells


class _Block:
    """One block's planes in the kernel's packed layout: halo cell (jy,
    kz) of a plane lies in colour array (jy + kz) & 1 at jy * HW + kz //
    2; and, for each colour, its slots of ``cells`` cells (slot t is word
    c = cells * t of the array, cells (jy, m .. m + cells - 1)), with
    what csrc/rb_blocked.cu's Lanes works out for them."""

    def __init__(self, n, ty0, tz0, tile, H, cells=CELLS):
        K, V = tile.k, cells
        self.n = n
        self.W = halo_width(tile, V)
        self.rows, self.HW = tile.ty + 2 * K, self.W // 2
        self.ys, self.zs = ty0 - K, tz0 - K
        self.size = self.rows * self.HW
        jy = torch.arange(self.rows)[:, None]
        kz = torch.arange(self.W)[None, :]
        # where each halo cell lies in the flat (2, rows * HW) plane
        self.flat = (((jy + kz) & 1) * self.size + jy * self.HW
                     + kz // 2).reshape(-1)
        t = torch.arange(self.size // V)
        row, m = t // (self.HW // V), V * (t % (self.HW // V))
        lane = torch.arange(V)[None, :]
        self.idx = V * t[:, None] + lane               # (slots, V) words
        J, K0 = self.ys + row, self.zs + 2 * m         # both colours' K0
        self.J = J[:, None]
        self.face = ((J == 1) | (J == n) | ((K0 <= 1) & (K0 + 2 * V > 1))
                     | ((K0 <= n) & (K0 + 2 * V > n)))[:, None]
        self.b, self.kl, self.cone = [], [], []
        for act in range(2):
            b = ((act + row) & 1)[:, None]
            kzl = 2 * (m[:, None] + lane) + b          # each lane's kz
            self.b.append(b)
            self.kl.append(self.zs + kzl)
            cones = []
            for h in range(H):
                e = H - 1 - h
                jlo = max(1, ty0 - e) - self.ys
                jhi = min(n, ty0 + tile.ty - 1 + e) - self.ys
                zlo = max(1, tz0 - e) - self.zs
                zhi = min(n, tz0 + tile.tz - 1 + e) - self.zs
                cones.append((row[:, None] >= jlo) & (row[:, None] <= jhi)
                             & (kzl >= zlo) & (kzl <= zhi))
            self.cone.append(cones)

    def pack(self, planes):
        """(p, rows, W) halo planes -> (p, 2, rows * HW) colour arrays."""
        out = torch.zeros((planes.shape[0], 2 * self.size),
                          dtype=planes.dtype)
        out[:, self.flat] = planes.reshape(planes.shape[0], -1)
        return out.reshape(-1, 2, self.size)

    def unpack(self, plane):
        """One (2, rows * HW) plane -> (rows, W)."""
        return plane.reshape(-1)[self.flat].reshape(self.rows, self.W)


def emulate_pass(src, x0, dst, gx0, chunks, p, b, a, c_inv, tile):
    """One launch of the blocked kernel: ``p.half_sweeps`` half-sweeps
    from ``src`` (None: zeros) into ``dst``, block by block, in x0's
    storage type."""
    rows, n = x0.shape[0], x0.shape[1] - 2
    N, K, H = n + 2, tile.k, p.half_sweeps
    signs = stam._bnd_signs(b)
    for ci in range(chunks.count):
        c0, c1, lo, hi = chunks.rows(ci, H)
        for ty0 in range(1, n + 1, tile.ty):
            for tz0 in range(1, n + 1, tile.tz):
                blk = _Block(n, ty0, tz0, tile, H)
                # the block's planes lo .. hi, its tile and K-deep halo
                shape = (hi - lo + 1, blk.rows, blk.W)
                X, X0 = (torch.zeros(shape, dtype=x0.dtype)
                         for _ in range(2))
                ys, zs = blk.ys, blk.zs
                r = slice(lo, min(hi, rows - 1) + 1)
                yg = slice(max(ys, 0), min(ys + shape[1], N))
                zg = slice(max(zs, 0), min(zs + shape[2], N))
                yl = slice(yg.start - ys, yg.stop - ys)
                zl = slice(zg.start - zs, zg.stop - zs)
                m = r.stop - r.start
                if src is not None:
                    X[:m, yl, zl] = src[r, yg, zg]
                X0[:m, yl, zl] = x0[r, yg, zg]
                X, X0 = blk.pack(X), blk.pack(X0)
                for s in range(max(c0 - (H - 1), chunks.r_lo), c1 + H - 1):
                    # one colour for every level of the step
                    act = (p.parity + gx0 + s + ys + zs + 1) & 1
                    for h in range(H):
                        q, e = s - h, H - 1 - h
                        if (max(c0 - e, chunks.r_lo) <= q
                                <= min(c1 - 1 + e, chunks.r_hi)):
                            _level(X, X0, blk, q - lo, gx0 + q, h, act,
                                   p.first and h == 0, signs, a, c_inv)
                    q = s - (H - 1)
                    if q >= c0:
                        y1, z1 = min(ty0 + tile.ty, n + 1), \
                            min(tz0 + tile.tz, n + 1)
                        dst[q, ty0:y1, tz0:z1] = blk.unpack(X[q - lo])[
                            K:K + y1 - ty0, K:K + z1 - tz0]


def _level(X, X0, blk, qi, I, h, act, first, signs, a, c_inv):
    """Level h on block plane qi (global row I): the slots of colour
    ``act``, lane by lane inside the cone, in place, each read from the
    words the kernel reads (x0, x and y neighbours and the cell's own
    slot whole words; the z taps words c-1+b .. c+V-1+b of the other
    colour)."""
    n, HW = blk.n, blk.HW
    sx, sy, sz = signs
    ok = blk.cone[act][h]
    A, B = X[qi, act], X[qi, 1 - act]

    def words(arr, idx):
        # a word outside the array lies in a slot outside every cone
        return arr[idx.clamp(0, blk.size - 1)]

    idx, bb = blk.idx, blk.b[act]
    own = A[idx]
    xm, xp = X[qi - 1, act][idx], X[qi + 1, act][idx]
    ym, yp = words(B, idx - HW), words(B, idx + HW)
    zm, zp = words(B, idx - 1 + bb), words(B, idx + bb)
    if not first:
        Kl = blk.kl[act]
        taps = blk.face | (I == 1) | (I == n)
        xm = torch.where(taps & (I == 1), sx * own, xm)
        xp = torch.where(taps & (I == n), sx * own, xp)
        ym = torch.where(taps & (blk.J == 1), sy * own, ym)
        yp = torch.where(taps & (blk.J == n), sy * own, yp)
        zm = torch.where(taps & (Kl == 1), sz * own, zm)
        zp = torch.where(taps & (Kl == n), sz * own, zp)
    nb = xm + xp + ym + yp + zm + zp
    new = (X0[qi, act][idx] + a * nb) * c_inv
    A[idx[ok]] = new[ok]


def emulate_dense(b, x, x0, a, c, iters, tile, slots,
                  dtype=torch.float32):
    """kernels.lin_solve3d_rb's launches, each pass emulated; with
    ``dtype`` bfloat16 lin_solve3d_rb_bf16's (the operands cast and
    rounded as the wrapper casts them, the result back to float32)."""
    if dtype == torch.bfloat16:
        x, x0, a, c_inv = kernels._bf16_operands(x, x0, a, c)
    else:
        c_inv = 1.0 / c
    out, tmp = (torch.full_like(x0, float("nan")) for _ in range(2))
    chunks = kernels.rb_chunks(x0.shape[0], 0, x0.shape[0] - 2, tile, slots)
    passes = kernels.rb_passes(2 * iters, tile.k)
    src = x
    for i, p in enumerate(passes):
        dst = out if kernels.rb_lands_in_out(i, len(passes)) else tmp
        emulate_pass(src, x0, dst, 0, chunks, p, b, a, c_inv, tile)
        src = dst
    return stam._set_bnd3d_(b, out).float()


def _exchange(slabs, halo, b):
    """The pad refresh of grid_sharded._refresh_pad_ over a world of
    slabs held in one process."""
    sx = stam._bnd_signs(b)[0]
    c = slabs[0].shape[0] - 2 * halo
    edges = [(q[halo:2 * halo].clone(), q[c:c + halo].clone())
             for q in slabs]
    for r, q in enumerate(slabs):
        if r == 0:
            q[:halo - 1] = 0.0
            q[halo - 1] = sx * q[halo]
        else:
            q[:halo] = edges[r - 1][1]
        if r == len(slabs) - 1:
            q[halo + c] = sx * q[halo + c - 1]
            q[halo + c + 1:] = 0.0
        else:
            q[halo + c:] = edges[r + 1][0]


def emulate_world(b, x, x0, a, c, iters, fuse, world, tile, slots):
    """kernels.lin_solve3d_rb_shard on each slab of a world, passes in
    lockstep, each launch emulated; the owned rows stitched."""
    n = x0.shape[0] - 2
    halo, c_local = 2 * fuse, n // world

    def cut(f, r):
        gx0 = r * c_local + 1 - halo
        out = torch.zeros((c_local + 2 * halo, n + 2, n + 2))
        for i in range(out.shape[0]):
            if 0 <= gx0 + i <= n + 1:
                out[i] = f[gx0 + i]
        return out, gx0

    x0s = [cut(x0, r) for r in range(world)]
    srcs = [None if x is None else cut(x, r)[0] for r in range(world)]
    bufs = [[torch.full_like(x0s[0][0], float("nan")) for _ in range(2)]
            for _ in range(world)]
    chunks = [kernels.rb_chunks(x0s[0][0].shape[0], gx0, n, tile, slots)
              for _, gx0 in x0s]
    launches = 0
    for sp in range(iters // fuse):
        if sp:
            _exchange(srcs, halo, b)
        for p in kernels.rb_passes(2 * fuse, tile.k, first=sp == 0):
            for r in range(world):
                dst = bufs[r][launches % 2]
                emulate_pass(srcs[r], x0s[r][0], dst, x0s[r][1], chunks[r],
                             p, b, a, 1.0 / c, tile)
                srcs[r] = dst
            launches += 1
    owned = torch.cat([q[halo:halo + c_local] for q in srcs])
    return kernels._set_bnd_yz_(b, owned)


def _fields(n, b, seed):
    """x0, a set_bnd-consistent guess and a raw guess (ghosts the rule
    would change)."""
    rng = np.random.default_rng(seed)
    x0, raw = (torch.from_numpy(rng.normal(0, 1, (n + 2,) * 3).astype(
        np.float32)) for _ in range(2))
    return x0, stam.set_bnd3d(b, raw), raw


def _tile(k, ty, tz):
    return kernels.RbTile(k, ty, tz)


# (n, tile, slots, iters): n below the tile, not a multiple of it, odd
# and even; iters not a multiple of k / 2; slots that force several
# x-chunks
DENSE = [(9, (2, 4, 4), 5, 3), (10, (3, 8, 6), 4, 5), (13, (4, 6, 8), 8, 4),
         (16, (4, 4, 8), 3, 5), (18, (3, 8, 8), 6, 2)]


@pytest.mark.parametrize("n,tile,slots,iters", DENSE,
                         ids=[f"n{d[0]}_k{d[1][0]}" for d in DENSE])
def test_emulated_dense_solve_is_bitwise_plain(n, tile, slots, iters):
    tile = _tile(*tile)
    x0, consistent, raw = _fields(n, 0, n)
    a = 0.05 * 1e-5 * n * n
    for b, guess, coeffs in ((n % 4, None, (1.0, 6.0)),
                             ((n + 1) % 4, consistent, (a, 1 + 6 * a)),
                             ((n + 2) % 4, raw, (1.0, 6.0))):
        want = kernels.lin_solve3d_rb_plain(b, guess, x0, *coeffs, iters)
        got = emulate_dense(b, guess, x0, *coeffs, iters, tile, slots)
        assert torch.equal(got, want), (b, guess is None)


# (n, tile, slots, iters): odd iteration counts, and slots that force
# several x-chunks (9 and 13: chunks of a few rows)
DENSE_BF16 = [(9, (4, 4, 4), 2, 3), (12, (4, 8, 6), 7, 5),
              (15, (4, 6, 8), 4, 1), (18, (3, 8, 8), 3, 3)]


@pytest.mark.parametrize("n,tile,slots,iters", DENSE_BF16,
                         ids=[f"n{d[0]}_k{d[1][0]}" for d in DENSE_BF16])
def test_emulated_bf16_dense_solve_is_bitwise_plain(n, tile, slots, iters):
    """Every b, the zero, set_bnd-consistent and raw guesses, the
    pressure and a diffusion's coefficients, in bfloat16 storage."""
    tile = _tile(*tile)
    x0, consistent, raw = _fields(n, 0, 100 + n)
    a = 0.05 * 1e-5 * 64 * 64
    for b in range(4):
        for guess in (None, consistent, raw):
            coeffs = (1.0, 6.0) if (b + n) % 2 else (a, 1 + 6 * a)
            want = kernels.lin_solve3d_rb_bf16_plain(b, guess, x0, *coeffs,
                                                     iters)
            got = emulate_dense(b, guess, x0, *coeffs, iters, tile, slots,
                                torch.bfloat16)
            assert torch.equal(got, want), (b, guess is None)


def test_emulated_bf16_solve_is_bitwise_pallas():
    """The bfloat16 emulation of the kernel's shape (RB_TILE's k on a
    smaller tile, several chunks) against the reference's interpret-mode
    red-black solve in bfloat16 at 14^3, on the interior."""
    n, b, iters = 14, 2, 4
    rng = np.random.default_rng(7)
    x, x0 = (rng.normal(0, 1, (n + 2,) * 3).astype(np.float32)
             for _ in range(2))
    x = stam.set_bnd3d(b, torch.from_numpy(x)).numpy()
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pk.lin_solve3d_pallas(
            b, jnp.asarray(x), jnp.asarray(x0), 1.0, 6.0, iters,
            red_black=True, tx=4, fuse=1, dtype=jnp.bfloat16))
    got = emulate_dense(b, torch.from_numpy(x), torch.from_numpy(x0), 1.0,
                        6.0, iters, _tile(kernels.RB_TILE.k, 8, 8), 5,
                        torch.bfloat16)
    np.testing.assert_array_equal(got.numpy()[1:-1, 1:-1, 1:-1],
                                  ref[1:-1, 1:-1, 1:-1])


def _slot_geometry(n, tile, cells=CELLS):
    """(a slot holds cells on both sides of the z face K = 1 or K = n,
    some tile's z-extent ends inside a slot): a slot spans 2 cells z
    cells of both colours, from halo kz = 0 mod 2 cells."""
    span, straddles, ends_inside = 2 * cells, False, False
    for tz0 in range(1, n + 1, tile.tz):
        zs = tz0 - tile.k
        ends_inside |= (min(tz0 + tile.tz - 1, n) - zs) % span != span - 1
        straddles |= any(0 < (face - zs) % span < span - 1
                         for face in (1, n)
                         if 0 <= face - zs < halo_width(tile, cells))
    return straddles, ends_inside


# (n, tile, slots, iters, dtype): the shipped shapes and smaller tiles,
# each with slots across a z face and tiles ending inside a slot; odd
# iters end in a pass of 2 half-sweeps after passes of 4, and k = 2
# makes every pass one of 2
SLOT_CASES = [(22, kernels.RB_TILE, 3, 3, torch.float32),
              (22, kernels.RB_TILE_SMALL, 3, 3, torch.float32),
              (22, kernels.RB_TILE_BF16, 3, 3, torch.bfloat16),
              (14, _tile(4, 6, 10), 4, 5, torch.float32),
              (13, _tile(2, 4, 6), 5, 2, torch.float32)]


@pytest.mark.parametrize("n,tile,slots,iters,dtype", SLOT_CASES,
                         ids=[f"n{q[0]}_k{q[1].k}_{q[1].ty}x{q[1].tz}_"
                              f"{str(q[4]).removeprefix('torch.')}"
                              for q in SLOT_CASES])
def test_emulated_slots_at_faces_and_tile_ends_are_bitwise_plain(
        n, tile, slots, iters, dtype):
    """Slots that straddle a z face (and rows on a y face), tiles whose
    z-extent ends inside a slot, passes of H = 2 and 4 half-sweeps: the
    emulation of the kernel's slots in ``dtype`` against the plain solve,
    every b, zero and raw guesses."""
    assert _slot_geometry(n, tile) == (True, True)
    assert {p.half_sweeps for p in kernels.rb_passes(2 * iters, tile.k)} \
        == ({2, 4} if tile.k == 4 else {2})
    x0, _, raw = _fields(n, 0, 200 + n)
    plain = (kernels.lin_solve3d_rb_bf16_plain if dtype == torch.bfloat16
             else kernels.lin_solve3d_rb_plain)
    for b in range(4):
        guess = raw if b % 2 else None
        want = plain(b, guess, x0, 1.0, 6.0, iters)
        got = emulate_dense(b, guess, x0, 1.0, 6.0, iters, tile, slots,
                            dtype)
        assert torch.equal(got, want), b


# (n, world, fuse, passes, tile, slots)
SLABS = [(12, 1, 2, 2, (4, 4, 8), 3), (12, 2, 1, 5, (2, 4, 4), 4),
         (16, 2, 2, 2, (3, 8, 6), 2), (16, 2, 4, 2, (4, 6, 8), 5),
         (10, 1, 4, 1, (4, 4, 4), 2), (11, 1, 1, 3, (3, 4, 6), 3)]


@pytest.mark.parametrize("n,world,fuse,passes,tile,slots", SLABS,
                         ids=[f"n{s[0]}_w{s[1]}_f{s[2]}" for s in SLABS])
def test_emulated_slab_solve_is_bitwise_plain(n, world, fuse, passes, tile,
                                              slots):
    """Stitched emulated slabs against the dense plain solve; a world of
    1 also against the plain slab solve itself (which takes even slabs
    only)."""
    tile = _tile(*tile)
    iters = fuse * passes
    for b, zero in ((n % 4, True), ((n + 3) % 4, False)):
        x0, consistent, _ = _fields(n, b, n + b)
        guess = None if zero else consistent
        got = emulate_world(b, guess, x0, 1.0, 6.0, iters, fuse, world,
                            tile, slots)
        dense = kernels.lin_solve3d_rb_plain(b, guess, x0, 1.0, 6.0, iters)
        assert torch.equal(got, dense[1:-1]), (b, zero)
        if world == 1 and not zero and n % 2 == 0:
            halo = 2 * fuse
            pad = torch.zeros((n + 2 * halo, n + 2, n + 2))
            pad[halo - 1:halo + n + 1] = consistent
            x0p = torch.zeros_like(pad)
            x0p[halo - 1:halo + n + 1] = x0
            mesh_x = pad.clone()
            want = kernels.lin_solve3d_rb_shard_plain(
                b, mesh_x, x0p, 1.0, 6.0, iters, gx0=1 - halo, fuse=fuse,
                exchange=lambda q: _exchange([q], halo, b))
            assert torch.equal(got, want)


@pytest.mark.parametrize("iters", range(1, 12))
@pytest.mark.parametrize("k", [2, 3, 4, 6, 8])
def test_passes_cover_every_half_sweep_and_end_in_out(k, iters):
    passes = kernels.rb_passes(2 * iters, k)
    assert sum(p.half_sweeps for p in passes) == 2 * iters
    assert all(1 <= p.half_sweeps <= k for p in passes)
    assert len(passes) == -(-2 * iters // k)
    assert [p.first for p in passes] == [True] + [False] * (len(passes) - 1)
    done = 0
    for p in passes:
        assert p.parity == done % 2
        done += p.half_sweeps
    lands = [kernels.rb_lands_in_out(i, len(passes))
             for i in range(len(passes))]
    assert lands[-1] and all(a != b for a, b in zip(lands, lands[1:]))
    assert not any(p.first for p in kernels.rb_passes(2 * iters, k,
                                                      first=False))


# the kernels' shapes (the float32 red-black ones, 32 x 64 and 16 x 32,
# shipped), and shapes of other depths and tiles
CHUNK_TILES = list(dict.fromkeys([
    kernels.RB_TILE, kernels.RB_TILE_SMALL, kernels.RB_TILE_BF16,
    kernels.JACOBI_TILE_BF16, kernels.JACOBI_TILE, _tile(2, 4, 4),
    _tile(4, 16, 64), _tile(6, 16, 64), _tile(8, 32, 32)]))


@pytest.mark.parametrize("tile", CHUNK_TILES,
                         ids=lambda t: f"k{t.k}_{t.ty}x{t.tz}")
def test_chunks_cover_every_row_without_gaps(tile):
    for n in range(4, 41):
        for rows, gx0 in ((n + 2, 0), (n // 2 + 8, -3), (n // 2 + 8, n // 3),
                          (n // 2 + 8, n // 2 - 2)):
            for slots in (1, 7, 132, 264):
                ch = kernels.rb_chunks(rows, gx0, n, tile, slots)
                assert ch.r_lo == max(1, 1 - gx0)
                assert ch.r_hi == min(n - gx0, rows - 2)
                owned = []
                for i in range(ch.count):
                    c0, c1, lo, hi = ch.rows(i, tile.k)
                    assert c0 < c1
                    assert lo == max(c0 - tile.k + 1, ch.r_lo) - 1 >= 0
                    assert hi == c1 + tile.k - 1
                    owned += range(c0, c1)
                assert owned == list(range(ch.r_lo, ch.r_hi + 1))


@pytest.mark.parametrize("slots", [132, 264])
def test_chunks_fill_the_card_at_256(slots):
    """At 256^3 the dense solve's tiles of RB_TILE run in x-chunks that
    fill most of one wave of resident blocks (132 multiprocessors, one
    or two blocks each) and no more."""
    ch = kernels.rb_chunks(258, 0, 256, kernels.RB_TILE, slots)
    blocks = kernels.RB_TILE.tiles(256) * ch.count
    assert 0.75 * slots <= blocks <= slots


@pytest.mark.parametrize("tile,slots", [(kernels.RB_TILE_BF16, 132),
                                        (kernels.JACOBI_TILE_BF16, 264)],
                         ids=["rb_bf16", "jacobi_bf16"])
def test_bf16_chunks_fill_the_card_at_512(tile, slots):
    """At config 3's 512^3 the bfloat16 kernels' tiles run in x-chunks
    that fill most of each wave of resident blocks (one a multiprocessor
    for the red-black kernel, two for the Jacobi one): 88 red-black tiles
    in 3 chunks make two full waves of 132."""
    ch = kernels.rb_chunks(514, 0, 512, tile, slots)
    blocks = tile.tiles(512) * ch.count
    waves = -(-blocks // slots)
    assert 0.75 * waves * slots <= blocks <= waves * slots
    assert waves <= 2


def test_rb_tile_follows_the_storage_type():
    """The float32 shape by n (the small one up to RB_SMALL_N: multigrid's
    coarse levels and the 64^3 plume), one bfloat16 shape, all of one
    depth k (the pass schedule's)."""
    small = kernels.RB_SMALL_N
    for n in (256, 128, small + 1):
        assert kernels.rb_tile(torch.float32, n) == kernels.RB_TILE
    for n in (small, 32, 16, 8, 3):
        assert kernels.rb_tile(torch.float32, n) == kernels.RB_TILE_SMALL
    for n in (512, 256, small, 8):
        assert kernels.rb_tile(torch.bfloat16, n) == kernels.RB_TILE_BF16
    assert (kernels.RB_TILE_BF16.k == kernels.RB_TILE_SMALL.k
            == kernels.RB_TILE.k)
    # a halo row of the shipped tiles holds whole slots of each colour
    for tile in (kernels.RB_TILE, kernels.RB_TILE_SMALL,
                 kernels.RB_TILE_BF16):
        assert halo_width(tile) == tile.tz + 2 * tile.k


def test_rejects_a_field_without_interior_rows():
    with pytest.raises(ValueError):
        kernels.rb_chunks(6, 20, 16, kernels.RB_TILE, 132)
