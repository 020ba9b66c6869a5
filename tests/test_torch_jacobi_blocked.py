"""The blocked Jacobi passes (csrc/jacobi_blocked.cu) in float32 and
bfloat16 storage, on the CPU: the pass schedule of
tpufluids_torch.grid.kernels, the Jacobi tiles' x-chunks, and a torch
emulation of the kernel held against the plain solves.

The emulation does what one block of the kernel does: over its chunk and
its halo rows, level h computes sweep h of the tile widened by H-1-h
cells, and of the chunk widened by H-1-h rows, clipped to the interior,
from level h-1's values (the pass's input, its stored ghosts included,
for level 0); a tap across a face after level 0 is the cell's own level
h-1 value times the face's sign.  Each level's values start as NaN, so a
read outside the cone of the level below shows in the result.  The last
level writes the tile's cells and every ghost whose clamped interior
cell is among them.  Passes alternate between two buffers of the storage
type that start as NaN, so a cell that no pass wrote shows too.
Tolerances: bit for bit against lin_solve3d_plain and
lin_solve3d_bf16_plain, which do the same operations in the same order,
each rounded to the storage type (as the kernel's float2 and bf16x2
operations round); against interpret-mode
lin_solve3d_pallas(dtype=bfloat16) bit for bit on the interior of
set_bnd-consistent inputs, as tests/test_torch_bf16.py holds the plain
solve, and against lin_solve3d_pallas(dtype=float32) within 1e-6 of
max|reference|, the plain float32 solves' tolerance against the Pallas
kernels (tests/test_torch_jacobi.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpufluids.grid import pallas_kernels as pk
from tpufluids_torch.grid import kernels, stam

NAN = float("nan")
F32, BF16 = torch.float32, torch.bfloat16
PLAIN = {F32: kernels.lin_solve3d_plain, BF16: kernels.lin_solve3d_bf16_plain}


def _images(lo, hi, n, sign):
    """(output index, source index in the computed range lo .. hi, sign)
    along one axis: the cells themselves, and the ghost beside each face
    cell in the range."""
    out = [(slice(lo, hi + 1), slice(0, hi - lo + 1), 1.0)]
    if lo == 1:
        out.append((slice(0, 1), slice(0, 1), sign))
    if hi == n:
        out.append((slice(n + 1, n + 2), slice(hi - lo, hi - lo + 1), sign))
    return out


def emulate_pass(src, x0, dst, chunks, sweeps, b, a, c_inv, tile):
    """One launch of the blocked Jacobi kernel: ``sweeps`` sweeps from
    ``src`` (None: zeros) into ``dst``, block by block."""
    n = x0.shape[0] - 2
    N, F, H = n + 2, tile.k, sweeps
    sx, sy, sz = stam._bnd_signs(b)
    for ci in range(chunks.count):
        c0, c1, lo, hi = chunks.rows(ci, H)
        for ty0 in range(1, n + 1, tile.ty):
            for tz0 in range(1, n + 1, tile.tz):
                # the block's rows lo .. hi, its tile and F-deep halo (a
                # cell deeper a side in z)
                ys, zs = ty0 - F, tz0 - F - 1
                shape = (hi - lo + 1, tile.ty + 2 * F, tile.tz + 2 * F + 2)
                X = torch.zeros(shape, dtype=x0.dtype)
                X0 = torch.zeros(shape, dtype=x0.dtype)
                yg = slice(max(ys, 0), min(ys + shape[1], N))
                zg = slice(max(zs, 0), min(zs + shape[2], N))
                yl = slice(yg.start - ys, yg.stop - ys)
                zl = slice(zg.start - zs, zg.stop - zs)
                m = min(hi, N - 1) + 1 - lo   # rows past the array: zeros
                if src is not None:
                    X[:m, yl, zl] = src[lo:lo + m, yg, zg]
                X0[:m, yl, zl] = x0[lo:lo + m, yg, zg]
                for h in range(H):
                    e = H - 1 - h
                    Y = torch.full(shape, NAN, dtype=x0.dtype)
                    jlo, jhi = max(1, ty0 - e), min(n, ty0 + tile.ty - 1 + e)
                    zlo, zhi = max(1, tz0 - e), min(n, tz0 + tile.tz - 1 + e)
                    y0, y1 = jlo - ys, jhi - ys + 1
                    z0, z1 = zlo - zs, zhi - zs + 1
                    J = torch.arange(jlo, jhi + 1)[:, None]
                    Kc = torch.arange(zlo, zhi + 1)[None, :]
                    for q in range(max(c0 - e, chunks.r_lo),
                                   min(c1 - 1 + e, chunks.r_hi) + 1):
                        qi = q - lo
                        P = X[qi]
                        own = P[y0:y1, z0:z1]
                        xm = X[qi - 1, y0:y1, z0:z1]
                        xp = X[qi + 1, y0:y1, z0:z1]
                        ym, yp = P[y0 - 1:y1 - 1, z0:z1], P[y0 + 1:y1 + 1,
                                                            z0:z1]
                        zm, zp = P[y0:y1, z0 - 1:z1 - 1], P[y0:y1,
                                                            z0 + 1:z1 + 1]
                        if h > 0:
                            xm = sx * own if q == 1 else xm
                            xp = sx * own if q == n else xp
                            ym = torch.where(J == 1, sy * own, ym)
                            yp = torch.where(J == n, sy * own, yp)
                            zm = torch.where(Kc == 1, sz * own, zm)
                            zp = torch.where(Kc == n, sz * own, zp)
                        nb = xm + xp + ym + yp + zm + zp
                        v = (X0[qi, y0:y1, z0:z1] + a * nb) * c_inv
                        if h < H - 1:
                            Y[qi, y0:y1, z0:z1] = v
                            continue
                        for xd, _, si in _images(q, q, n, sx):
                            for yd, yv, sj in _images(jlo, jhi, n, sy):
                                for zd, zv, sk in _images(zlo, zhi, n, sz):
                                    dst[xd, yd, zd] = (si * sj * sk) * v[yv,
                                                                         zv]
                    X = Y


def emulate_solve(b, x, x0, a, c, iters, tile, slots, dtype=BF16):
    """The launches of kernels.lin_solve3d_bf16 (``dtype`` bfloat16) or
    kernels.lin_solve3d (float32), each pass emulated."""
    if dtype == BF16:
        x, x0, a, c_inv = kernels._bf16_operands(x, x0, a, c)
    else:
        c_inv = 1.0 / c
    n = x0.shape[0] - 2
    chunks = kernels.rb_chunks(n + 2, 0, n, tile, slots)
    passes = kernels.jacobi_passes(iters, tile.k)
    out, tmp = (torch.full_like(x0, NAN) for _ in range(2))
    src = x
    for i, sweeps in enumerate(passes):
        dst = out if kernels.rb_lands_in_out(i, len(passes)) else tmp
        emulate_pass(src, x0, dst, chunks, sweeps, b, a, c_inv, tile)
        src = dst
    return out.float()


def _fields(n, b, seed):
    """x0, a set_bnd-consistent guess and a raw guess (ghosts the rule
    would change)."""
    rng = np.random.default_rng(seed)
    x0, raw = (torch.from_numpy(rng.normal(0, 1, (n + 2,) * 3).astype(
        np.float32)) for _ in range(2))
    return x0, stam.set_bnd3d(b, raw), raw


def _tile(k, ty, tz):
    return kernels.RbTile(k, ty, tz)


# (n, tile, slots, iters): n below the tile and not a multiple of it, odd
# and even (n + 2 odd and even), odd iteration counts (a last pass of one
# sweep), slots that force several x-chunks, and a deeper pass (k 4)
SOLVES = [(9, (2, 4, 4), 5, 3), (10, (2, 8, 6), 4, 5), (13, (2, 6, 8), 8, 4),
          (16, (2, 4, 8), 3, 1), (18, (2, 8, 8), 6, 2), (11, (4, 4, 8), 4, 7)]


def _solves_are_bitwise_plain(n, tile, slots, iters, dtype):
    tile = _tile(*tile)
    x0, consistent, raw = _fields(n, 0, n)
    a = 0.05 * 1e-5 * 64 * 64
    for b in range(4):
        for guess in (None, consistent, raw):
            coeffs = (1.0, 6.0) if (b + n) % 2 else (a, 1 + 6 * a)
            want = PLAIN[dtype](b, guess, x0, *coeffs, iters)
            got = emulate_solve(b, guess, x0, *coeffs, iters, tile, slots,
                                dtype)
            assert torch.equal(got, want), (b, guess is None)


SOLVE_IDS = [f"n{d[0]}_k{d[1][0]}_i{d[3]}" for d in SOLVES]


@pytest.mark.parametrize("n,tile,slots,iters", SOLVES, ids=SOLVE_IDS)
def test_emulated_solve_is_bitwise_plain(n, tile, slots, iters):
    """bfloat16: every b, the zero, set_bnd-consistent and raw guesses,
    the pressure and a diffusion's coefficients."""
    _solves_are_bitwise_plain(n, tile, slots, iters, BF16)


@pytest.mark.parametrize("n,tile,slots,iters", SOLVES, ids=SOLVE_IDS)
def test_emulated_float32_solve_is_bitwise_plain(n, tile, slots, iters):
    """The same cases in float32 storage, against lin_solve3d_plain."""
    _solves_are_bitwise_plain(n, tile, slots, iters, F32)


def test_emulated_solve_keeps_negative_zero_and_tiny_values():
    """x0 with -0, subnormal-range and tiny values from a zero guess: the
    first sweep goes through x0 + a * 0 as the plain solve does."""
    n = 10
    x0 = torch.zeros((n + 2,) * 3)
    x0[1:-1:2] = -0.0
    x0[2:-1:3, 2:5] = 1e-39
    x0[3, 3:6, 1:-1] = -3e-38
    x0[5, 1:-1, 4] = 2.0 ** -133
    for iters in (1, 2):
        want = kernels.lin_solve3d_bf16_plain(0, None, x0, 1.0, 6.0, iters)
        got = emulate_solve(0, None, x0, 1.0, 6.0, iters,
                            kernels.JACOBI_TILE_BF16, 3)
        assert torch.equal(torch.signbit(got), torch.signbit(want))
        assert torch.equal(got, want)


def test_emulated_solve_is_bitwise_pallas():
    """The emulation of the kernel's depth (JACOBI_TILE_BF16's k on a
    smaller tile, several chunks) against the reference's interpret-mode
    bfloat16 Jacobi solve at its route's fuse of 2, at 14^3, on the
    interior."""
    n, b, iters = 14, 3, 4
    rng = np.random.default_rng(8)
    x, x0 = (rng.normal(0, 1, (n + 2,) * 3).astype(np.float32)
             for _ in range(2))
    x = stam.set_bnd3d(b, torch.from_numpy(x)).numpy()
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pk.lin_solve3d_pallas(
            b, jnp.asarray(x), jnp.asarray(x0), 1.0, 6.0, iters, tx=4,
            fuse=2, dtype=jnp.bfloat16))
    got = emulate_solve(b, torch.from_numpy(x), torch.from_numpy(x0), 1.0,
                        6.0, iters, _tile(kernels.JACOBI_TILE_BF16.k, 8, 8),
                        5)
    np.testing.assert_array_equal(got.numpy()[1:-1, 1:-1, 1:-1],
                                  ref[1:-1, 1:-1, 1:-1])


def test_emulated_float32_solve_matches_pallas():
    """The float32 emulation at the kernel's depth (JACOBI_TILE's k on a
    smaller tile, several chunks) against the reference's interpret-mode
    float32 Jacobi solve at fuse 2 (its route for an even sweep count),
    at 15^3 (n + 2 odd), within 1e-6 of max|reference|."""
    n, b, iters = 15, 2, 4
    rng = np.random.default_rng(9)
    x, x0 = (rng.normal(0, 1, (n + 2,) * 3).astype(np.float32)
             for _ in range(2))
    x = stam.set_bnd3d(b, torch.from_numpy(x)).numpy()
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pk.lin_solve3d_pallas(
            b, jnp.asarray(x), jnp.asarray(x0), 1.0, 6.0, iters, tx=4,
            fuse=2, dtype=jnp.float32))
    got = emulate_solve(b, torch.from_numpy(x), torch.from_numpy(x0), 1.0,
                        6.0, iters, _tile(kernels.JACOBI_TILE.k, 8, 8), 5,
                        F32).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 * float(np.abs(ref).max()))


@pytest.mark.parametrize("iters", [1, 2, 3, 5, 20])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_passes_cover_every_sweep_and_end_in_out(k, iters):
    passes = kernels.jacobi_passes(iters, k)
    assert sum(passes) == iters
    assert all(1 <= p <= k for p in passes)
    assert passes[:-1] == [k] * (len(passes) - 1)
    assert len(passes) == -(-iters // k)
    lands = [kernels.rb_lands_in_out(i, len(passes))
             for i in range(len(passes))]
    assert lands[-1] and all(a != b for a, b in zip(lands, lands[1:]))


def test_main_path_solve_is_eleven_launches_at_most():
    """Twenty sweeps at the bfloat16 kernel's depth: ten launches; 21:
    eleven."""
    assert len(kernels.jacobi_passes(20, kernels.JACOBI_TILE_BF16.k)) == 10
    assert kernels.jacobi_passes(21, kernels.JACOBI_TILE_BF16.k)[-1] == 1


def test_float32_main_path_solve_is_ten_launches_at_most():
    """Twenty sweeps at the float32 kernel's depth: ceil(20 / k) launches,
    at most ten, where the design it replaced made twenty."""
    k = kernels.JACOBI_TILE.k
    assert len(kernels.jacobi_passes(20, k)) == -(-20 // k) <= 10
    assert sum(kernels.jacobi_passes(21, k)) == 21


def test_jacobi_tile_follows_the_storage_type():
    assert kernels.jacobi_tile(F32) == kernels.JACOBI_TILE
    assert kernels.jacobi_tile(BF16) == kernels.JACOBI_TILE_BF16


@pytest.mark.parametrize("slots", [132, 264])
def test_chunks_fill_the_card_at_256(slots):
    """At 256^3 the bfloat16 Jacobi tiles run in x-chunks that fill most
    of one wave of resident blocks and no more."""
    ch = kernels.rb_chunks(258, 0, 256, kernels.JACOBI_TILE_BF16, slots)
    blocks = kernels.JACOBI_TILE_BF16.tiles(256) * ch.count
    assert 0.75 * slots <= blocks <= slots


@pytest.mark.parametrize("slots", [132, 264, 396])
def test_float32_chunks_fill_the_card_at_256(slots):
    """At the main path's 256^3 the float32 Jacobi tiles run in x-chunks
    that fill most of one wave of resident blocks (one to three a
    multiprocessor) and no more."""
    ch = kernels.rb_chunks(258, 0, 256, kernels.JACOBI_TILE, slots)
    blocks = kernels.JACOBI_TILE.tiles(256) * ch.count
    assert 0.75 * slots <= blocks <= slots
