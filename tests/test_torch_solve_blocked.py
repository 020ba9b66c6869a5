"""The whole solves' blocked schedules on the CPU: a tile-by-tile,
level-by-level torch emulation of the 3D whole solve and the multi-field
diffusion (csrc/jacobi.cu with the passes of csrc/step_blocked.cuh) and
of the 2D solve (csrc/grid2d.cu with those of csrc/step2d_blocked.cuh),
with their plans (kernels.solve_plan, diffuse_plan, solve2d_plan), halo
cones, ghost rules, x0 kept or reloaded, and buffer plans, held bit for
bit against kernels.lin_solve3d_whole_plain, diffuse3d_multi_plain and
lin_solve2d_plain; the plans against the card's blocks and shared
memory; and a hand count of each call's grid-wide barriers.

The emulation does what the blocks of a kernel do, pass by pass: block k
takes tiles (in the diffusion, (field, tile) pairs) k, k + blocks, ...;
each loads its box from the guess (a zero box for none) or from the
buffer the previous pass wrote, runs the
levels inside the shrinking cone, a level's cells written into a box
whose other cells are NaN (the kernel's shared memory holds stale values
there), and writes its tile, or its owned cells with their ghosts.  A
block that holds one tile keeps the x0 it loaded in the first pass; one
with several loads x0 with each.  Every output and scratch buffer starts
as NaN, so a read of a cell that no pass wrote shows in the result.  In
bfloat16 the boxes hold bfloat16 and every operation rounds to it, as
the kernel's do.

Tolerances: bit for bit against the plain solves, since the emulation
does their operations in their order.  Against the JAX package at the
smallest size (the interpret-mode Pallas kernels, on set_bnd-consistent
guesses, as tests/test_torch_bf16.py and tests/test_pallas_kernels.py
run them): in bfloat16 bit for bit on the interior (the Pallas kernels
rebuild the z ghosts); in float32 1e-6 * max|reference|, the plain 3D
solves' tolerance against the Pallas kernels (tests/test_torch_jacobi.py);
in 2D bit for bit at a = 1, c = 4 (tests/test_torch_grid2d.py)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpufluids.grid import pallas_kernels as pk
from tpufluids.grid import stam as jstam
from tpufluids_torch.grid import kernels, stam

NAN = float("nan")
F32, BF16 = torch.float32, torch.bfloat16
# the card's shape: persistent blocks and the shared memory one may take
CARD = (132, 232448)


@pytest.fixture(autouse=True)
def share_of_the_cores():
    """The emulations run thousands of small torch ops: under several
    test workers (pytest-xdist) each worker takes its share of torch's
    threads, or the workers contend for the cores on every op."""
    threads = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, threads // workers))
    yield
    torch.set_num_threads(threads)


class Box:
    """A block's box: tile ``t`` of ``tile`` (3D or 2D) widened by
    ``halo``, clipped to the ghosted array; boxes are NaN-filled tensors
    of ``dtype`` in its coordinates."""

    def __init__(self, tile, t, n, halo, dtype):
        self.n, self.dtype = n, dtype
        self.tile = tile.tile(n, t)
        self.lo = tuple(max(a - halo, 0) for a, _ in self.tile)
        self.hi = tuple(min(b + halo, n + 1) for _, b in self.tile)

    def empty(self):
        return torch.full(tuple(h - l + 1 for l, h in zip(self.lo, self.hi)),
                          NAN, dtype=self.dtype)

    def widen(self, e, lo, hi):
        """The tile widened by e, clipped to [lo, hi]: inclusive ranges."""
        return tuple((max(a - e, lo), min(b + e, hi)) for a, b in self.tile)

    def owned(self):
        """The output cells whose clamped cell lies in the tile."""
        n = self.n
        return tuple((0 if a == 1 else a, n + 1 if b == n else b)
                     for a, b in self.tile)

    def local(self, r, shift=None):
        shift = shift or (0,) * len(r)
        return tuple(slice(a - l + d, b - l + d + 1)
                     for (a, b), l, d in zip(r, self.lo, shift))

    def at(self, coords):
        return tuple(c - l for c, l in zip(coords, self.lo))


def glob(r):
    return tuple(slice(a, b + 1) for a, b in r)


def axes(r):
    """Broadcastable coordinates of region r, one tensor an axis."""
    d = len(r)
    out = []
    for ax, (a, b) in enumerate(r):
        shape = [1] * d
        shape[ax] = b - a + 1
        out.append(torch.arange(a, b + 1).reshape(shape))
    return out


def load(S, box, r, field):
    S[box.local(r)] = field[glob(r)]


def level(S, X0, box, r, first, signs, a, c_inv):
    """(x0 + a * sum of the neighbours) * c_inv on region r of box S, the
    neighbours summed axis by axis, minus before plus: the stored ones if
    ``first``, else a tap across a face is the cell's own value times the
    face's sign."""
    n, d = box.n, len(r)
    own = S[box.local(r)]
    at = axes(r)
    taps = []
    for ax in range(d):
        for step, end in ((-1, 1), (1, n)):
            shift = [0] * d
            shift[ax] = step
            tap = S[box.local(r, shift)]
            if not first:
                tap = torch.where(at[ax] == end, signs[ax] * own, tap)
            taps.append(tap)
    nb = taps[0]
    for tap in taps[1:]:
        nb = nb + tap
    return (X0[box.local(r)] + a * nb) * c_inv


def owned_values(S, box, b):
    """The owned output cells: each the clamped cell's value times its
    set_bnd sign; in 2D a corner is 0.5 (sy c + sx c) (set_bnd2d's
    average of its two edge cells)."""
    n = box.n
    at = axes(box.owned())
    clamped = [q.clamp(1, n) for q in at]
    val = S[box.at(clamped)]
    signs = stam._bnd_signs(b)
    if len(at) == 2:
        xo, yo = clamped[0] != at[0], clamped[1] != at[1]
        corner = 0.5 * (signs[1] * val + signs[0] * val)
        return torch.where(xo & yo, corner, torch.where(
            xo, signs[0] * val, torch.where(yo, signs[1] * val, val)))
    if not b:
        return val
    return torch.where(clamped[b - 1] != at[b - 1], -val, val)


def emulate_fields(fields, iters, red_black, plan):
    """The kernel's passes on ``fields``, each (b, x (None: zeros), x0,
    a, c_inv) in its storage type, with ``plan``: block k takes the
    (field, tile) pairs k, k + blocks, ... (field-major); returns the
    buffer each field's last pass wrote."""
    n = fields[0][2].shape[0] - 2
    outs = [torch.full_like(f[2], NAN) for f in fields]
    tmps = [torch.full_like(f[2], NAN) for f in fields]
    tile, levels = plan.tile, plan.levels
    total = 2 * iters if red_black else iters
    passes = -(-total // levels)
    count = tile.count(n)
    resident = len(fields) * count <= plan.blocks
    shared_x0 = {}  # block -> the x0 box in its shared memory
    for p in range(passes):
        last = p == passes - 1
        h0, H = p * levels, min(levels, total - p * levels)
        for item in range(len(fields) * count):
            f, t, blk = item // count, item % count, item % plan.blocks
            b, x, x0, a, c_inv = fields[f]
            out, tmp = outs[f], tmps[f]
            src = x if p == 0 else (tmp if (passes - p) % 2 else out)
            dst = tmp if (passes - 1 - p) % 2 else out
            signs = stam._bnd_signs(b)
            box = Box(tile, t, n, levels, x0.dtype)
            r = box.widen(H, 0, n + 1)
            if p == 0 or not resident:
                shared_x0[blk] = box.empty()
                load(shared_x0[blk], box, r, x0)
            X0 = shared_x0[blk]
            if src is None:
                S = torch.zeros_like(box.empty())
            else:
                S = box.empty()
                load(S, box, r, src)
            for lv in range(H):
                lr = box.widen(H - 1 - lv, 1, n)
                if red_black:
                    new = level(S, X0, box, lr, h0 + lv == 0, signs, a,
                                c_inv)
                    act = sum(axes(lr)) % 2 == (h0 + lv + 1) % 2
                    S[box.local(lr)] = torch.where(act, new,
                                                   S[box.local(lr)])
                else:
                    D = box.empty()
                    D[box.local(lr)] = level(S, X0, box, lr, lv == 0, signs,
                                             a, c_inv)
                    S = D
            if red_black and not last:
                inner = box.widen(0, 1, n)
                dst[glob(inner)] = S[box.local(inner)]
            else:
                dst[glob(box.owned())] = owned_values(S, box, b)
    return outs


def emulate(b, x, x0, a, c_inv, iters, red_black, plan):
    """The kernel's passes on x (None: zeros) and x0 in their storage
    type, with ``plan``: returns the buffer the last pass wrote."""
    return emulate_fields([(b, x, x0, a, c_inv)], iters, red_black,
                          plan)[0]


def emulate_solve3d(b, x, x0, a, c, iters, red_black, dtype, plan):
    """kernels.lin_solve3d_whole's launch: float32 in and out, the
    kernel's operands in ``dtype`` as kernels._solve_whole_launch passes
    them."""
    if dtype == BF16:
        x, x0, a, c_inv = kernels._bf16_operands(x, x0, a, c)
    else:
        c_inv = 1.0 / c
    return emulate(b, x, x0, a, c_inv, iters, red_black, plan).float()


def emulate_solve2d(b, x, x0, a, c, iters, plan):
    """kernels.lin_solve2d's launch."""
    return emulate(b, x, x0, a, 1.0 / c, iters, False, plan)


def _raw(n, seed, ndim):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0, 1, (n + 2,) * ndim).astype(
        np.float32)) for _ in range(2)]


def _guess(kind, b, x):
    set_bnd = stam.set_bnd3d if x.dim() == 3 else stam.set_bnd2d
    return {"zero": None, "consistent": set_bnd(b, x), "raw": x}[kind]


# the pressure solve's coefficients, and a diffusion's scaled up so that
# the neighbours, halos and buffers show in the result
COEFFS = {"pressure3d": (1.0, 6.0), "diffusion3d": (0.3, 2.8),
          "pressure2d": (1.0, 4.0), "diffusion2d": (0.3, 2.2)}


def _plan3d(n, red_black, dtype, kind):
    """The card's plan, or (blocks, tile): fewer blocks than tiles, each
    block taking several tiles a pass."""
    if kind == "card":
        return kernels.solve_plan(n, red_black, dtype, *CARD)
    blocks, tile = kind
    levels = (kernels.SOLVE_RB_LEVELS if red_black
              else kernels.SOLVE_JACOBI_LEVELS)
    return kernels.SolvePlan(blocks, kernels.SOLVE_THREADS, 0, levels,
                             kernels.StepTile(*tile, levels))


# (n, dtype, red_black, iters, plan, b, guess, coefficients): every b and
# guess in both types and modes, odd and even counts of (half-)sweeps
# that the levels do and do not divide, one pass, the card's plan (one
# tile a block) and few blocks (several tiles a block, uneven tiles, a
# tile as wide as the grid on an axis)
SOLVES3D = [
    (9, F32, False, 5, "card", 0, "zero", "pressure3d"),
    (9, F32, True, 3, "card", 1, "raw", "diffusion3d"),
    (12, BF16, False, 4, "card", 2, "consistent", "diffusion3d"),
    (12, BF16, True, 5, "card", 3, "raw", "pressure3d"),
    (16, F32, True, 7, (5, (5, 7, 16)), 2, "consistent", "pressure3d"),
    (16, F32, False, 6, (4, (6, 16, 5)), 3, "raw", "diffusion3d"),
    (18, BF16, True, 2, (3, (9, 7, 6)), 0, "zero", "diffusion3d"),
    (18, BF16, False, 7, (6, (18, 5, 8)), 1, "raw", "pressure3d"),
    (11, F32, True, 4, (2, (4, 11, 6)), 3, "zero", "diffusion3d"),
    (13, BF16, True, 1, "card", 2, "consistent", "diffusion3d"),
    (10, F32, False, 1, (3, (5, 4, 10)), 1, "consistent", "pressure3d"),
    (14, BF16, False, 3, (5, (7, 7, 4)), 0, "raw", "diffusion3d"),
    (15, F32, True, 6, "card", 0, "consistent", "diffusion3d"),
    (17, F32, False, 8, "card", 2, "raw", "pressure3d"),
]


@pytest.mark.parametrize(
    "n,dtype,red_black,iters,plan,b,guess,coeffs", SOLVES3D,
    ids=[f"n{c[0]}_{str(c[1])[6:]}_{'rb' if c[2] else 'j'}_i{c[3]}_"
         f"{'card' if c[4] == 'card' else 'b' + str(c[4][0])}_b{c[5]}_"
         f"{c[6]}" for c in SOLVES3D])
def test_emulated_solve3d_is_bitwise_plain(n, dtype, red_black, iters, plan,
                                           b, guess, coeffs):
    x, x0 = _raw(n, 7 * n + b, 3)
    card = plan == "card"
    plan = _plan3d(n, red_black, dtype, plan)
    assert (plan.tile.count(n) <= plan.blocks) == card
    a, c = COEFFS[coeffs]
    x = _guess(guess, b, x)
    got = emulate_solve3d(b, x, x0, a, c, iters, red_black, dtype, plan)
    want = kernels.lin_solve3d_whole_plain(b, x, x0, a, c, iters, red_black,
                                           dtype)
    assert torch.equal(got, want)


# (n, iters, plan, b, guess, coefficients): the card's plan, and few
# blocks with uneven tiles
SOLVES2D = [
    (9, 20, "card", 0, "zero", "pressure2d"),
    (16, 7, "card", 1, "raw", "diffusion2d"),
    (23, 13, "card", 2, "consistent", "pressure2d"),
    (40, 23, "card", 0, "raw", "diffusion2d"),
    (20, 11, (3, (7, 9)), 2, "raw", "diffusion2d"),
    (31, 20, (5, (6, 31)), 1, "zero", "diffusion2d"),
    (27, 4, (2, (13, 5)), 0, "consistent", "pressure2d"),
    (12, 1, (2, (5, 5)), 2, "raw", "pressure2d"),
]


@pytest.mark.parametrize(
    "n,iters,plan,b,guess,coeffs", SOLVES2D,
    ids=[f"n{c[0]}_i{c[1]}_{'card' if c[2] == 'card' else 'b' + str(c[2][0])}"
         f"_b{c[3]}_{c[4]}" for c in SOLVES2D])
def test_emulated_solve2d_is_bitwise_plain(n, iters, plan, b, guess, coeffs):
    x, x0 = _raw(n, 11 * n + b, 2)
    if plan == "card":
        plan = kernels.solve2d_plan(n, *CARD)
        assert plan.tile.count(n) <= plan.blocks
    else:
        blocks, tile = plan
        plan = kernels.SolvePlan(blocks, kernels.SOLVE2D_THREADS, 0,
                                 kernels.SOLVE2D_LEVELS,
                                 kernels.Step2dTile(*tile,
                                                    kernels.SOLVE2D_LEVELS))
        assert plan.tile.count(n) > plan.blocks
    a, c = COEFFS[coeffs]
    x = _guess(guess, b, x)
    got = emulate_solve2d(b, x, x0, a, c, iters, plan)
    assert torch.equal(got, kernels.lin_solve2d_plain(b, x, x0, a, c, iters))


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("red_black", [False, True], ids=["jacobi", "rb"])
def test_emulated_solve3d_matches_jax_whole_mode(red_black, dtype):
    """The emulation against the reference's whole-solve mode
    (lin_solve3d_pallas with tx = n + 2 and fuse = iters, interpret
    mode), at 9^3."""
    n, iters, b = 9, 4, 2
    x, x0 = _raw(n, 90, 3)
    x = stam.set_bnd3d(b, x)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pk.lin_solve3d_pallas(
            b, jnp.asarray(x.numpy()), jnp.asarray(x0.numpy()), 1.0, 6.0,
            iters, red_black=red_black, tx=n + 2, fuse=iters,
            dtype=jnp.bfloat16 if dtype == BF16 else jnp.float32))
    plan = kernels.solve_plan(n, red_black, dtype, *CARD)
    got = emulate_solve3d(b, x, x0, 1.0, 6.0, iters, red_black, dtype,
                          plan).numpy()
    if dtype == BF16:
        np.testing.assert_array_equal(got[1:-1, 1:-1, 1:-1],
                                      ref[1:-1, 1:-1, 1:-1])
    else:
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-6 * float(np.abs(ref).max()))


def test_emulated_solve2d_matches_jax_pallas():
    """The 2D emulation against the interpret-mode lin_solve2d_pallas at
    9^2, and against the JAX dense solve."""
    n, iters, b = 9, 6, 1
    x, x0 = _raw(n, 91, 2)
    x = stam.set_bnd2d(b, x)
    jx, jx0 = jnp.asarray(x.numpy()), jnp.asarray(x0.numpy())
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pk.lin_solve2d_pallas(b, jx, jx0, 1.0, 4.0, iters))
    got = emulate_solve2d(b, x, x0, 1.0, 4.0, iters,
                          kernels.solve2d_plan(n, *CARD)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, np.asarray(jstam.lin_solve2d(b, jx, jx0, 1.0, 4.0, iters)))


def emulate_diffuse(xs, params, iters, plan):
    """kernels.diffuse3d_multi's launch: x0 each field itself."""
    return emulate_fields([(b, x, x, a, 1.0 / c) for x, (b, a, c)
                           in zip(xs, params)], iters, False, plan)


def _diffusions(n, k, seed):
    """k fields whose ghosts set_bnd would change (b 1, 2, 0 in turn),
    each with its own coefficients, scaled so that the neighbours,
    halos and buffers show."""
    xs = _raw(n, seed, 3) + _raw(n, seed + 1, 3)
    params = ((1, 0.3, 2.8), (2, 0.2, 2.3), (0, 0.4, 3.5))
    return xs[:k], params[:k]


# (n, fields, iters, plan): the card's plan (its tiles for 1 to 3 fields,
# one pair a block), and few blocks (several (field, tile) pairs a block,
# x0 reloaded every pass, uneven tiles)
DIFFUSIONS = [(9, 3, 5, "card"), (12, 2, 7, "card"), (11, 1, 4, "card"),
              (10, 3, 4, (5, (5, 4, 10))), (13, 2, 3, (4, (7, 13, 5)))]


@pytest.mark.parametrize(
    "n,k,iters,plan", DIFFUSIONS,
    ids=[f"n{c[0]}_f{c[1]}_i{c[2]}_"
         f"{'card' if c[3] == 'card' else 'b' + str(c[3][0])}"
         for c in DIFFUSIONS])
def test_emulated_diffusion_is_bitwise_plain(n, k, iters, plan):
    """The multi-field diffusion's plan (kernels.diffuse_plan) and passes
    against kernels.diffuse3d_multi_plain, bit for bit."""
    xs, params = _diffusions(n, k, 13 * n + k)
    if plan == "card":
        plan = kernels.diffuse_plan(n, k, *CARD)
        assert k * plan.tile.count(n) <= plan.blocks
    else:
        blocks, tile = plan
        plan = kernels.SolvePlan(blocks, kernels.SOLVE_THREADS, 0,
                                 kernels.SOLVE_JACOBI_LEVELS,
                                 kernels.StepTile(*tile,
                                                  kernels.SOLVE_JACOBI_LEVELS))
        assert k * plan.tile.count(n) > plan.blocks
    got = emulate_diffuse(xs, params, iters, plan)
    want = kernels.diffuse3d_multi_plain(xs, params, iters)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_emulated_diffusion_matches_jax_whole_multi():
    """The three-field emulation against the reference's
    diffuse3d_whole_multi in interpret mode, at 9^3, on
    set_bnd-consistent fields, within 1e-6 of max|reference|."""
    n, iters = 9, 4
    xs, params = _diffusions(n, 3, 92)
    xs = [stam.set_bnd3d(b, x) for x, (b, _, _) in zip(xs, params)]
    with pltpu.force_tpu_interpret_mode():
        refs = pk.diffuse3d_whole_multi(
            tuple(jnp.asarray(x.numpy()) for x in xs), params, iters)
    got = emulate_diffuse(xs, params, iters,
                          kernels.diffuse_plan(n, 3, *CARD))
    for g, r in zip(got, refs):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-6 * float(np.abs(r).max()))


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("n", [4, 16, 63, 64, 99])
def test_diffuse_plan_fits_the_card(n, k):
    """At every size the gate admits (float32, to 99), every box within
    the shared memory the plan asks for and that within what a block may
    take, at most the card's blocks and no more than the pairs; 20
    sweeps take ceil(20 / levels) - 1 barriers."""
    plan = kernels.diffuse_plan(n, k, *CARD)
    assert 4 * 3 * plan.tile.box_cells(n) == plan.smem <= CARD[1]
    assert plan.blocks == min(CARD[0], k * plan.tile.count(n))
    assert plan.tile.halo == plan.levels == kernels.SOLVE_JACOBI_LEVELS
    assert 1 <= plan.threads <= 512  # csrc/jacobi.cu's kSolveMaxThreads
    assert kernels.solve_barriers(20, False, plan) == _hand_barriers(
        20, False, plan.levels) == 6


def _hand_barriers(iters, red_black, levels):
    """Counted from the kernels' loop over passes: a barrier after every
    pass but the last."""
    sweeps = 2 * iters if red_black else iters
    return len(range(0, sweeps, levels)) - 1


@pytest.mark.parametrize("iters", [1, 2, 3, 7, 20])
@pytest.mark.parametrize("kind", ["rb", "jacobi", "2d"])
def test_solve_barriers_match_a_hand_count(kind, iters):
    if kind == "2d":
        plan, rb = kernels.solve2d_plan(128, *CARD), False
    else:
        rb = kind == "rb"
        plan = kernels.solve_plan(64, rb, F32, *CARD)
    want = _hand_barriers(iters, rb, plan.levels)
    assert kernels.solve_barriers(iters, rb, plan) == want
    if iters == 20:
        # from 40 (one a half-sweep), 19 (one a sweep) and 20 serial
        # block-barrier sweeps
        assert want == {"rb": 9, "jacobi": 6, "2d": 1}[kind]


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("red_black", [False, True], ids=["jacobi", "rb"])
@pytest.mark.parametrize("n", [4, 9, 15, 16, 17, 63, 64, 99, 126])
def test_solve_plan_fits_the_card(n, red_black, dtype):
    """At every size the gate admits (bfloat16 to 126, float32 to 99),
    one tile a block, at most the card's blocks, every box within the
    shared memory the plan asks for and that within what a block may
    take."""
    field = torch.empty((n + 2,) * 3, device="meta")
    if not kernels.solve_whole_ok(field, dtype):
        assert dtype == F32 and n > 99
        return
    plan = kernels.solve_plan(n, red_black, dtype, *CARD)
    boxes = 2 if red_black else 3
    assert plan.tile.count(n) == plan.blocks <= CARD[0]
    assert (dtype.itemsize * boxes * plan.tile.box_cells(n) == plan.smem
            <= CARD[1])
    assert plan.tile.halo == plan.levels == (
        kernels.SOLVE_RB_LEVELS if red_black else kernels.SOLVE_JACOBI_LEVELS)
    assert 1 <= plan.threads <= 512  # csrc/jacobi.cu's kSolveMaxThreads


@pytest.mark.parametrize("n", [1, 9, 13, 63, 128, 168, 169, 250, 1024, 1119,
                               4094])
def test_solve2d_plan_fits_the_card(n):
    """At every size (no gate: the boxes live in shared memory and the
    fields in device memory at any n), every box within the shared
    memory the plan asks for, at most the card's blocks; past about 1300
    a block takes several tiles."""
    plan = kernels.solve2d_plan(n, *CARD)
    assert 4 * 3 * plan.tile.box_cells(n) == plan.smem <= CARD[1]
    assert plan.blocks == min(CARD[0], plan.tile.count(n))
    assert plan.tile.halo == plan.levels == kernels.SOLVE2D_LEVELS
    assert (plan.tile.count(n) > plan.blocks) == (n == 4094)
    assert 1 <= plan.threads <= 1024  # csrc/grid2d.cu's kSolveMaxThreads
