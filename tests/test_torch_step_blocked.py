"""The whole step's blocked schedule (csrc/step.cu, csrc/step_blocked.cuh)
on the CPU: a tile-by-tile, level-by-level torch emulation of the
kernel's diffusion and projection passes, with its tiles
(kernels.step_plan), halo cones, ghost rules and buffer plan, held bit
for bit against kernels.step3d_whole_plain (the plain whole step, equal
to stam.step3d_multi) and against the plain solves; and the count of a
step's grid-wide barriers.

The emulation does what the blocks of the kernel do, pass by pass: each
loads its box from the buffer the previous pass wrote, runs the levels
inside the shrinking cone, a level's cells written into a box whose
other cells are NaN (the kernel's shared memory holds stale values
there), and writes its tile.  Every scratch and output buffer starts as
NaN, so a read of a cell that no phase wrote shows in the result.  The
elementwise phases (forcing, advection) run the plain versions of their
kernels, whose cell bodies the whole step shares; the divergence and the
gradient subtraction use the plain versions' arithmetic cell by cell.
Tolerance: bit for bit, since the emulation does the plain solves'
operations in their order."""

import numpy as np
import pytest
import torch

from tpufluids_torch.grid import kernels, stam

NAN = float("nan")
# the card's shape: persistent blocks and the shared memory one may take
CARD = (132, 232448)


class Box:
    """A block's box: tile ``t`` of ``tile`` widened by ``halo``, clipped
    to the (n+2)^3 array; boxes are NaN-filled tensors in its
    coordinates."""

    def __init__(self, tile, t, n, halo):
        self.n = n
        self.tile = tile.tile(n, t)
        self.lo = tuple(max(a - halo, 0) for a, _ in self.tile)
        self.hi = tuple(min(b + halo, n + 1) for _, b in self.tile)

    def empty(self):
        return torch.full(tuple(h - l + 1 for l, h in zip(self.lo, self.hi)),
                          NAN)

    def widen(self, e, lo, hi):
        """The tile widened by e, clipped to [lo, hi]: inclusive ranges."""
        return tuple((max(a - e, lo), min(b + e, hi)) for a, b in self.tile)

    def owned(self):
        """The output cells whose clamped cell lies in the tile."""
        n = self.n
        return tuple((0 if a == 1 else a, n + 1 if b == n else b)
                     for a, b in self.tile)

    def local(self, r, shift=(0, 0, 0)):
        return tuple(slice(a - l + d, b - l + d + 1)
                     for (a, b), l, d in zip(r, self.lo, shift))


def glob(r):
    return tuple(slice(a, b + 1) for a, b in r)


def axes(r):
    """Broadcastable coordinates I, J, K of region r."""
    i, j, k = (torch.arange(a, b + 1) for a, b in r)
    return i[:, None, None], j[None, :, None], k[None, None, :]


def load(S, box, r, field):
    S[box.local(r)] = field[glob(r)]


def level(S, X0, box, r, first, signs, a, c_inv):
    """(x0 + a * sum of the six neighbours) * c_inv on region r of box S:
    the stored neighbours if ``first``, else a tap across a face is the
    cell's own value times the face's sign."""
    n = box.n
    own = S[box.local(r)]
    taps = [S[box.local(r, d)] for d in ((-1, 0, 0), (1, 0, 0), (0, -1, 0),
                                         (0, 1, 0), (0, 0, -1), (0, 0, 1))]
    if not first:
        for q, (ax, end) in enumerate(((0, 1), (0, n), (1, 1), (1, n),
                                       (2, 1), (2, n))):
            taps[q] = torch.where(axes(r)[ax] == end, signs[ax] * own,
                                  taps[q])
    xm, xp, ym, yp, zm, zp = taps
    nb = xm + xp + ym + yp + zm + zp
    return (X0[box.local(r)] + a * nb) * c_inv


def diffuse_passes(fields, n, iters, plan):
    """The diffusion passes: ``fields`` (in, out, tmp, b, a, c) in the
    kernel's order; the blocks take the (field, tile) pairs in turn."""
    F, tile = plan.jacobi_levels, plan.diffuse
    passes = -(-iters // F)
    for p in range(passes):
        H = min(F, iters - p * F)
        for item in range(len(fields) * tile.count(n)):
            x, out, tmp, b, a, c = fields[item // tile.count(n)]
            src = x if p == 0 else (tmp if (passes - p) % 2 else out)
            dst = tmp if (passes - 1 - p) % 2 else out
            box = Box(tile, item % tile.count(n), n, F)
            S, X0 = box.empty(), box.empty()
            load(S, box, box.widen(H, 0, n + 1), src)
            load(X0, box, box.widen(H - 1, 1, n), x)
            for h in range(H):
                r = box.widen(H - 1 - h, 1, n)
                D = box.empty()
                D[box.local(r)] = level(S, X0, box, r, h == 0,
                                        stam._bnd_signs(b), a, 1.0 / c)
                S = D
            # every owned output cell: its clamped cell times its sign
            o = box.owned()
            I, J, K = axes(o)
            CI, CJ, CK = (q.clamp(1, n) for q in (I, J, K))
            val = S[CI - box.lo[0], CJ - box.lo[1], CK - box.lo[2]]
            if b:
                clamped = (CI != I, CJ != J, CK != K)[b - 1]
                val = torch.where(clamped, -val, val)
            dst[glob(o)] = val


def project_passes(u, v, w, outs, pbufs, n, iters, red_black, plan):
    """The projection passes: the divergence into each tile's x0, the
    zero-guess pressure solve (a = 1, b = 0), the gradient subtraction in
    the last pass; one tile a block, kept for the whole solve."""
    levels = plan.rb_levels if red_black else plan.jacobi_levels
    tile, halo = plan.project, levels + 1
    total = 2 * iters if red_black else iters
    passes = -(-total // levels)
    assert tile.count(n) <= plan.blocks
    div = kernels.div3d_plain(u, v, w)
    h = 1.0 / n
    boxes = []
    for t in range(tile.count(n)):
        box = Box(tile, t, n, halo)
        X0, A = box.empty(), torch.zeros_like(box.empty())
        load(X0, box, box.widen(halo - 1, 1, n), div)
        boxes.append((box, X0, A))
    for p in range(passes):
        last = p == passes - 1
        h0, H = p * levels, min(levels, total - p * levels)
        extra = int(last)
        for t, (box, X0, A) in enumerate(boxes):
            if p > 0:
                A = box.empty()
                load(A, box, box.widen(H + extra, 0, n + 1), pbufs[1 - p % 2])
            for lv in range(H):
                r = box.widen(H - 1 - lv + extra, 1, n)
                new = level(A, X0, box, r, h0 + lv == 0, (1.0, 1.0, 1.0),
                            1.0, 1.0 / 6.0)
                if red_black:
                    I, J, K = axes(r)
                    act = (I + J + K + 1) % 2 == (h0 + lv) % 2
                    A[box.local(r)] = torch.where(act, new, A[box.local(r)])
                else:
                    D = box.empty()
                    D[box.local(r)] = new
                    A = D
            if not last:
                pbufs[p % 2][glob(box.widen(0, 1, n))] = \
                    A[box.local(box.widen(0, 1, n))]
                continue
            # q - 0.5 (p+ - p-) / h on the owned cells, p's ghost taps the
            # clamped cell's own value, then each component's sign
            o = box.owned()
            I, J, K = axes(o)
            C = [q.clamp(1, n) for q in (I, J, K)]
            at = tuple(c - lo for c, lo in zip(C, box.lo))
            pc = A[at]
            for ax, (q, out) in enumerate(zip((u, v, w), outs)):
                d = [0, 0, 0]
                d[ax] = 1
                pm = torch.where(C[ax] == 1, pc, A[tuple(
                    x - s for x, s in zip(at, d))])
                pp = torch.where(C[ax] == n, pc, A[tuple(
                    x + s for x, s in zip(at, d))])
                val = q[C[0], C[1], C[2]] + -0.5 * (pp - pm) / h
                clamped = C[ax] != (I, J, K)[ax]
                out[glob(o)] = torch.where(clamped, -val, val)


def emulate_step(u, v, w, dens, temp, cfg, plan):
    """kernels.step3d_whole's launch with csrc/step.cu's buffer plan."""
    n = u.shape[0] - 2
    dt0 = cfg.dt * n
    nan = lambda: torch.full_like(u, NAN)  # noqa: E731
    uo, vo, wo, dens_o, temp_o = (nan() for _ in range(5))
    scratch = [nan() for _ in range(kernels.STEP_SCRATCH)]
    X, Y, S, P = scratch[0:3], scratch[3:6], scratch[6:8], scratch[8:10]
    cur, in_x = [u, v, w], False
    buoy = bool(cfg.buoyancy_alpha or cfg.buoyancy_beta)
    vort = bool(cfg.vorticity_eps)
    if buoy or vort:
        forced = kernels.forcing3d_plain(u, v, w, dens, temp, cfg)
        if vort:
            for q, f in zip(X, forced):
                q.copy_(f)
            cur, in_x = list(X), True
        else:
            Y[2].copy_(forced[2])
            cur = [u, v, Y[2]]

    def other():
        return Y if in_x else X

    fields = []
    if cfg.visc:
        a, c = stam._diffusion_ac(cfg, cfg.visc, n)
        o = other()
        fields += [(cur[f], o[f], (uo, vo, wo)[f], f + 1, a, c)
                   for f in range(3)]
        cur, in_x = list(o), not in_x
    sd, st = dens, temp
    if cfg.diff:
        fields.append((dens, S[0], dens_o, 0,
                       *stam._diffusion_ac(cfg, cfg.diff, n)))
        sd = S[0]
    if cfg.temp_diff:
        fields.append((temp, S[1], temp_o, 0,
                       *stam._diffusion_ac(cfg, cfg.temp_diff, n)))
        st = S[1]
    if fields:
        diffuse_passes(fields, n, cfg.jacobi_iters, plan)
    o = other()
    project_passes(*cur, o, P, n, cfg.jacobi_iters, cfg.red_black, plan)
    cur, in_x = list(o), not in_x
    o = other()
    for q, f in zip(o, kernels.advect3d_multi_plain(cur, (1, 2, 3), *cur,
                                                    dt0)):
        q.copy_(f)
    project_passes(*o, (uo, vo, wo), P, n, cfg.jacobi_iters, cfg.red_black,
                   plan)
    dens_o_, temp_o_ = kernels.advect3d_multi_plain((sd, st), (0, 0), uo, vo,
                                                    wo, dt0)
    dens_o.copy_(dens_o_)
    temp_o.copy_(temp_o_)
    return uo, vo, wo, dens_o, temp_o


def _fields(n, seed, bnds, lo, hi):
    rng = np.random.default_rng(seed)
    return [stam.set_bnd3d(b, torch.from_numpy(
        rng.uniform(lo, hi, (n + 2,) * 3).astype(np.float32))) for b in bnds]


def _config(n, plume, **kw):
    """tests/test_torch_gpu.py's whole-step configurations at size n."""
    forcing = (dict(buoyancy_alpha=0.05, buoyancy_beta=1.0, vorticity_eps=2.0)
               if plume else {})
    return stam.StamConfig(**{**dict(n=n, dt=0.05, diff=1e-5, visc=1e-5,
                                     jacobi_iters=20, red_black=True,
                                     advect_mode="stencil"), **forcing, **kw})


# tests/test_torch_gpu.py's whole-step cases, with odd iteration counts
# and counts that k (4 half-sweeps) and F (2 sweeps) do not divide
CASES = {
    "config2": dict(plume=False),
    "config4": dict(plume=True),
    "config4_jacobi": dict(plume=True, red_black=False),
    "buoyancy": dict(plume=True, vorticity_eps=0.0, temp_diff=2e-5),
    "vorticity": dict(plume=True, buoyancy_alpha=0.0, buoyancy_beta=0.0,
                      diff=0.0),
    "no_visc": dict(plume=False, visc=0.0, temp_diff=2e-5),
}
# (case, n, iters, blocks, shared memory bytes, diffusion scale): the
# card's shape, and few blocks with little shared memory, so that the
# diffusion's blocks take several (field, tile) pairs a pass and tiles
# come out uneven.  At the configurations' own coefficients (a = dt visc
# n^2 about 1e-4) a neighbour moves a diffused cell by less than an ulp,
# so cases with the coefficients scaled up make the diffusion's halo and
# buffers show in the result.
STEPS = [("config2", 9, 3, *CARD, 1), ("config4", 16, 5, *CARD, 1),
         ("config4_jacobi", 13, 3, 7, 60000, 1), ("buoyancy", 11, 1, *CARD, 1),
         ("vorticity", 18, 3, 5, 60000, 1), ("no_visc", 10, 7, 9, 40000, 1),
         ("config4", 12, 2, 4, 80000, 1), ("config4_jacobi", 17, 5, *CARD, 1),
         ("config4", 14, 5, *CARD, 3000), ("buoyancy", 12, 3, 6, 60000, 3000),
         ("no_visc", 15, 4, *CARD, 3000)]


@pytest.mark.parametrize("case,n,iters,blocks,smem,scale", STEPS,
                         ids=[f"{s[0]}_n{s[1]}_i{s[2]}_b{s[3]}_x{s[5]}"
                              for s in STEPS])
def test_emulated_step_is_bitwise_plain(case, n, iters, blocks, smem, scale):
    cfg = _config(n, **CASES[case]).replace(jacobi_iters=iters)
    cfg = cfg.replace(visc=scale * cfg.visc, diff=scale * cfg.diff,
                      temp_diff=scale * cfg.temp_diff)
    # a moving state: velocities up to a cell a step, and scalars
    u, v, w = _fields(n, n + iters, (1, 2, 3), -1.0, 1.0)
    d, t = _fields(n, n + 50, (0, 0), 0.0, 1.0)
    plan = kernels.step_plan(n, cfg, blocks, smem)
    got = emulate_step(u, v, w, d, t, cfg, plan)
    want = kernels.step3d_whole_plain(u, v, w, d, t, cfg)
    for g, wv, f in zip(got, want, ("u", "v", "w", "dens", "temp")):
        assert torch.equal(g, wv), f
    multi = stam.step3d_multi(stam.GridState3D(u, v, w, d, t), cfg)
    assert torch.equal(got[0], multi.u) and torch.equal(got[4], multi.temp)


# (n, iters, red_black, tile, levels): uneven tiles, a tile wider than
# the grid, iteration counts the levels do not divide, one level a pass
PROJECTIONS = [(9, 3, True, (4, 4, 4), 4), (12, 5, True, (5, 12, 7), 3),
               (10, 4, False, (3, 4, 10), 2), (14, 7, False, (14, 5, 5), 3),
               (11, 1, True, (11, 11, 11), 4), (13, 6, True, (4, 6, 13), 1)]


@pytest.mark.parametrize("n,iters,red_black,tile,levels", PROJECTIONS,
                         ids=[f"n{p[0]}_i{p[1]}_{'rb' if p[2] else 'j'}"
                              for p in PROJECTIONS])
def test_emulated_projection_is_bitwise_plain(n, iters, red_black, tile,
                                              levels):
    """One projection of arbitrary velocities (stored ghosts that set_bnd
    would change): the divergence, pressure and gradient passes against
    project3d_whole_plain."""
    rng = np.random.default_rng(n)
    u, v, w = (torch.from_numpy(rng.normal(0, 1, (n + 2,) * 3).astype(
        np.float32)) for _ in range(3))
    halo = levels + 1
    plan = kernels.StepPlan(1000, 0, levels, levels,
                            kernels.StepTile(*tile, halo),
                            kernels.StepTile(*tile, levels))
    outs = tuple(torch.full_like(u, NAN) for _ in range(3))
    pbufs = [torch.full_like(u, NAN) for _ in range(2)]
    project_passes(u, v, w, outs, pbufs, n, iters, red_black, plan)
    want = kernels.project3d_whole_plain(u, v, w, iters, red_black)
    for g, wv in zip(outs, want):
        assert torch.equal(g, wv)


# (n, iters, red_black, blocks, shared memory bytes, levels the plan
# takes): kernels.project_plan's plans for the fused projection, on the
# card's shape and on few blocks with little shared memory, where
# Jacobi's three boxes of halo 4 fit no tiling of one tile a block and
# the plan falls back to 2 sweeps a pass; odd n, and sweep counts the
# levels do not divide
LONE_PROJECTIONS = [(9, 5, True, *CARD, 4), (16, 9, True, *CARD, 4),
                    (18, 4, False, *CARD, 3), (17, 7, False, *CARD, 3),
                    (13, 7, False, 8, 24000, 2), (14, 20, False, 8, 30000, 2),
                    (11, 3, True, 6, 20000, 4), (15, 5, False, 27, 20000, 2),
                    (12, 4, False, 27, 12000, 2), (18, 3, False, 8, 60000, 3)]


@pytest.mark.parametrize("n,iters,red_black,blocks,smem,levels",
                         LONE_PROJECTIONS,
                         ids=[f"n{p[0]}_i{p[1]}_{'rb' if p[2] else 'j'}"
                              f"_b{p[3]}_L{p[5]}" for p in LONE_PROJECTIONS])
def test_emulated_lone_projection_is_bitwise_plain(n, iters, red_black,
                                                   blocks, smem, levels):
    """The fused projection's launch (csrc/jacobi.cu on the passes of
    csrc/step_blocked.cuh) on kernels.project_plan's tiles: one tile a
    block, halo levels + 1, bit for bit against project3d_whole_plain."""
    plan = kernels.project_plan(n, red_black, blocks, smem)
    assert plan.levels == levels
    assert plan.tile.count(n) == plan.blocks <= blocks
    assert plan.tile.halo == levels + 1
    assert 4 * (2 if red_black else 3) * plan.tile.box_cells(n) == \
        plan.smem <= smem
    rng = np.random.default_rng(200 + n)
    u, v, w = (torch.from_numpy(rng.normal(0, 1, (n + 2,) * 3).astype(
        np.float32)) for _ in range(3))
    step = kernels.StepPlan(plan.blocks, plan.smem, plan.levels, plan.levels,
                            plan.tile, plan.tile)
    outs = tuple(torch.full_like(u, NAN) for _ in range(3))
    pbufs = [torch.full_like(u, NAN) for _ in range(2)]
    project_passes(u, v, w, outs, pbufs, n, iters, red_black, step)
    want = kernels.project3d_whole_plain(u, v, w, iters, red_black)
    for g, wv in zip(outs, want):
        assert torch.equal(g, wv)


# (n, iters, tile, levels, fields): raw ghosts, every b, diffusion and
# pressure coefficients
DIFFUSIONS = [(9, 3, (4, 4, 4), 2, 5), (12, 5, (5, 12, 7), 3, 2),
              (10, 4, (3, 4, 10), 4, 4), (13, 1, (13, 13, 13), 2, 1)]


@pytest.mark.parametrize("n,iters,tile,levels,fields", DIFFUSIONS,
                         ids=[f"n{d[0]}_i{d[1]}_F{d[3]}" for d in DIFFUSIONS])
def test_emulated_diffusion_is_bitwise_plain(n, iters, tile, levels,
                                             fields):
    rng = np.random.default_rng(100 + n)
    xs = [torch.from_numpy(rng.normal(0, 1, (n + 2,) * 3).astype(np.float32))
          for _ in range(fields)]
    a = 0.05 * 1e-5 * n * n
    coeffs = [(q % 4, *((1.0, 6.0) if q % 2 else (a, 1 + 6 * a)))
              for q in range(fields)]
    plan = kernels.StepPlan(3, 0, levels, levels,
                            kernels.StepTile(*tile, levels + 1),
                            kernels.StepTile(*tile, levels))
    outs = [torch.full_like(x, NAN) for x in xs]
    tmps = [torch.full_like(x, NAN) for x in xs]
    diffuse_passes([(x, o, t, *c) for x, o, t, c in zip(xs, outs, tmps,
                                                         coeffs)],
                   n, iters, plan)
    for x, o, (b, a_, c) in zip(xs, outs, coeffs):
        assert torch.equal(o, stam.lin_solve3d(b, x, x, a_, c, iters)), b


def _hand_barriers(forcing_a, forcing_b, fields, iters, red_black, k, F):
    """Counted phase by phase from step_whole_kernel: a barrier after
    each forcing half, after each diffusion pass, after each pressure pass
    of either projection, and after the self-advection."""
    count = int(forcing_a) + int(forcing_b)
    if fields:
        count += len(range(0, iters, F))
    per_solve = len(range(0, 2 * iters, k)) if red_black else \
        len(range(0, iters, F))
    return count + per_solve + 1 + per_solve


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("iters", [1, 2, 3, 7, 20])
def test_step_barriers_match_a_hand_count(case, iters):
    cfg = _config(64, **CASES[case]).replace(jacobi_iters=iters)
    plan = kernels.step_plan(64, cfg, *CARD)
    buoy = bool(cfg.buoyancy_alpha or cfg.buoyancy_beta)
    vort = bool(cfg.vorticity_eps)
    want = _hand_barriers(buoy or vort, vort, kernels.step_fields(cfg),
                          iters, cfg.red_black, plan.rb_levels,
                          plan.jacobi_levels)
    assert kernels.step_barriers(cfg, plan) == want
    if iters == 20 and case == "config4":
        # 2 forcing + 7 diffusion + 2 x 10 pressure + 1, from about 130
        assert want == 30


@pytest.mark.parametrize("n", [15, 16, 17, 63, 64, 78])
@pytest.mark.parametrize("case", ["config4", "config4_jacobi", "no_visc"])
def test_step_plan_fits_the_card(n, case):
    """At every size the gate admits (and around the tiles' edges), the
    pressure takes one tile a block and every box fits the shared memory
    the plan asks for, within what a block may take."""
    cfg = _config(n, **CASES[case])
    plan = kernels.step_plan(n, cfg, *CARD)
    assert plan.project.count(n) <= plan.blocks
    boxes = 2 if cfg.red_black else 3
    assert 4 * boxes * plan.project.box_cells(n) <= plan.smem <= CARD[1]
    assert 4 * 3 * plan.diffuse.box_cells(n) <= plan.smem
    levels = plan.rb_levels if cfg.red_black else plan.jacobi_levels
    assert plan.project.halo == levels + 1
    assert plan.diffuse.halo == plan.jacobi_levels
    assert kernels.step_whole_ok(torch.empty((n + 2,) * 3))


def _hand_lone_barriers(iters, red_black, levels):
    """Counted from the fused projection's kernel (blocked_project with
    LONE): a barrier after every pass but the last."""
    sweeps = 2 * iters if red_black else iters
    return len(range(0, sweeps, levels)) - 1


@pytest.mark.parametrize("n", [64, 96])
@pytest.mark.parametrize("iters", [1, 2, 3, 7, 20])
@pytest.mark.parametrize("red_black", [False, True], ids=["jacobi", "rb"])
def test_lone_projection_barriers_match_a_hand_count(n, iters, red_black):
    plan = kernels.project_plan(n, red_black, *CARD)
    want = _hand_lone_barriers(iters, red_black, plan.levels)
    assert kernels.solve_barriers(iters, red_black, plan) == want
    if iters == 20:
        # from 42 (red-black) and 21 (Jacobi): a barrier a half-sweep or
        # sweep, and one each for the divergence and the gradient
        assert want == (9 if red_black else 6 if n == 64 else 9)


@pytest.mark.parametrize("red_black", [False, True], ids=["jacobi", "rb"])
def test_project_plan_fits_the_card(red_black):
    """At every size the gate admits (float32, n up to 99), one tile a
    block, at most the card's blocks, every box within the shared memory
    the plan asks for and that within what a block may take, and a halo
    of the levels + 1.  The levels are the whole solve's except where
    no tile of their halo fits one a block: Jacobi at n = 93 to 99 (F = 3
    has a plan at 92, none at 93), which takes 2 sweeps a pass."""
    boxes = 2 if red_black else 3
    top = kernels.SOLVE_RB_LEVELS if red_black else kernels.SOLVE_JACOBI_LEVELS
    fallback = []
    for n in range(1, 100):
        assert kernels.solve_whole_ok(torch.empty((n + 2,) * 3,
                                                  device="meta"),
                                      torch.float32)
        plan = kernels.project_plan(n, red_black, *CARD)
        assert plan.tile.count(n) == plan.blocks <= CARD[0], n
        assert 4 * boxes * plan.tile.box_cells(n) == plan.smem <= CARD[1], n
        assert plan.tile.halo == plan.levels + 1, n
        assert 1 <= plan.threads <= 512  # csrc/jacobi.cu's kSolveMaxThreads
        if plan.levels != top:
            with pytest.raises(ValueError):
                kernels._step_tile(n, CARD[0], top + 1, 1, boxes, CARD[1])
            fallback.append((n, plan.levels))
    assert fallback == ([] if red_black else
                        [(n, 2) for n in range(93, 100)])
    assert not kernels.solve_whole_ok(torch.empty((102,) * 3, device="meta"),
                                      torch.float32)
