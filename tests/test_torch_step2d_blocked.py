"""The whole 2D step's blocked schedule (csrc/step2d.cu) on the CPU: a
tile-by-tile, level-by-level torch emulation of the kernel's diffusion
and projection passes, with its tiles (kernels.step2d_plan), halo cones,
ghost rules and buffer plan, held bit for bit against
kernels.step2d_whole_plain (the plain whole 2D step, equal to
stam.step2d_multi) and against the plain solves; and the count of a
step's grid-wide barriers.

The emulation does what the blocks of the kernel do, pass by pass: each
loads its box from the buffer the previous pass wrote, runs the levels
inside the shrinking cone, a level's cells written into a box whose
other cells are NaN (the kernel's shared memory holds stale values
there), and writes its tile, or its owned cells with their ghosts and
corners.  Every scratch and output buffer starts as NaN, so a read of a
cell that no phase wrote shows in the result.  The elementwise phases
(buoyancy, vorticity confinement, advection) run the plain stages whose
cell bodies the kernel shares; the divergence and the gradient
subtraction use the plain arithmetic cell by cell.  Tolerance: bit for
bit, since the emulation does the plain solves' operations in their
order."""

import numpy as np
import pytest
import torch

from tpufluids_torch.grid import kernels, stam

NAN = float("nan")
# the card's shape: the shipped persistent blocks and the shared memory
# one may take
CARD = (kernels.STEP2D_BLOCKS, 232448)


class Box:
    """A block's box: tile ``t`` of ``tile`` widened by ``halo``, clipped
    to the (n+2)^2 array; boxes are NaN-filled tensors in its
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

    def local(self, r, shift=(0, 0)):
        return tuple(slice(a - l + d, b - l + d + 1)
                     for (a, b), l, d in zip(r, self.lo, shift))


def glob(r):
    return tuple(slice(a, b + 1) for a, b in r)


def axes(r):
    """Broadcastable coordinates I, J of region r."""
    i, j = (torch.arange(a, b + 1) for a, b in r)
    return i[:, None], j[None, :]


def load(S, box, r, field):
    S[box.local(r)] = field[glob(r)]


def level(S, X0, box, r, first, signs, a, c_inv):
    """(x0 + a * sum of the four neighbours) * c_inv on region r of box S,
    summed x-1, x+1, y-1, y+1: the stored neighbours if ``first``, else a
    tap across a face is the cell's own value times the face's sign."""
    n = box.n
    own = S[box.local(r)]
    taps = [S[box.local(r, d)] for d in ((-1, 0), (1, 0), (0, -1), (0, 1))]
    if not first:
        for q, (ax, end) in enumerate(((0, 1), (0, n), (1, 1), (1, n))):
            taps[q] = torch.where(axes(r)[ax] == end, signs[ax] * own,
                                  taps[q])
    xm, xp, ym, yp = taps
    nb = xm + xp + ym + yp
    return (X0[box.local(r)] + a * nb) * c_inv


def bnd_owned(box, val_at, b):
    """set_bnd2d(b)'s values on the box's owned cells, from the value
    ``val_at(CI, CJ)`` at each cell's clamped interior cell: sign times it
    on an edge, 0.5 (sy c + sx c) at a corner."""
    n = box.n
    I, J = axes(box.owned())
    CI, CJ = I.clamp(1, n), J.clamp(1, n)
    val = val_at(CI, CJ)
    sx, sy, _ = stam._bnd_signs(b)
    xo, yo = CI != I, CJ != J
    corner = 0.5 * (sy * val + sx * val)
    return torch.where(xo & yo, corner, torch.where(
        xo, sx * val, torch.where(yo, sy * val, val)))


def diffuse_passes(fields, n, iters, plan):
    """The diffusion passes: ``fields`` (in, out, tmp, b, a, c) in the
    kernel's order; block k takes the (field, tile) pairs k, k + blocks,
    ...  A block that holds one pair for the whole solve (no more pairs
    than blocks) keeps in its shared memory the x0 it loaded in the first
    pass; else it loads x0 with each pair."""
    F, tile = plan.levels, plan.diffuse
    passes = -(-iters // F)
    items = len(fields) * tile.count(n)
    resident = items <= plan.blocks
    shared_x0 = {}  # block -> the x0 box in its shared memory
    for p in range(passes):
        H = min(F, iters - p * F)
        for item in range(items):
            x, out, tmp, b, a, c = fields[item // tile.count(n)]
            src = x if p == 0 else (tmp if (passes - p) % 2 else out)
            dst = tmp if (passes - 1 - p) % 2 else out
            box = Box(tile, item % tile.count(n), n, F)
            S = box.empty()
            load(S, box, box.widen(H, 0, n + 1), src)
            if p == 0 or not resident:
                shared_x0[item % plan.blocks] = box.empty()
                load(shared_x0[item % plan.blocks], box,
                     box.widen(H, 0, n + 1), x)
            X0 = shared_x0[item % plan.blocks]
            for h in range(H):
                r = box.widen(H - 1 - h, 1, n)
                D = box.empty()
                D[box.local(r)] = level(S, X0, box, r, h == 0,
                                        stam._bnd_signs(b), a, 1.0 / c)
                S = D
            dst[glob(box.owned())] = bnd_owned(
                box, lambda CI, CJ: S[CI - box.lo[0], CJ - box.lo[1]], b)


def project_passes(u, v, outs, pbufs, n, iters, plan):
    """The projection passes: the divergence into each tile's x0, the
    zero-guess pressure solve (a = 1, c = 4, b = 0), the gradient
    subtraction in the last pass.  Every pass but the first loads the
    pressure box from the buffer the last pass wrote.  Block k takes tiles
    k, k + blocks, ...; a block with one tile (no more tiles than blocks)
    keeps in its shared memory the x0 it computed in the first pass, one
    with several recomputes x0 with each tile."""
    levels, tile = plan.levels, plan.project
    halo = levels + 1
    passes = -(-iters // levels)
    resident = tile.count(n) <= plan.blocks
    shared_x0 = {}  # block -> the x0 box in its shared memory
    h = 1.0 / n
    div = torch.full_like(u, NAN)
    div[1:-1, 1:-1] = -0.5 * h * (u[2:, 1:-1] - u[:-2, 1:-1]
                                  + v[1:-1, 2:] - v[1:-1, :-2])
    for p in range(passes):
        last = p == passes - 1
        h0, H = p * levels, min(levels, iters - p * levels)
        extra = int(last)
        for t in range(tile.count(n)):
            box = Box(tile, t, n, halo)
            if p == 0 or not resident:
                shared_x0[t % plan.blocks] = box.empty()
                load(shared_x0[t % plan.blocks], box,
                     box.widen(halo - 1, 1, n), div)
            X0 = shared_x0[t % plan.blocks]
            if p == 0:
                A = torch.zeros_like(box.empty())
            else:
                A = box.empty()
                load(A, box, box.widen(H + extra, 0, n + 1),
                     pbufs[1 - p % 2])
            for lv in range(H):
                r = box.widen(H - 1 - lv + extra, 1, n)
                D = box.empty()
                D[box.local(r)] = level(A, X0, box, r, h0 + lv == 0,
                                        (1.0, 1.0, 1.0), 1.0, 1.0 / 4.0)
                A = D
            if not last:
                pbufs[p % 2][glob(box.widen(0, 1, n))] = \
                    A[box.local(box.widen(0, 1, n))]
                continue
            # q - 0.5 (p+ - p-) / h at the clamped cells, p's ghost taps
            # the clamped cell's own value, then set_bnd2d(1) and (2)
            for ax, (q, out, b) in enumerate(zip((u, v), outs, (1, 2))):
                def val(CI, CJ, ax=ax, q=q):
                    at = (CI - box.lo[0], CJ - box.lo[1])
                    C = (CI, CJ)
                    d = (int(ax == 0), int(ax == 1))
                    pc = A[at]
                    pm = torch.where(C[ax] == 1, pc,
                                     A[at[0] - d[0], at[1] - d[1]])
                    pp = torch.where(C[ax] == n, pc,
                                     A[at[0] + d[0], at[1] + d[1]])
                    return q[CI, CJ] + -0.5 * (pp - pm) / h
                out[glob(box.owned())] = bnd_owned(box, val, b)


def emulate_step(u, v, dens, temp, cfg, plan):
    """kernels.step2d_whole's launch with csrc/step2d.cu's buffer plan."""
    n = u.shape[0] - 2
    dt0 = cfg.dt * n
    nan = lambda: torch.full_like(u, NAN)  # noqa: E731
    uo, vo, dens_o, temp_o = (nan() for _ in range(4))
    scratch = [nan() for _ in range(kernels.STEP2D_SCRATCH)]
    X, Y, S, P = scratch[0:2], scratch[2:4], scratch[4:6], scratch[6:8]
    cur, in_x = [u, v], False
    if cfg.buoyancy_alpha or cfg.buoyancy_beta:
        Y[1].copy_(stam.buoyancy2d(v, dens, temp, cfg))
        cur = [u, Y[1]]
    if cfg.vorticity_eps:
        for q, f in zip(X, stam.vorticity_confinement2d(*cur, cfg)):
            q.copy_(f)
        cur, in_x = list(X), True

    def other():
        return Y if in_x else X

    fields = []
    if cfg.visc:
        a, c = stam._diffusion_ac(cfg, cfg.visc, n, 2)
        o = other()
        fields += [(cur[f], o[f], (uo, vo)[f], f + 1, a, c) for f in range(2)]
        cur, in_x = list(o), not in_x
    sd, st = dens, temp
    if cfg.diff:
        fields.append((dens, S[0], dens_o, 0,
                       *stam._diffusion_ac(cfg, cfg.diff, n, 2)))
        sd = S[0]
    if cfg.temp_diff:
        fields.append((temp, S[1], temp_o, 0,
                       *stam._diffusion_ac(cfg, cfg.temp_diff, n, 2)))
        st = S[1]
    if fields:
        diffuse_passes(fields, n, cfg.jacobi_iters, plan)
    o = other()
    project_passes(*cur, o, P, n, cfg.jacobi_iters, plan)
    cur, in_x = list(o), not in_x
    o = other()
    for q, f in zip(o, stam._advect_stencil(cur, (1, 2), cur, dt0)):
        q.copy_(f)
    project_passes(*o, (uo, vo), P, n, cfg.jacobi_iters, plan)
    for q, f in zip((dens_o, temp_o),
                    stam._advect_stencil((sd, st), (0, 0), (uo, vo), dt0)):
        q.copy_(f)
    return uo, vo, dens_o, temp_o


def _fields(n, seed, bnds, lo, hi, raw=False):
    """Seeded fields with set_bnd2d ghosts, or with ``raw`` ghosts (as a
    state may hold once sources are added)."""
    rng = np.random.default_rng(seed)
    fields = [torch.from_numpy(rng.uniform(lo, hi, (n + 2,) * 2).astype(
        np.float32)) for _ in bnds]
    return fields if raw else [stam.set_bnd2d(b, f)
                               for b, f in zip(bnds, fields)]


def _config1(n, **kw):
    """BASELINE config 1 (bench.py:305-306) at size n."""
    return stam.StamConfig(**{**dict(n=n, dt=0.1, diff=1e-5, visc=1e-5,
                                     jacobi_iters=20, advect_mode="stencil"),
                              **kw})


FORCING = dict(buoyancy_alpha=0.04, buoyancy_beta=0.9, vorticity_eps=1.5,
               temp_diff=2e-5, ambient_temp=0.1)
# tests/test_torch_gpu.py's whole 2D step cases
CASES = {
    "config1": {},
    "forcing": FORCING,
    "no_diffusion": dict(FORCING, visc=0.0, diff=0.0),
    "buoyancy": dict(buoyancy_beta=0.9, diff=0.0),
    "vorticity": dict(vorticity_eps=1.5),
}
# (case, n, iters, blocks, shared memory bytes, diffusion scale, raw
# ghosts): the card's shape, at n below, at and past a tile's size, and
# few blocks with little shared memory, so that blocks take several
# tiles (the projection recomputing its x0 each pass) or (field, tile)
# pairs and tiles come out uneven; iteration counts that F does not
# divide.  At config 1's own coefficients (a = dt visc n^2 about 1e-4) a
# neighbour moves a diffused cell by less than an ulp, so cases with the
# coefficients scaled up make the diffusion's halo and buffers show in
# the result; raw ghosts make its first level's stored taps show.
STEPS = [("config1", 9, 20, *CARD, 1, False),
         ("forcing", 16, 5, *CARD, 1, False),
         ("no_diffusion", 13, 3, *CARD, 1, False),
         ("buoyancy", 11, 1, *CARD, 1, False),
         ("vorticity", 18, 13, *CARD, 1, False),
         ("config1", 40, 23, *CARD, 1, False),
         ("forcing", 33, 6, *CARD, 1000, False),
         ("config1", 27, 20, *CARD, 3000, False),
         ("forcing", 14, 5, 3, 5000, 3000, False),
         ("config1", 37, 17, 5, 14000, 3000, False),
         ("vorticity", 34, 4, 2, 12000, 1, False),
         ("buoyancy", 10, 9, 4, 3000, 3000, False),
         ("config1", 20, 20, *CARD, 3000, True),
         ("forcing", 23, 13, 3, 9000, 3000, True)]


@pytest.mark.parametrize("case,n,iters,blocks,smem,scale,raw", STEPS,
                         ids=[f"{s[0]}_n{s[1]}_i{s[2]}_b{s[3]}_x{s[5]}"
                              + ("_raw" if s[6] else "") for s in STEPS])
def test_emulated_step_is_bitwise_plain(case, n, iters, blocks, smem, scale,
                                        raw):
    cfg = _config1(n, **CASES[case]).replace(jacobi_iters=iters)
    cfg = cfg.replace(visc=scale * cfg.visc, diff=scale * cfg.diff,
                      temp_diff=scale * cfg.temp_diff)
    # a moving state: velocities up to a cell a step, and scalars
    u, v = _fields(n, n + iters, (1, 2), -1.0 / (cfg.dt * n),
                   1.0 / (cfg.dt * n), raw)
    d, t = _fields(n, n + 50, (0, 0), 0.0, 1.0, raw)
    plan = kernels.step2d_plan(n, cfg, blocks, smem)
    got = emulate_step(u, v, d, t, cfg, plan)
    want = kernels.step2d_whole_plain(u, v, d, t, cfg)
    for g, wv, f in zip(got, want, ("u", "v", "dens", "temp")):
        assert torch.equal(g, wv), f
    multi = stam.step2d_multi(stam.GridState2D(u, v, d, t), cfg)
    assert torch.equal(got[0], multi.u) and torch.equal(got[2], multi.dens)


# (n, iters, tile, levels, blocks): uneven tiles, a tile wider than the
# grid, iteration counts the levels do not divide, one level a pass;
# a block a tile, or blocks with several tiles
PROJECTIONS = [(9, 3, (4, 4), 4, 1000), (12, 5, (5, 12), 3, 1000),
               (10, 4, (3, 10), 2, 1000), (14, 7, (14, 5), 3, 1000),
               (11, 1, (11, 11), 4, 1000), (13, 6, (4, 6), 1, 1000),
               (20, 11, (7, 9), 6, 1000), (15, 9, (4, 5), 3, 2),
               (19, 13, (6, 7), 4, 5)]


@pytest.mark.parametrize(
    "n,iters,tile,levels,blocks", PROJECTIONS,
    ids=[f"n{p[0]}_i{p[1]}_F{p[3]}" + ("" if p[4] == 1000 else f"_b{p[4]}")
         for p in PROJECTIONS])
def test_emulated_projection_is_bitwise_plain(n, iters, tile, levels,
                                              blocks):
    """One projection of arbitrary velocities (stored ghosts that
    set_bnd2d would change): the divergence, pressure and gradient passes
    against stam.project2d through the plain solve."""
    rng = np.random.default_rng(n)
    u, v = (torch.from_numpy(rng.normal(0, 1, (n + 2,) * 2).astype(
        np.float32)) for _ in range(2))
    plan = kernels.Step2dPlan(blocks, 0, levels,
                              kernels.Step2dTile(*tile, levels + 1),
                              kernels.Step2dTile(*tile, levels))
    outs = tuple(torch.full_like(u, NAN) for _ in range(2))
    pbufs = [torch.full_like(u, NAN) for _ in range(2)]
    project_passes(u, v, outs, pbufs, n, iters, plan)
    cfg = stam.StamConfig(n=n, jacobi_iters=iters)
    want = stam.project2d(u, v, cfg, solve=kernels.lin_solve2d_plain)
    for g, wv in zip(outs, want):
        assert torch.equal(g, wv)


# (n, iters, tile, levels, fields): raw ghosts, every b, diffusion and
# pressure coefficients
DIFFUSIONS = [(9, 3, (4, 4), 2, 4), (12, 5, (5, 12), 3, 2),
              (10, 4, (3, 10), 4, 3), (13, 1, (13, 13), 2, 1),
              (17, 9, (6, 5), 5, 4)]


@pytest.mark.parametrize("n,iters,tile,levels,fields", DIFFUSIONS,
                         ids=[f"n{d[0]}_i{d[1]}_F{d[3]}" for d in DIFFUSIONS])
def test_emulated_diffusion_is_bitwise_plain(n, iters, tile, levels,
                                             fields):
    rng = np.random.default_rng(100 + n)
    xs = [torch.from_numpy(rng.normal(0, 1, (n + 2,) * 2).astype(np.float32))
          for _ in range(fields)]
    a = 0.1 * 1e-5 * n * n
    coeffs = [(q % 3, *((1.0, 4.0) if q % 2 else (a, 1 + 4 * a)))
              for q in range(fields)]
    plan = kernels.Step2dPlan(3, 0, levels,
                              kernels.Step2dTile(*tile, levels + 1),
                              kernels.Step2dTile(*tile, levels))
    outs = [torch.full_like(x, NAN) for x in xs]
    tmps = [torch.full_like(x, NAN) for x in xs]
    diffuse_passes([(x, o, t, *c) for x, o, t, c in zip(xs, outs, tmps,
                                                         coeffs)],
                   n, iters, plan)
    for x, o, (b, a_, c) in zip(xs, outs, coeffs):
        assert torch.equal(o, stam.lin_solve2d(b, x, x, a_, c, iters)), b


def _hand_barriers(buoy, vort, fields, iters, F):
    """Counted phase by phase from step2d_whole_kernel: a barrier after
    buoyancy, after |curl| and after the confinement force, after each
    diffusion pass, after each pressure pass of either projection, and
    after the self-advection."""
    count = int(buoy) + 2 * int(vort)
    if fields:
        count += len(range(0, iters, F))
    return count + 2 * len(range(0, iters, F)) + 1


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("iters", [1, 2, 3, 7, 20])
def test_step2d_barriers_match_a_hand_count(case, iters):
    cfg = _config1(128, **CASES[case]).replace(jacobi_iters=iters)
    plan = kernels.step2d_plan(128, cfg, *CARD)
    buoy = bool(cfg.buoyancy_alpha or cfg.buoyancy_beta)
    vort = bool(cfg.vorticity_eps)
    want = _hand_barriers(buoy, vort, kernels.step2d_fields(cfg), iters,
                          plan.levels)
    assert kernels.step2d_barriers(cfg, plan) == want
    if iters == 20 and case == "config1":
        # 2 diffusion + 2 x 2 pressure + 1, from about 105 block barriers
        assert plan.levels == 10 and want == 7


@pytest.mark.parametrize("n", [1, 9, 13, 14, 63, 127, 128, 168, 250, 1119])
def test_step2d_plan_fits_the_card(n):
    """At sizes the gate admits, up to its edge, every box fits the
    shared memory the plan asks for, within what a block may take."""
    cfg = _config1(n, **FORCING)
    plan = kernels.step2d_plan(n, cfg, *CARD)
    assert 4 * 3 * plan.project.box_cells(n) <= plan.smem <= CARD[1]
    assert 4 * 3 * plan.diffuse.box_cells(n) <= plan.smem
    assert plan.project.halo == plan.levels + 1
    assert plan.diffuse.halo == plan.levels
    assert kernels.step2d_whole_ok(torch.empty((n + 2,) * 2, device="meta"))
