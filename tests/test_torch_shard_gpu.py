"""The sharded steps' kernels against their plain PyTorch versions on the
card: the slab modes of the four stencil kernels and the sharded
red-black solve (lin_solve3d_rb_shard) at 15^3 and 48^3, on x-slabs cut
from a set_bnd-consistent grid at a domain face and inside it, in one
pass and in several with the pad refreshed between them; the SPH force
kernels (#13-#16) on the x-slab tables of the sharded SPH step; and that
step on a world of 1.  Marked ``gpu`` and skipped without a CUDA device;
on the card:

    python -m pytest --noconftest -m gpu tests/test_torch_shard_gpu.py

The grid kernels are built with -fmad=false and take 1/h from Python, so
every check of them is bit for bit; the slabs' owned rows must also equal
the dense kernels' rows of the same global cells.  The SPH kernels on a
slab are held as on the cube (tests/test_torch_sph_gpu.py,
tests/test_torch_unidyn_gpu.py): 1e-5 * max|plain| a column against
their plain versions, bit for bit against their lane emulations, and a
row whose neighbourhood lies inside the slab bit for bit against the
cube kernel's."""

import numpy as np
import pytest
import torch

from torch_base_inputs import randomised
from torch_unidyn_inputs import held
from tpufluids_torch import binning, forces, scenes, sph_kernels, step
from tpufluids_torch.config import BASE_CONFIG, UNIDYN_CONFIG, column_caps
from tpufluids_torch.grid import kernels, stam
from tpufluids_torch.shard import make_mesh, particles

pytestmark = pytest.mark.gpu

OWNED = 4     # owned rows of a stencil slab, padded with 2 rows a side


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fields(dev, n, seed, bnds, lo, hi):
    rng = np.random.default_rng(seed)
    return [stam.set_bnd3d(b, torch.from_numpy(
        rng.uniform(lo, hi, (n + 2,) * 3).astype(np.float32)).to(dev))
        for b in bnds]


def _cut(x, gx0, rows):
    """Rows gx0 .. gx0 + rows - 1 of the ghosted field x, zeros outside
    the grid."""
    out = x.new_zeros((rows,) + tuple(x.shape[1:]))
    lo, hi = max(gx0, 0), min(gx0 + rows, x.shape[0])
    out[lo - gx0:hi - gx0] = x[lo:hi]
    return out


def _placements(n):
    """gx0 of a padded slab of OWNED + 4 rows: at the low face, inside,
    at the high face."""
    return {"low": -1, "inner": n // 2 - 2, "high": n + 1 - OWNED - 2}


def _equal(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("where", ["low", "inner", "high"])
@pytest.mark.parametrize("n", [15, 48])
def test_slab_stencils_are_bitwise_plain(cuda, n, where):
    gx0 = _placements(n)[where]
    rows = OWNED + 4
    dt0 = 0.5
    dense = (_fields(cuda, n, 1, (1, 2, 3), -1.2 / dt0, 1.2 / dt0)
             + _fields(cuda, n, 2, (0, 0, 0), 0.0, 1.0))
    u, v, w, d, t, p = (_cut(q, gx0, rows) for q in dense)
    own = slice(2, 2 + OWNED)
    gown = slice(gx0 + 2, gx0 + 2 + OWNED)
    before = kernels.launch_counts()
    for fields, bnds in (((u, v, w), (1, 2, 3)), ((d, t), (0, 0))):
        got = kernels.advect3d_multi(fields, bnds, u, v, w, dt0, gx0=gx0)
        assert _equal(got, kernels.advect3d_multi_plain(fields, bnds, u, v,
                                                        w, dt0, gx0=gx0))
        ref = kernels.advect3d_multi(
            tuple(dense[:3] if len(fields) == 3 else dense[3:5]), bnds,
            *dense[:3], dt0)
        assert _equal([g[own] for g in got], [r[gown] for r in ref])
    for coeffs in (dict(vorticity_eps=2.0, buoyancy_alpha=0.05,
                        buoyancy_beta=0.5),
                   dict(buoyancy_alpha=0.05, buoyancy_beta=0.5),
                   dict(vorticity_eps=2.0)):
        cfg = stam.StamConfig(n=n, dt=0.5 / n, **coeffs)
        got = kernels.forcing3d(u, v, w, d, t, cfg, gx0=gx0)
        assert _equal(got, kernels.forcing3d_plain(u, v, w, d, t, cfg,
                                                   gx0=gx0)), coeffs
        ref = kernels.forcing3d(*dense[:5], cfg)
        assert _equal([g[own] for g in got], [r[gown] for r in ref]), coeffs
    got = kernels.div3d(u, v, w, gx0=gx0)
    assert torch.equal(got, kernels.div3d_plain(u, v, w, gx0=gx0))
    assert torch.equal(got[own], kernels.div3d(*dense[:3])[gown])
    got = kernels.gradsub3d(p, u, v, w, gx0=gx0)
    assert _equal(got, kernels.gradsub3d_plain(p, u, v, w, gx0=gx0))
    ref = kernels.gradsub3d(dense[5], *dense[:3])
    assert _equal([g[own] for g in got], [r[gown] for r in ref])
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in ("advect3d_multi", "forcing3d",
                                              "div3d", "gradsub3d")} == {
        "advect3d_multi": 4, "forcing3d": 6, "div3d": 2, "gradsub3d": 2}


@pytest.mark.parametrize("zero", [False, True], ids=["guess", "x_zero"])
@pytest.mark.parametrize("fuse", [1, 2, 4])
@pytest.mark.parametrize("n", [15, 48])
def test_rb_shard_is_bitwise_plain_and_dense(cuda, n, fuse, zero):
    """One pass (iters = fuse) on a slab at the low face and one inside
    the grid, each b: the kernel equals its plain version, and the owned
    rows the dense red-black solve's."""
    halo = 2 * fuse
    c_local = max(2 * fuse, 4)
    for b in range(4):
        x, x0 = _fields(cuda, n, 10 + b, (b, 0), -1.0, 1.0)
        dense = kernels.lin_solve3d_rb(b, None if zero else x, x0, 1.0, 6.0,
                                       fuse)
        for r0 in (0, n // 2 - c_local // 2):   # owned global rows r0 + 1..
            gx0 = r0 + 1 - halo
            rows = c_local + 2 * halo
            xs = None if zero else _cut(x, gx0, rows)
            args = (b, xs, _cut(x0, gx0, rows), 1.0, 6.0, fuse)
            before = kernels.lin_solve3d_rb_shard.launches
            got = kernels.lin_solve3d_rb_shard(*args, gx0=gx0, fuse=fuse)
            assert kernels.lin_solve3d_rb_shard.launches == before + 1
            want = kernels.lin_solve3d_rb_shard_plain(*args, gx0=gx0,
                                                      fuse=fuse)
            assert torch.equal(got, want), (b, r0)
            assert torch.equal(got, dense[r0 + 1:r0 + 1 + c_local]), (b, r0)


def _neighbour_exchange(dense_after, gx0, halo, fuse):
    """An exchange that refreshes every pad row of a slab as its
    neighbours and the face rule would, from the dense solve after the
    iterations done so far (dense_after(iters), plain, cached)."""
    calls = [0]

    def exchange(q):
        calls[0] += 1
        ref = dense_after(calls[0] * fuse)
        rows = q.shape[0]
        for i in [*range(halo), *range(rows - halo, rows)]:
            g = gx0 + i
            q[i] = ref[g] if 0 <= g < ref.shape[0] else 0.0
        return q
    return exchange


@pytest.mark.parametrize("zero", [False, True], ids=["guess", "x_zero"])
@pytest.mark.parametrize("fuse", [1, 2, 4])
@pytest.mark.parametrize("n", [15, 48])
def test_rb_shard_passes_are_bitwise_plain_and_dense(cuda, n, fuse, zero):
    """Several passes (iters = 2 fuse and 5 fuse) on a slab at the low
    face and one inside the grid, each b, the pad refreshed between
    passes from the dense solve: the kernel equals its plain version,
    and the owned rows the dense red-black solve's."""
    halo = 2 * fuse
    c_local = max(2 * fuse, 4)
    rows = c_local + 2 * halo
    for b in range(4):
        x, x0 = _fields(cuda, n, 30 + b, (b, 0), -1.0, 1.0)
        guess = None if zero else x
        cache = {}

        def dense_after(iters, b=b, guess=guess, x0=x0, cache=cache):
            if iters not in cache:
                cache[iters] = kernels.lin_solve3d_rb_plain(
                    b, guess, x0, 1.0, 6.0, iters)
            return cache[iters]

        for iters in (2 * fuse, 5 * fuse):
            for r0 in (0, n // 2 - c_local // 2):
                gx0 = r0 + 1 - halo
                args = (b, None if zero else _cut(x, gx0, rows),
                        _cut(x0, gx0, rows), 1.0, 6.0, iters)
                got = kernels.lin_solve3d_rb_shard(
                    *args, gx0=gx0, fuse=fuse,
                    exchange=_neighbour_exchange(dense_after, gx0, halo,
                                                 fuse))
                want = kernels.lin_solve3d_rb_shard_plain(
                    *args, gx0=gx0, fuse=fuse,
                    exchange=_neighbour_exchange(dense_after, gx0, halo,
                                                 fuse))
                assert torch.equal(got, want), (b, iters, r0)
                assert torch.equal(
                    got, dense_after(iters)[r0 + 1:r0 + 1 + c_local]), \
                    (b, iters, r0)


def test_rb_shard_passes_equal_the_dense_solve_at_world_1(cuda):
    """Several passes on the whole grid as one slab, its pad refreshed
    by seeding the face ghost rows (a world of 1): bit for bit the dense
    solve at 48^3, 20 iterations, fuse 4."""
    n, fuse = 48, 4
    halo = 2 * fuse
    x0, = _fields(cuda, n, 20, (0,), 0.0, 1.0)
    x0p = _cut(x0, 1 - halo, n + 2 * halo)

    def seed(q):
        q[halo - 1] = q[halo]
        q[halo + n] = q[halo + n - 1]

    got = kernels.lin_solve3d_rb_shard(0, None, x0p, 1.0, 6.0, 20,
                                       gx0=1 - halo, fuse=fuse,
                                       exchange=seed)
    assert torch.equal(got, kernels.lin_solve3d_rb(0, None, x0, 1.0, 6.0,
                                                   20)[1:-1])
    assert torch.equal(got, kernels.lin_solve3d_rb_shard_plain(
        0, None, x0p, 1.0, 6.0, 20, gx0=1 - halo, fuse=fuse, exchange=seed))


# --- the SPH force kernels on x-slabs (tpufluids_torch.shard.particles) ----

# base_dam's grid of 40 cut at its middle as world 2's rank 1 cuts it: 20
# owned planes and a halo plane a side, GridSpec(g, g/2 + 2, g/2 - 1)
SLAB_BASE = binning.GridSpec(g=40, x_planes=22, x_offset=19)
# the JAX package's sharded unidyn configuration and world 2's rank 0 slab
SHARD_UNIDYN = UNIDYN_CONFIG.replace(grid_size=16, cell_size=0.125)
SLAB_UNIDYN = binning.GridSpec(g=16, x_planes=10, x_offset=-1)
SPH_FIELDS = ("sum_w", "dpress", "diffusion", "vel_grad", "stress_accel",
              "solid_drift", "fluid_drift", "mixture_accel", "delsolid",
              "delfluid")


def _inner(st, cfg, slab):
    """Rows whose 27-cell neighbourhood lies inside ``slab``."""
    cx = binning.cell_coords(st.pos, cfg)[:, 0]
    return st.alive & (cx > slab.x_offset) & (
        cx < slab.x_offset + slab.x_planes - 1)


def halo_fix(st, cfg, slab):
    """A drift_fix that changes the drifts of the rows in the slab's two
    halo planes (pool order), as the sharded step's owners' values do."""
    cx = binning.cell_coords(st.pos, cfg)[:, 0]
    halo = ((cx == slab.x_offset)
            | (cx == slab.x_offset + slab.x_planes - 1))[:, None]

    def fix(s, f):
        return torch.where(halo, 0.5 * s, s), torch.where(halo, -f, f)
    return fix


@pytest.mark.parametrize("capped", [False, True], ids=["rowblock", "column"])
def test_slab_base_kernels_match_plain_and_lanes(cuda, capped):
    cfg = BASE_CONFIG.replace(pallas_col_cap=32) if capped else BASE_CONFIG
    st = randomised(scenes.base_dam(cfg, device=cuda), 8)
    order, bt = binning.sort_tables(st, cfg, SLAB_BASE)
    assert 0 < int(bt.in_dom.sum()) < st.capacity
    name = "base_forces_column" if capped else "base_forces_rowblock"
    kern = getattr(sph_kernels, name)
    before = kern.launches
    got = kern(st, bt, cfg, order)
    want = getattr(sph_kernels, name + "_plain")(st, bt, cfg, order)
    assert kern.launches == before + 1
    assert int(got[2]) == int(want[2])
    assert (int(got[2]) > 0) == capped
    caps = column_caps(cfg) if capped else None
    lanes = forces.base_lane_pass(st, bt, cfg, sph_kernels.BASE_LANES, caps)
    for g, w, e in zip([got[0], *got[1].unbind(1)],
                       [want[0], *want[1].unbind(1)],
                       [lanes[0], *lanes[1].unbind(1)]):
        assert float(w.abs().max()) > 0.0
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
        assert torch.equal(g, e)
    # outside the slab: zeros; inside its owned planes: the cube's bits
    assert not bool(got[0][~bt.in_dom[torch.argsort(order)]].any())
    order_c, bt_c = binning.sort_tables(st, cfg)
    cube = kern(st, bt_c, cfg, order_c)
    inner = _inner(st, cfg, SLAB_BASE)
    assert int(inner.sum()) > 1000
    assert torch.equal(got[0][inner], cube[0][inner])
    assert torch.equal(got[1][inner], cube[1][inner])


@pytest.mark.parametrize("capped", [False, True], ids=["rowblock", "column"])
def test_slab_unidyn_kernels_match_plain_and_lanes(cuda, capped):
    """Passes A and B on a slab with a drift fix of the halo rows between
    them; the resident kernel takes no hook."""
    cfg = SHARD_UNIDYN.replace(pallas_col_cap=48) if capped else SHARD_UNIDYN
    st = scenes.mixed_phase(scenes.random_blob(
        3000, seed=4, cfg=cfg, span=0.5, boundary_frac=0.1, device=cuda), 5)
    order, bt = binning.sort_tables(st, cfg, SLAB_UNIDYN)
    assert 0 < int(bt.in_dom.sum()) < st.capacity
    fix = halo_fix(st, cfg, SLAB_UNIDYN)
    th = cfg.subbin_threshold
    name = "unidyn_forces_column" if capped else "unidyn_forces_rowblock"
    kern = getattr(sph_kernels, name)
    before = kern.launches
    got = kern(st, bt, cfg, order, drift_fix=fix, subbin_threshold=th)
    assert kern.launches == before + 1
    want = getattr(sph_kernels, name + "_plain")(
        st, bt, cfg, order, drift_fix=fix, subbin_threshold=th)
    held(got, want, SPH_FIELDS, 1e-5)
    caps = column_caps(cfg) if capped else None
    lanes = forces.unidyn_lane_pass(st, bt, cfg, sph_kernels.UNIDYN_LANES,
                                    th, fix, caps)
    _, same, cols = held(got, lanes, SPH_FIELDS, 1e-6)
    assert same == cols
    assert torch.equal(got["has_pair"], lanes["has_pair"])
    assert torch.equal(got["merge_partner"], lanes["merge_partner"])
    if capped:
        assert int(got["overflow"]) == int(want["overflow"]) > 0
    unfixed = kern(st, bt, cfg, order, subbin_threshold=th)
    assert not torch.equal(unfixed["mixture_accel"], got["mixture_accel"])
    assert torch.equal(unfixed["sum_w"], got["sum_w"])


@pytest.mark.parametrize("variant", ["base", "unidyn"])
def test_sharded_sph_world_of_one_is_the_dense_step(cuda, variant):
    """make_sharded_step on a world of 1 equals the dense card step bit
    for bit over 10 steps: base_dam and the cut tank."""
    if variant == "base":
        cfg, st = BASE_CONFIG, scenes.base_dam(BASE_CONFIG, device=cuda)
    else:
        cfg = UNIDYN_CONFIG
        st = scenes.unidyn_tank(cfg, nf=2000, nb=808, device=cuda)
    mesh = make_mesh(device=cuda.type)
    local = particles.distribute(st, mesh, cfg)
    out, m = particles.make_sharded_step(mesh, cfg, n_steps=10)(local)
    ref, rm = step.run_python(local, cfg, 10)
    for f in ("pos", "vel", "acc", "dens", "press", "solid", "stress",
              "alive", "pid"):
        assert torch.equal(getattr(out, f), getattr(ref, f)), f
    assert int(m.n_alive) == int(rm.n_alive) == int(st.alive.sum())
    assert int(m.bin_overflow) == int(m.halo_overflow) == 0
