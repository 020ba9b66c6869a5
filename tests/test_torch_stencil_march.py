"""The x-march of the streamed stencil kernels (csrc/advect.cu,
csrc/forcing.cu, csrc/stencil_march.cuh) on the CPU: the march plan
(kernels.march_plan: tiles, segments of centre rows, the rows without a
stencil) writes every output cell once, and the torch emulations of the
two kernels (kernels.advect3d_march, kernels.forcing3d_march: ring by
ring, plane by plane, halos clipped at the faces, NaN wherever nothing
was staged or written) equal the plain versions bit for bit, at 9^3 to
18^3, with tiles and segments that divide n and that do not, on cubic
fields and on x-slabs at the low face, inside and at the high face; and
one case of each against the JAX package (interpret-mode Pallas and the
dense composition) at the tolerances of tests/test_torch_kernels.py.

The kernels themselves run only on a card (tests/test_torch_gpu.py and
tests/test_torch_shard_gpu.py hold them bit for bit against the plain
versions)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpufluids.grid import pallas_kernels as pk
from tpufluids.grid import stam as jstam
from tpufluids_torch.grid import kernels
from tpufluids_torch.grid import stam

ADVECT_TOL = FORCING_TOL = 3e-6
OWNED = 4     # owned rows of a slab, padded with 2 rows a side
# a tile and segment that divide 12 (several tiles and segments), one
# that divides no size here, and the shipped shapes
TILES = {"divides": kernels.MarchTile(4, 6, 2, 4),
         "ragged": kernels.MarchTile(3, 5, 1, 5)}
SIZES = {"divides": (12,), "ragged": (9, 11), "shipped": (18,)}
CASES = [(name, n) for name, sizes in SIZES.items() for n in sizes]


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


def _fields(n, seed, bnds, lo, hi):
    rng = np.random.default_rng(seed)
    return [stam.set_bnd3d(b, torch.from_numpy(
        rng.uniform(lo, hi, (n + 2,) * 3).astype(np.float32))) for b in bnds]


def _cut(x, gx0, rows):
    """Rows gx0 .. gx0 + rows - 1 of the ghosted field x, zeros outside
    the grid (tests/test_torch_shard_gpu.py's slabs)."""
    out = x.new_zeros((rows,) + tuple(x.shape[1:]))
    lo, hi = max(gx0, 0), min(gx0 + rows, x.shape[0])
    out[lo - gx0:hi - gx0] = x[lo:hi]
    return out


def _placed(fields, n, where):
    """The fields and gx0: cubic, or a padded slab of OWNED + 4 rows at
    the low face, inside, at the high face."""
    if where == "cubic":
        return fields, None
    gx0 = {"low": -1, "inner": n // 2 - 2, "high": n + 1 - OWNED - 2}[where]
    return [_cut(q, gx0, OWNED + 4) for q in fields], gx0


def _tile(name, default):
    return TILES.get(name, default)


def _equal(got, want):
    return all(g.shape == w.shape and torch.equal(g, w)
               for g, w in zip(got, want))


@pytest.mark.parametrize("tile", [kernels.ADVECT_TILE, kernels.FORCING_TILE,
                                  *TILES.values()],
                         ids=["advect", "forcing", *TILES])
@pytest.mark.parametrize("n,rows,gx0", [
    (1, 3, 0), (2, 4, 0), (9, 11, 0), (16, 18, 0), (13, 11, 0),
    (13, 8, -1), (13, 8, 5), (13, 8, 8), (13, 3, -2), (13, 3, 14),
    (13, 20, -3)])
def test_march_plan_writes_every_output_once(tile, n, rows, gx0):
    """tf::zero_rows and tf::for_outputs over every block: each output
    cell of the (rows, n+2, n+2) field is written by exactly one block,
    and each tile's segments cover the centre rows once."""
    plan = kernels.march_plan(n, rows, gx0, tile)
    writes = torch.zeros((rows, n + 2, n + 2), dtype=torch.int32)
    centres = torch.zeros(rows, dtype=torch.int32)
    for i in range(plan.blocks):
        blk = plan.block(i)
        zeroed = torch.ones_like(writes)
        kernels._zero_rows([zeroed], plan, blk)
        writes += (zeroed == 0).int()
        one = torch.ones((blk.y1 - blk.y0 + 1, blk.z1 - blk.z0 + 1))
        for x in range(blk.s0, blk.s1 + 1):
            centres[x] += 1
            put = torch.zeros((rows, n + 2, n + 2))
            kernels._put(put, one, 0, x, blk, plan)
            writes += (put != 0).int()
    assert int(writes.min()) == 1 and int(writes.max()) == 1
    # each tile marches each centre row once
    if plan.c_lo <= plan.c_hi:
        assert centres[plan.c_lo:plan.c_hi + 1].eq(plan.tiles).all()
    assert int(centres.sum()) == plan.tiles * max(0, plan.c_hi - plan.c_lo
                                                  + 1)


@pytest.mark.parametrize("where", ["cubic", "low", "inner", "high"])
@pytest.mark.parametrize("tile,n", CASES)
def test_advect_march_is_bitwise_plain(tile, n, where):
    """k = 1, 2, 3 and b 0-3: the self-advection (the velocity from the
    ring), the scalars, one field, three fields that are not the
    velocity."""
    dt0 = 0.5
    (u, v, w, d, t), gx0 = _placed(
        _fields(n, 1, (1, 2, 3), -1.2 / dt0, 1.2 / dt0)
        + _fields(n, 2, (0, 0), 0.0, 1.0), n, where)
    tile = _tile(tile, kernels.ADVECT_TILE)
    for fields, bnds in (((u, v, w), (1, 2, 3)), ((d, t), (0, 0)),
                         ((d,), (3,)), ((d, t, u), (2, 0, 1))):
        got = kernels.advect3d_march(fields, bnds, u, v, w, dt0, gx0=gx0,
                                     tile=tile)
        want = kernels.advect3d_multi_plain(fields, bnds, u, v, w, dt0,
                                            gx0=gx0)
        assert _equal(got, want), bnds


@pytest.mark.parametrize("where", ["cubic", "low", "inner", "high"])
@pytest.mark.parametrize("tile,n", CASES)
def test_forcing_march_is_bitwise_plain(tile, n, where):
    """Both halves, vorticity alone, buoyancy alone (one elementwise
    pass)."""
    (u, v, w, d, t), gx0 = _placed(
        _fields(n, 3, (1, 2, 3), -1.0, 1.0)
        + _fields(n, 4, (0, 0), 0.0, 1.0), n, where)
    tile = _tile(tile, kernels.FORCING_TILE)
    for coeffs in (dict(vorticity_eps=2.0, buoyancy_alpha=0.05,
                        buoyancy_beta=0.5),
                   dict(vorticity_eps=2.0),
                   dict(buoyancy_alpha=0.05, buoyancy_beta=0.5,
                        ambient_temp=0.2)):
        cfg = stam.StamConfig(n=n, dt=0.5 / n, **coeffs)
        got = kernels.forcing3d_march(u, v, w, d, t, cfg, gx0=gx0, tile=tile)
        want = kernels.forcing3d_plain(u, v, w, d, t, cfg, gx0=gx0)
        assert _equal(got, want), coeffs


def test_slab_without_a_stencil_is_zero():
    """A slab past the grid's high face has no centre row: every output
    cell is 0, in the emulations and the plain versions."""
    n, gx0, rows = 9, 11, 4
    rng = np.random.default_rng(5)
    u, v, w, d, t = (torch.from_numpy(rng.uniform(
        -1.0, 1.0, (rows, n + 2, n + 2)).astype(np.float32))
        for _ in range(5))
    cfg = stam.StamConfig(n=n, dt=0.05, vorticity_eps=2.0,
                          buoyancy_alpha=0.05, buoyancy_beta=0.5)
    tile = TILES["ragged"]
    assert kernels.march_plan(n, rows, gx0, tile).c_lo > \
        kernels.march_plan(n, rows, gx0, tile).c_hi
    for got in (kernels.advect3d_march((u, v, w), (1, 2, 3), u, v, w, 0.5,
                                       gx0=gx0, tile=tile),
                kernels.advect3d_multi_plain((u, v, w), (1, 2, 3), u, v, w,
                                             0.5, gx0=gx0),
                kernels.forcing3d_march(u, v, w, d, t, cfg, gx0=gx0,
                                        tile=tile),
                kernels.forcing3d_plain(u, v, w, d, t, cfg, gx0=gx0)):
        assert all(bool((g == 0).all()) for g in got)


def _consistent(seed, n, bnds, lo=-1.0, hi=1.0):
    """Uniform fields on (n+2)^3 with set_bnd3d(b) applied, as numpy."""
    rng = np.random.default_rng(seed)
    return [np.asarray(jstam.set_bnd3d(b, jnp.asarray(
        rng.uniform(lo, hi, (n + 2,) * 3), jnp.float32))) for b in bnds]


def _close(got, ref, tol):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))


def test_advect_march_matches_pallas_and_dense():
    """The emulated march of the self-advection against interpret-mode
    advect3d_multi_pallas and jstam.advect3d_stencil on the same seeded
    inputs."""
    n, dt = 12, 0.03
    u, v, w = (a / (dt * n) for a in _consistent(5, n, (1, 2, 3), -1.2, 1.2))
    cfg = jstam.StamConfig(n=n, dt=dt)
    dt0 = float(dt * n)
    tu, tv, tw = (torch.from_numpy(np.array(a)) for a in (u, v, w))
    got = kernels.advect3d_march((tu, tv, tw), (1, 2, 3), tu, tv, tw, dt0,
                                 tile=TILES["ragged"])
    ju, jv, jw = map(jnp.asarray, (u, v, w))
    with pltpu.force_tpu_interpret_mode():
        pal = pk.advect3d_multi_pallas((ju, jv, jw), (1, 2, 3), ju, jv, jw,
                                       dt0, tx=4, self_advect=True)
    dense = [jstam.advect3d_stencil(b, jnp.asarray(q), ju, jv, jw, cfg)
             for b, q in ((1, u), (2, v), (3, w))]
    for g, p, ref in zip(got, pal, dense):
        _close(g, p, ADVECT_TOL)
        _close(g, ref, ADVECT_TOL)


def test_forcing_march_matches_pallas_and_dense():
    """The emulated march (both halves) against interpret-mode
    forcing3d_pallas and jstam.buoyancy3d then
    jstam.vorticity_confinement3d on the same seeded inputs."""
    n = 12
    kw = dict(n=n, dt=0.02, ambient_temp=0.2, vorticity_eps=3.0,
              buoyancy_alpha=0.05, buoyancy_beta=1.0)
    u, v, w = _consistent(6, n, (1, 2, 3), -0.6, 0.6)
    d, t = _consistent(7, n, (0, 0), 0.0, 1.0)
    tcfg, jcfg = stam.StamConfig(**kw), jstam.StamConfig(**kw)
    got = kernels.forcing3d_march(
        *(torch.from_numpy(np.array(a)) for a in (u, v, w, d, t)), tcfg,
        tile=TILES["ragged"])
    ju, jv, jw, jd, jt = map(jnp.asarray, (u, v, w, d, t))
    jw = jstam.buoyancy3d(jw, jd, jt, jcfg)
    dense = jstam.vorticity_confinement3d(ju, jv, jw, jcfg)
    with pltpu.force_tpu_interpret_mode():
        pal = pk.forcing3d_pallas(*map(jnp.asarray, (u, v, w, d, t)),
                                  jcfg.dt, 1.0 / n, jcfg.vorticity_eps,
                                  jcfg.buoyancy_alpha, jcfg.buoyancy_beta,
                                  jcfg.ambient_temp, tx=4)
    for g, p, ref in zip(got, pal, dense):
        _close(g, p, FORCING_TOL)
        _close(g, ref, FORCING_TOL)
