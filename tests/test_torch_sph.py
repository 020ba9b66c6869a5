"""The port's SPH base modules against the JAX package, on the CPU, at
150-300 particles (and one 40000-particle pool for the sort), with
inputs made from numpy seeds.

Tolerances:
* smoothing kernels and the update: 1e-6 relative (float32 rounding of
  the same expressions; the port folds its Python-float constants in
  double precision where JAX folds them in float32);
* forces: rtol 2e-4 and atol 1e-6 * max(1, max|ref|), those of
  tests/test_forces_vs_oracle.py (the sums run in another order);
* the sort tables: exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpufluids import binning as jbinning
from tpufluids import config as jconfig
from tpufluids import forces as jforces
from tpufluids import integrate as jintegrate
from tpufluids import kernels as jkernels
from tpufluids import scenes as jscenes
from tpufluids import state as jstate
from tpufluids.oracle import accumulate, state_to_dict
from tpufluids.sph_pallas import base_forces_rowblock as jax_rowblock
from tpufluids_torch import (binning, config, convert, forces, integrate,
                             kernels, scenes, sph_kernels, state, step)

CFG = config.BASE_CONFIG


def _assert_close(got, ref, name, rtol, atol):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol * max(1.0, np.abs(ref).max()),
                               err_msg=name)


def _forces_close(got, ref, name):
    _assert_close(got, ref, name, rtol=2e-4, atol=1e-6)


def _randomised(jst, seed):
    """The state as numpy arrays, with dens, press and vel of the alive
    rows drawn from ``seed`` (at a scene's first step press = 0 and
    dpress would be 0)."""
    d = {k: v.copy() for k, v in state_to_dict(jst).items()}
    rng = np.random.default_rng(seed + 100)
    m = d["alive"]
    k = int(m.sum())
    d["dens"][m] = rng.uniform(9300.0, 9900.0, k).astype(np.float32)
    d["press"][m] = rng.normal(0.0, 3e4, k).astype(np.float32)
    d["vel"][m] = rng.normal(0.0, 0.5, (k, 3)).astype(np.float32)
    return d


def _both(d):
    """(JAX ParticleState, port ParticleState) holding ``d``."""
    return (jstate.ParticleState(**{k: jnp.asarray(v) for k, v in d.items()}),
            convert.state_from_numpy(d, device="cpu"))


def _blob(n, seed, **kw):
    return _both(_randomised(jscenes.random_blob(n, seed=seed, **kw), seed))


# --- configuration and state ----------------------------------------------


def test_config_fields_and_defaults_match():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(config.SPHConfig) == fields(jconfig.SPHConfig)
    assert config.PI_REF == jconfig.PI_REF


@pytest.mark.parametrize("name", ["BASE_CONFIG", "UNIDYN_CONFIG"])
def test_config_round_trips(name):
    jcfg = getattr(jconfig, name)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    assert tcfg == getattr(config, name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.num_cells, tcfg.support, tcfg.yield_denom) == (
        jcfg.num_cells, jcfg.support, jcfg.yield_denom)
    with pytest.raises(ValueError, match="bogus"):
        convert.config_from_dict({**dataclasses.asdict(jcfg), "bogus": 1})


def test_smoothing_kernels_match():
    h = CFG.cutoff
    r = np.linspace(0.0, 2.5 * h, 2001).astype(np.float32)
    for name in ("w_cubic", "w_cubic_deriv", "grad_w_spiky"):
        got = getattr(kernels, name)(torch.from_numpy(r), h).numpy()
        ref = np.asarray(getattr(jkernels, name)(jnp.asarray(r),
                                                 jnp.float32(h)))
        _assert_close(got, ref, name, rtol=1e-6, atol=1e-6)
    assert kernels.w0(h) == pytest.approx(jkernels.w0(h), rel=1e-12)


def test_make_state_and_scenes_match():
    pairs = [
        (scenes.base_dam(CFG, nb=60, capacity=8100, device="cpu"),
         jscenes.base_dam(jconfig.BASE_CONFIG, nb=60, capacity=8100)),
        (scenes.random_blob(200, seed=3, boundary_frac=0.3, capacity=256,
                            device="cpu"),
         jscenes.random_blob(200, seed=3, boundary_frac=0.3, capacity=256)),
    ]
    for tst, jst in pairs:
        got, ref = convert.state_to_numpy(tst), state_to_dict(jst)
        assert set(got) == set(ref) == set(state.FIELDS)
        for f in state.FIELDS:
            assert got[f].dtype == ref[f].dtype, f
            np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    assert pairs[0][0].capacity == 8100


def test_state_conversion_rejects_bad_fields():
    d = state_to_dict(jscenes.random_blob(20, seed=0))
    with pytest.raises(ValueError, match="pid"):
        convert.state_from_numpy({k: v for k, v in d.items() if k != "pid"},
                                 device="cpu")
    with pytest.raises(ValueError, match="extra"):
        convert.state_from_numpy({**d, "extra": d["mass"]}, device="cpu")


# --- binning ---------------------------------------------------------------


@pytest.mark.parametrize("n,span,capacity", [
    (300, 0.5, 384),      # dead padding rows
    (300, 1.3, 320),      # particles outside the domain, and padding
    (40000, 0.95, None),  # above the JAX int32 packed-key branch
], ids=["padded", "outside", "40000"])
def test_sort_tables_equal_jax(n, span, capacity):
    jst = jscenes.random_blob(n, seed=5, span=span, capacity=capacity)
    tst = convert.state_from_numpy(state_to_dict(jst), device="cpu")
    jorder, jbt = jbinning.sort_tables(jst, jconfig.BASE_CONFIG)
    order, bt = binning.sort_tables(tst, CFG)
    assert order is bt.order
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(bt.cid.numpy(), np.asarray(jbt.cid))
    np.testing.assert_array_equal(bt.cell_start.numpy(),
                                  np.asarray(jbt.cell_start))
    np.testing.assert_array_equal(bt.in_dom.numpy(), np.asarray(jbt.in_dom))
    if span > 1:
        assert not bt.in_dom.all()


def test_run_table_matches_build_bins():
    jst = jscenes.random_blob(300, seed=6, span=0.2, capacity=320)
    jcfg = jconfig.BASE_CONFIG.replace(max_per_cell=64)
    _, jbt = jbinning.sort_by_cell(jst, jcfg)
    assert int(jbt.overflow) == 0
    _, bt = binning.sort_tables(
        convert.state_from_numpy(state_to_dict(jst), device="cpu"), CFG)
    start, length = binning.run_table(bt, CFG)
    np.testing.assert_array_equal(length.numpy(), np.asarray(jbt.run_len))
    live = length.numpy() > 0
    np.testing.assert_array_equal(start.numpy()[live],
                                  np.asarray(jbt.run_start)[live])


# --- forces ----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_forces_match_compute_forces(seed):
    jst, tst = _blob(150, seed, span=0.12, boundary_frac=0.2)
    jcfg = jconfig.BASE_CONFIG.replace(max_per_cell=32)
    sorted_state, jbt = jbinning.sort_by_cell(jst, jcfg)
    assert int(jbt.overflow) == 0
    ref = jforces.compute_forces(sorted_state, jbt, jcfg)
    order, bt = binning.sort_tables(tst, CFG)
    acc = forces.compute_forces(tst, bt, CFG)
    rows = np.asarray(jbt.order)          # pool row of each sorted row
    _forces_close(acc.sum_w.numpy()[rows], ref.sum_w, "sum_w")
    _forces_close(acc.dpress.numpy()[rows], ref.dpress, "dpress")
    assert float(np.abs(ref.dpress).max()) > 0.0

    # the wrapper runs the plain version on CPU tensors, with no launch
    before = sph_kernels.base_forces_rowblock.launches
    sw, dp, ovf = sph_kernels.base_forces_rowblock(tst, bt, CFG, order)
    assert sph_kernels.base_forces_rowblock.launches == before
    assert torch.equal(sw, acc.sum_w) and torch.equal(dp, acc.dpress)
    assert int(ovf) == 0


def test_plain_forces_match_pallas_rowblock_interpret():
    # in the domain: the Pallas kernel floors cell coordinates where the
    # binning truncates, which differs only below a low face
    jst, tst = _blob(300, 2, span=0.5, boundary_frac=0.1)
    jorder, jbt = jbinning.sort_tables(jst, jconfig.BASE_CONFIG)
    with pltpu.force_tpu_interpret_mode():
        sw, dp, ovf = jax_rowblock(jst, jbt, jconfig.BASE_CONFIG,
                                   order=jorder)
    order, bt = binning.sort_tables(tst, CFG)
    got = sph_kernels.base_forces_rowblock_plain(tst, bt, CFG, order)
    _forces_close(got[0].numpy(), sw, "sum_w")
    _forces_close(got[1].numpy(), dp, "dpress")
    assert int(ovf) == int(got[2]) == 0
    assert float(np.abs(np.asarray(sw)).max()) > 0.0


def test_chunked_plain_pass_is_exact(monkeypatch):
    _, tst = _blob(300, 3, span=0.3, capacity=320)
    _, bt = binning.sort_tables(tst, CFG)
    whole = forces.compute_forces(tst, bt, CFG)
    monkeypatch.setattr(forces, "CHUNK_SLOTS", 500)
    chunked = forces.compute_forces(tst, bt, CFG)
    assert torch.equal(chunked.sum_w, whole.sum_w)
    assert torch.equal(chunked.dpress, whole.dpress)
    dead = ~tst.alive
    assert bool((whole.sum_w[dead] == 0).all())


def test_band_below_low_face_follows_truncation():
    """Particles at z in (-1.04, -1) truncate into cell 0, so they are
    binned in the domain, as the reference's int() cast and the JAX
    binning have it (the JAX row-block Pallas kernel floors them to
    cell -1; ROADMAP Queue 3)."""
    rng = np.random.default_rng(7)
    n = 300
    pos = np.stack([rng.uniform(-0.12, 0.12, n), rng.uniform(-0.12, 0.12, n),
                    rng.uniform(-1.04, -0.85, n)], axis=1).astype(np.float32)
    band = (pos[:, 2] > -1.04) & (pos[:, 2] < -1.0)
    assert band.sum() > 30
    jst = jstate.make_state(pos, cfg=jconfig.BASE_CONFIG,
                            boundary=rng.uniform(size=n) < 0.2)
    jst, tst = _both(_randomised(jst, 7))
    jcfg = jconfig.BASE_CONFIG.replace(max_per_cell=64)
    sorted_state, jbt = jbinning.sort_by_cell(jst, jcfg)
    assert int(jbt.overflow) == 0
    ref = jforces.compute_forces(sorted_state, jbt, jcfg)
    oracle = accumulate(state_to_dict(sorted_state), jcfg, "stencil")
    _, bt = binning.sort_tables(tst, CFG)
    assert bool(bt.in_dom.all())
    acc = forces.compute_forces(tst, bt, CFG)
    rows = np.asarray(jbt.order)
    for want in (ref, oracle):
        _forces_close(acc.sum_w.numpy()[rows], want.sum_w, "sum_w")
        _forces_close(acc.dpress.numpy()[rows], want.dpress, "dpress")
    assert bool((acc.sum_w[torch.from_numpy(band)] > 0).all())


# --- update and step -------------------------------------------------------


def test_update_matches_jax():
    jst, tst = _blob(200, 4, span=0.12, boundary_frac=0.2, capacity=224)
    rng = np.random.default_rng(11)
    n = 224
    sum_w = rng.uniform(0.0, 6000.0, n).astype(np.float32)
    dpress = rng.normal(0.0, 5.0, (n, 3)).astype(np.float32)
    z3 = jnp.zeros((n, 3), jnp.float32)
    z33 = jnp.zeros((n, 3, 3), jnp.float32)
    jacc = jforces.ForceAccum(
        sum_w=jnp.asarray(sum_w), dpress=jnp.asarray(dpress), diffusion=z3,
        vel_grad=z33, stress_accel=z3, solid_drift=z3, fluid_drift=z3,
        mixture_accel=z3, delsolid=jnp.zeros(n), delfluid=jnp.zeros(n),
        stress_scaled=jst.stress, stress_rate=z33,
        split_trigger=jnp.zeros(n, bool),
        merge_partner=jnp.full(n, -1, jnp.int32))
    ref = state_to_dict(jintegrate.update(jst, jacc, jconfig.BASE_CONFIG))
    got = convert.state_to_numpy(integrate.update(
        tst, forces.ForceAccum(torch.from_numpy(sum_w),
                               torch.from_numpy(dpress)), CFG))
    for f in state.FIELDS:
        _assert_close(got[f], ref[f], f, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cfg,kw,error,match", [
    (CFG.replace(subbin_parity=True, sort_every=2), {}, ValueError,
     "Pallas"),
    (CFG.replace(sort_every=2), dict(subbin_parity=True), ValueError,
     "Pallas"),
    (config.UNIDYN_CONFIG.replace(sort_every=3), {}, ValueError,
     "base variant"),
], ids=["subbin_cfg", "subbin_call", "unidyn_sort_every"])
def test_outside_the_slice_raises(cfg, kw, error, match):
    st = scenes.random_blob(20, seed=0, device="cpu")
    with pytest.raises(error, match=match):
        step.sph_step(st, cfg, **kw)
    with pytest.raises(error, match=match):
        step.run_python(st, cfg, 1, **kw)


@pytest.mark.parametrize("cfg,capacity,kernel", [
    (config.UNIDYN_CONFIG.replace(pallas_kernel="column"), None,
     "unidyn_forces_column"),
    (CFG.replace(sort_every=2), None, "base_forces_rowblock"),
    (CFG.replace(pallas_kernel="column"), None, "base_forces_column"),
    (CFG.replace(pallas_kernel="resident"), None, "base_forces_column"),
    (CFG, step.ROWBLOCK_MAX_POOL + 1, "base_forces_column"),
], ids=["unidyn", "sort_every", "column", "resident", "auto_above_rowblock"])
def test_column_and_cadence_paths_run(cfg, capacity, kernel, monkeypatch):
    """The paths that raised before the column family and the sort
    cadence were ported: each step goes through the force wrapper the
    JAX package's dispatch picks (its plain version on the CPU)."""
    calls = []
    plain = getattr(sph_kernels, kernel + "_plain")
    monkeypatch.setattr(sph_kernels, kernel + "_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    st = scenes.random_blob(20, seed=0, cfg=cfg, capacity=capacity,
                            device="cpu")
    one, _ = step.sph_step(st, cfg)
    out, m = step.run_python(st, cfg, 3)
    assert len(calls) == 4
    assert int(m.n_alive) == 20 and int(m.bin_overflow) == 0
    assert float(m.total_mass) == 20.0
    assert bool(torch.isfinite(out.pos).all())
    assert not torch.equal(out.pos, one.pos)


def test_auto_above_rowblock_pool_and_slabs_raise():
    assert step.resolve_kernel_family(CFG, step.ROWBLOCK_MAX_POOL) == (
        "rowblock")
    assert step.resolve_kernel_family(CFG, step.ROWBLOCK_MAX_POOL + 1) == (
        "column")
    # unidyn: above the resident budget and the row-block pool, and a
    # "resident" request above the budget, go to the column family
    unidyn = config.UNIDYN_CONFIG
    assert step.resolve_unidyn_kernel(unidyn, 14040) == "resident"
    assert step.resolve_unidyn_kernel(
        unidyn.replace(pallas_kernel="rowblock"), 14040) == "rowblock"
    assert step.resolve_unidyn_kernel(
        unidyn.replace(pallas_kernel="column"), 14040) == "column"
    assert step.resolve_unidyn_kernel(unidyn, 200000) == "rowblock"
    assert step.resolve_unidyn_kernel(
        unidyn.replace(pallas_kernel="resident"), 200000) == "column"
    assert step.resolve_unidyn_kernel(unidyn, 262145) == "column"
    # a slab bins the rows of its planes, local ids, and the sub-binned
    # base pass runs on its tables (held against JAX in test_torch_sph_xla
    # and test_torch_particles_sharded)
    st = scenes.random_blob(20, seed=0, device="cpu")
    slab = binning.GridSpec(g=CFG.grid_size, x_planes=10, x_offset=15)
    _, bt = binning.sort_tables(st, CFG, grid=slab, subbin=True)
    cx = binning.cell_coords(st.pos, CFG)[:, 0]
    inside = int(((cx >= 15) & (cx < 25)).sum())
    assert 0 < inside < 20 and int(bt.in_dom.sum()) == inside
    assert bt.grid == slab and bt.cell_start.shape == (slab.num_cells + 2,)
    acc = forces.compute_forces(st, bt, CFG, subbin_parity=True)
    assert bool(torch.isfinite(acc.dpress).all())
    with pytest.raises(ValueError, match="grid_size"):
        binning.sort_tables(st, CFG, grid=slab._replace(g=8))


def test_kernel_wrapper_rejects_other_devices():
    st = scenes.random_blob(20, seed=0, device="cpu")
    order, bt = binning.sort_tables(st, CFG)
    meta = st.replace(**{f: getattr(st, f).to("meta") for f in state.FIELDS})
    for fn in (sph_kernels.base_forces_rowblock,
               sph_kernels.base_forces_column):
        with pytest.raises(ValueError, match="meta"):
            fn(meta, bt, CFG, order)
        with pytest.raises(ValueError, match="order"):
            fn(st, bt, CFG, order.to(torch.int32))
        with pytest.raises(ValueError, match="base variant"):
            fn(st, bt, config.UNIDYN_CONFIG, order)
