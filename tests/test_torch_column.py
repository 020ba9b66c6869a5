"""The port's column force family (base variant) and the binning it
reads, against the JAX package on the CPU, with inputs made from numpy
seeds: the effective column caps, ``suggest_col_cap``, ``permute_pool``
and ``sort_by_cell`` (exact), and ``base_forces_column_plain`` against
the interpret-mode ``base_forces_pallas``, fresh and stale
(``xy_cells``), on a blob under the cap and on a dense one over it.

The kernel comparisons run BASE_CONFIG on a 1x1x1 box of 20^3 cells,
which cuts the interpret-mode kernel's 1600 column programs to 400, and
keep every particle in the domain (the Pallas masks floor cell
coordinates where the port truncates, ROADMAP Queue 3).  Tolerances:
those of tests/test_torch_sph.py's forces, rtol 2e-4 and atol 1e-6 *
max(1, max|ref|) (the sums run in another order); overflow counts and
the capped-out rows' zeros are exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpufluids import binning as jbinning
from tpufluids import config as jconfig
from tpufluids import scenes as jscenes
from tpufluids import sph_pallas
from tpufluids import state as jstate
from tpufluids import step as jstep
from tpufluids.oracle import state_to_dict
from tpufluids.sph_pallas import base_forces_pallas
from tpufluids_torch import binning, config, convert, sph_kernels

BOX = dict(xmin=-0.5, ymin=-0.5, zmin=-0.5, xmax=0.5, ymax=0.5, zmax=0.5,
           grid_size=20)


def _close(got, ref, name):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    np.testing.assert_allclose(got, ref, rtol=2e-4,
                               atol=1e-6 * max(1.0, np.abs(ref).max()),
                               err_msg=name)


def _jax_caps(monkeypatch, jcfg):
    """(b, w_cap) that the JAX package's dispatch hands its column kernel,
    read off the kernel's arguments (the kernel itself does not run)."""
    seen = {}

    def fake_pallas_call(kern, *, out_shape, **_):
        seen.update(b=kern.keywords["b"], w_cap=kern.keywords["w_cap"])
        return lambda *args: jnp.zeros(out_shape.shape, out_shape.dtype)

    monkeypatch.setattr(sph_pallas.pl, "pallas_call", fake_pallas_call)
    st = jscenes.random_blob(20, seed=0, cfg=jcfg)
    order, bt = jbinning.sort_tables(st, jcfg)
    jstep.dispatch_forces(st, bt, jcfg, order=order)
    return seen["b"], seen["w_cap"]


@pytest.mark.parametrize("variant", ["base", "unidyn"])
@pytest.mark.parametrize("cap", [80, 128, 200, 584])
def test_column_caps_match_jax(monkeypatch, variant, cap):
    preset = "BASE_CONFIG" if variant == "base" else "UNIDYN_CONFIG"
    jcfg = getattr(jconfig, preset).replace(
        pallas_col_cap=cap, pallas_kernel="column", force_backend="pallas")
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    assert config.column_caps(tcfg) == _jax_caps(monkeypatch, jcfg)
    if variant == "base":
        assert config.column_caps(tcfg) == {
            80: (80, 128), 128: (128, 128), 200: (256, 256),
            584: (640, 640)}[cap]
    else:
        assert config.column_caps(tcfg)[0] == cap


def _fill(n, seed=0):
    pos = np.random.default_rng(seed).uniform(-0.9, 0.9, (n, 3))
    return pos.astype(np.float32)


@pytest.mark.parametrize("scene", ["fill-524k", "base_dam", "padded"])
def test_suggest_col_cap_equals_jax(scene):
    jcfg = jconfig.BASE_CONFIG
    if scene == "fill-524k":
        jst = jstate.make_state(_fill(524288), cfg=jcfg)
    elif scene == "base_dam":
        jst = jscenes.base_dam(jcfg)
    else:
        jst = jscenes.random_blob(300, seed=4, span=1.2, capacity=400)
    tst = convert.state_from_numpy(state_to_dict(jst), device="cpu")
    got = binning.suggest_col_cap(tst, config.BASE_CONFIG)
    assert got == jbinning.suggest_col_cap(jst, jcfg)
    if scene == "fill-524k":
        # the JAX package's own measurement (BASELINE.md, "524k (cap 584)")
        assert got == 584


def test_permute_pool_and_sort_by_cell_equal_jax():
    jcfg = jconfig.UNIDYN_CONFIG
    jst = jscenes.random_blob(300, seed=6, cfg=jcfg, span=1.2, capacity=320)
    tst = convert.state_from_numpy(state_to_dict(jst), device="cpu")
    rng = np.random.default_rng(1)
    perm = rng.permutation(320)
    got = convert.state_to_numpy(binning.permute_pool(
        tst, torch.from_numpy(perm)))
    ref = state_to_dict(jbinning.permute_pool(jst, jnp.asarray(perm)))
    for f in ref:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)

    tcfg = config.UNIDYN_CONFIG
    sorted_t, bt, perm = binning.sort_by_cell(tst, tcfg)
    sorted_j, jbt = jbinning.sort_by_cell(jst, jcfg, runs=False)
    got, ref = convert.state_to_numpy(sorted_t), state_to_dict(sorted_j)
    for f in ref:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jbt.order))
    order, fresh = binning.sort_tables(tst, tcfg)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jbt.order))
    np.testing.assert_array_equal(bt.order.numpy(), np.arange(320))
    for f in ("cid", "cell_start", "in_dom", "home_count", "octant"):
        want = np.asarray(getattr(jbt, f))
        if f == "in_dom":
            # the JAX tables of a permuted pool mark dead rows in the
            # domain too; its kernels and the port's read alive & in_dom
            want = want & np.asarray(sorted_j.alive)
        np.testing.assert_array_equal(getattr(bt, f).numpy(), want,
                                      err_msg=f)
        np.testing.assert_array_equal(getattr(bt, f).numpy(),
                                      getattr(fresh, f).numpy(), err_msg=f)
    assert not bt.in_dom.all() and bt.in_dom.any()


def _blob(n, seed, span):
    """A random blob in BOX with dens, press and vel drawn from ``seed``,
    as numpy arrays, and the same blob moved by up to 0.4 of a cell (the
    positions a stale step sees), still in the box."""
    jcfg = jconfig.BASE_CONFIG.replace(**BOX)
    d = state_to_dict(jscenes.random_blob(n, seed=seed, cfg=jcfg, span=span,
                                          boundary_frac=0.1))
    rng = np.random.default_rng(seed + 100)
    d["dens"] = rng.uniform(9300.0, 9900.0, n).astype(np.float32)
    d["press"] = rng.normal(0.0, 3e4, n).astype(np.float32)
    moved = (d["pos"] + rng.uniform(-0.02, 0.02, (n, 3))).astype(np.float32)
    assert np.abs(moved).max() < 0.5
    return d, moved


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "xy_cells"])
@pytest.mark.parametrize("n,span,cap,w_chunk", [
    (300, 0.45, 64, 64),     # every column under the cap
    (400, 0.15, 8, 12),      # b 8, w_cap 12: columns over both
], ids=["fits", "overflows"])
def test_column_plain_matches_pallas_interpret(n, span, cap, w_chunk, stale):
    jcfg = jconfig.BASE_CONFIG.replace(pallas_col_cap=cap,
                                       pallas_w_chunk=w_chunk, **BOX)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    b, w_cap = config.column_caps(tcfg)
    d, moved = _blob(n, 3, span)
    jst = jstate.ParticleState(**{k: jnp.asarray(v) for k, v in d.items()})
    tst = convert.state_from_numpy(d, device="cpu")
    if stale:
        # tables of the last sort, positions of now; the pool lies in the
        # sort's order
        jst, jbt = jbinning.sort_by_cell(jst, jcfg, runs=False)
        jst = jst.replace(pos=jnp.asarray(moved)[jbt.order])
        jorder = None
        tst, bt, _ = binning.sort_by_cell(tst, tcfg)
        tst = tst.replace(pos=torch.tensor(moved[np.asarray(jbt.order)]))
    else:
        jorder, jbt = jbinning.sort_tables(jst, jcfg)
        _, bt = binning.sort_tables(tst, tcfg)
    with pltpu.force_tpu_interpret_mode():
        sw, dp, ovf = base_forces_pallas(
            jst, jbt, jcfg, b=cap, w_cap=cap, order=jorder, w_chunk=w_chunk,
            xy_cells=stale)
    got = sph_kernels.base_forces_column_plain(tst, bt, tcfg, bt.order,
                                               stale)
    _close(got[0].numpy(), sw, "sum_w")
    _close(got[1].numpy(), dp, "dpress")
    assert float(np.abs(np.asarray(dp)).max()) > 0.0

    # the overflow counts, and the rows over the home cap: zero in both
    col_start = binning.column_start(bt, tcfg).numpy()
    counts = np.diff(col_start)
    assert int(got[2]) == int(ovf) == int(np.maximum(counts - b, 0).sum())
    cid = bt.cid.numpy()
    inside = cid < tcfg.num_cells
    g = tcfg.grid_size
    rank = np.arange(cid.size) - col_start[np.minimum(cid // g, g * g - 1)]
    capped = bt.order.numpy()[inside & (rank >= b)]
    if cap == 8:
        assert int(ovf) > 0 and counts.max() > w_cap and capped.size > 0
    else:
        assert int(ovf) == 0 and counts.max() <= b and capped.size == 0
    for out, ref in ((got[0].numpy(), sw), (got[1].numpy(), dp)):
        assert not out[capped].any() and not np.asarray(ref)[capped].any()
