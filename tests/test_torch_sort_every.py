"""The port's sort cadence (``sort_every > 1``, base variant) against the
JAX package on the CPU, after tests/test_sort_every.py: the sort step
against the JAX ``_jitted_sort_step`` (interpret-mode Pallas kernels),
nine steps at ``sort_every=3`` against the JAX run at ``sort_every=1``,
for the row-block and the column family, ``use_sort_every``'s refusals,
and the stale passes' identities with the fresh and uncapped ones.

The runs use BASE_CONFIG on a 1x1x1 box of 20^3 cells, which cuts the
interpret-mode column kernel's 1600 programs to 400, with every
particle in the domain; the JAX sort step runs op by op.  The nine-step
reference runs the JAX package's XLA path: its pair set is both
families' at ``sort_every=1`` while no column overflows.  Tolerances:
tests/test_sort_every.py's, rtol 1e-6 and atol 1e-7 for the sort step
(its forces sum in another order here, so the comparison is to float32
rounding), rtol 3e-4 and atol 2e-4 *
max(1, max|ref|) for nine steps."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpufluids import config as jconfig
from tpufluids import scenes as jscenes
from tpufluids import step as jstep
from tpufluids.oracle import state_to_dict
from tpufluids_torch import binning, config, convert, forces, sph_kernels
from tpufluids_torch import step

BOX = dict(xmin=-0.5, ymin=-0.5, zmin=-0.5, xmax=0.5, ymax=0.5, zmax=0.5,
           grid_size=20)
JCFG = jconfig.BASE_CONFIG.replace(force_backend="pallas", pallas_col_cap=64,
                                   max_per_cell=32, **BOX)


def _by_pid(st):
    d = st if isinstance(st, dict) else convert.state_to_numpy(st)
    o = np.argsort(d["pid"])
    return {k: v[o] for k, v in d.items()}


def _port(jcfg):
    return convert.config_from_dict(dataclasses.asdict(jcfg))


@pytest.mark.parametrize("family", ["column", "rowblock"])
def test_sort_step_matches_jax_sort_step(family):
    jcfg = JCFG.replace(pallas_kernel=family, sort_every=8)
    jst = jscenes.random_blob(150, seed=5, cfg=jcfg, span=0.4)
    # op by op: jitted, XLA rounds the equation of state's ^7 otherwise
    # (0.58 of a 2e5 pressure here), as tests/test_sort_every.py notes
    with jax.disable_jit(), pltpu.force_tpu_interpret_mode():
        ref, jbt, _ = jstep._jitted_sort_step(jst, jcfg)
    tst = convert.state_from_numpy(state_to_dict(jst), device="cpu")
    step.sph_sort_step.calls = 0
    out, bt, m = step.sph_sort_step(tst, _port(jcfg))
    assert step.sph_sort_step.calls == 1
    np.testing.assert_array_equal(bt.cell_start.numpy(),
                                  np.asarray(jbt.cell_start))
    refd, outd = _by_pid(state_to_dict(ref)), _by_pid(out)
    np.testing.assert_array_equal(outd["pid"], refd["pid"])
    # the pool comes back in cell order, as the JAX sort step leaves it
    np.testing.assert_array_equal(out.pid.numpy(), np.asarray(ref.pid))
    for f in ("pos", "vel", "dens", "press"):
        np.testing.assert_allclose(outd[f], refd[f], rtol=1e-6, atol=1e-7,
                                   err_msg=f)
    assert int(m.n_alive) == 150 and int(m.bin_overflow) == 0


@pytest.mark.parametrize("family", ["column", "rowblock"])
def test_sort_every_3_tracks_jax_every_step(family, monkeypatch):
    jcfg = JCFG.replace(pallas_kernel=family, force_backend="xla")
    jst = jscenes.random_blob(150, seed=11, cfg=jcfg, span=0.4)
    ref, jm = jstep.run_python(jst, jcfg, 9)
    tcfg = _port(jcfg).replace(sort_every=3, force_backend="auto")
    tst = convert.state_from_numpy(state_to_dict(jst), device="cpu")
    step.sph_sort_step.calls = 0
    stale = []
    name = f"base_forces_{family}_plain"
    plain = getattr(sph_kernels, name)
    monkeypatch.setattr(sph_kernels, name, lambda *a: stale.append(a[4])
                        or plain(*a))
    before = sph_kernels.launch_counts()
    out, m = step.run_python(tst, tcfg, 9)
    assert step.sph_sort_step.calls == 3 and stale == [True] * 9
    assert sph_kernels.launch_counts() == before       # plain on the CPU
    refd, outd = _by_pid(state_to_dict(ref)), _by_pid(out)
    np.testing.assert_array_equal(outd["pid"], refd["pid"])
    for f in ("pos", "vel"):
        scale = max(1.0, np.abs(refd[f]).max())
        np.testing.assert_allclose(outd[f], refd[f], rtol=3e-4,
                                   atol=2e-4 * scale, err_msg=f)
    assert int(m.n_alive) == int(jm.n_alive) == 150
    assert int(m.bin_overflow) == 0


def test_sort_every_rejects_unidyn_and_xla():
    with pytest.raises(ValueError, match="base variant"):
        step.use_sort_every(config.UNIDYN_CONFIG.replace(sort_every=4))
    with pytest.raises(ValueError, match="Pallas"):
        step.use_sort_every(config.BASE_CONFIG.replace(sort_every=4,
                                                       force_backend="xla"))
    with pytest.raises(ValueError, match="Pallas"):
        step.use_sort_every(config.BASE_CONFIG.replace(sort_every=4),
                            subbin_parity=True)
    assert not step.use_sort_every(config.BASE_CONFIG)
    assert step.use_sort_every(config.BASE_CONFIG.replace(sort_every=2))
    assert step.use_sort_every(config.BASE_CONFIG.replace(
        sort_every=2, force_backend="pallas"))


def test_stale_passes_meet_the_fresh_and_uncapped_ones():
    """The identities the card holds bit for bit, on the plain versions:
    the column pass with caps above every column equals the row-block
    pass, fresh and stale, bit for bit; on a just-sorted pool the stale
    pass equals the fresh one (to rounding: the plain stale pass sums
    whole columns, in another order)."""
    cfg = config.BASE_CONFIG.replace(**BOX)
    rng = np.random.default_rng(2)
    st = convert.state_from_numpy(state_to_dict(jscenes.random_blob(
        400, seed=2, cfg=JCFG, span=0.45)), device="cpu")
    st = st.replace(dens=torch.tensor(rng.uniform(9300, 9900, 400),
                                      dtype=torch.float32),
                    press=torch.tensor(rng.normal(0, 3e4, 400),
                                       dtype=torch.float32))
    st, bt, _ = binning.sort_by_cell(st, cfg)
    big = cfg.replace(pallas_col_cap=400)
    fresh = sph_kernels.base_forces_rowblock_plain(st, bt, cfg, bt.order)
    sorted_stale = sph_kernels.base_forces_rowblock_plain(st, bt, cfg,
                                                          bt.order, True)
    for a, b in zip(fresh[:2], sorted_stale[:2]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    moved = st.replace(pos=st.pos + torch.tensor(
        rng.uniform(-0.02, 0.02, (400, 3)), dtype=torch.float32))
    for pool in (st, moved):
        for stale in (False, True):
            want = sph_kernels.base_forces_rowblock_plain(pool, bt, cfg,
                                                          bt.order, stale)
            got = sph_kernels.base_forces_column_plain(pool, bt, big,
                                                       bt.order, stale)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
            assert int(got[2]) == 0
    # some moved rows left their cells, and the stale mask keeps some
    # pairs of a row's whole neighbour columns and drops others
    now = binning.cell_trunc(moved.pos, cfg)
    assert bool((now != binning.cell_trunc(st.pos, cfg)).any())
    near = forces.near_cells(now, now[None].expand(400, 400, 3))
    assert bool(near.any()) and not bool(near.all())
