"""The port's unidyn column family against the JAX package on the CPU:
``unidyn_forces_column_plain`` against the interpret-mode
``unidyn_forces_pallas`` on mixed-phase blobs (with and without
sub-binning, with merges, and over the column cap), and a few steps of
the reference's tank, cut to 2000 fluid and 808 boundary particles,
forced to the column family.

The kernel comparisons run UNIDYN_CONFIG on a box of 9^3 cells
(|x|, |y|, |z| < 0.54), which cuts the interpret-mode kernels' 289
column programs to 81, and keep every particle in the domain (the Pallas
masks floor cell coordinates where the port truncates, ROADMAP Queue 3).
Mixed phases, because on the reference's own tank the drift, velocity
gradient, stress acceleration and mixture terms are exactly 0.

The tank's JAX run goes op by op through its XLA path, whose pair set is
the column family's when no column overflows (the cut tank's columns
hold at most 36 of the 128 rows the cap allows), as
tests/test_torch_unidyn_slice.py runs it.

Tolerances: those of tests/test_torch_unidyn.py for the forces (rtol
2e-4, 1e-3 for the drift, mixture and transport fields, atol 1e-6 *
max(1, max|ref|)) and of tests/test_torch_unidyn_slice.py for the steps;
pair counts, merge partners, overflow counts and the capped-out rows'
zeros are exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_forces_vs_oracle import mixed_blob
from tests.test_torch_unidyn_slice import _assert_states_close
from tpufluids import binning as jbinning
from tpufluids import config as jconfig
from tpufluids import scenes as jscenes
from tpufluids import state as jstate
from tpufluids import step as jstep
from tpufluids.oracle import state_to_dict
from tpufluids.sph_pallas import unidyn_forces_pallas
from tpufluids_torch import (binning, config, convert, scenes, sph_kernels,
                             step)

BOX = dict(xmin=-0.54, ymin=-0.54, zmin=-0.54, xmax=0.54, ymax=0.54,
           zmax=0.54, grid_size=9)
LOOSE = ("solid_drift", "fluid_drift", "mixture_accel", "delsolid",
         "delfluid")
PAIR_FIELDS = ("sum_w", "dpress", "diffusion", "vel_grad", "stress_accel",
               "solid_drift", "fluid_drift", "mixture_accel", "delsolid",
               "delfluid")


def _close(got, ref, name, rtol, atol=1e-6):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol * max(1.0, np.abs(ref).max()),
                               err_msg=name)


@pytest.mark.parametrize("n,span,cap,w_chunk,subbin,merge", [
    (140, 0.45, 128, 64, 6, True),
    (140, 0.45, 128, 64, None, False),
    (300, 0.15, 12, 8, 6, True),        # b 12, w_cap 16: over both
], ids=["subbin-merge", "full-stencil", "overflows"])
def test_column_plain_matches_pallas_interpret(n, span, cap, w_chunk,
                                               subbin, merge):
    jcfg = jconfig.UNIDYN_CONFIG.replace(
        pallas_col_cap=cap, pallas_w_chunk=w_chunk,
        merge_dist=0.03 if merge else -10.0, **BOX)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    b, w_cap = config.column_caps(tcfg)
    d = state_to_dict(mixed_blob(n, 3, jcfg, span=span))
    d["dens"] = np.random.default_rng(5).uniform(9300.0, 9900.0, n).astype(
        np.float32)
    jst = jstate.ParticleState(**{k: jnp.asarray(v) for k, v in d.items()})
    tst = convert.state_from_numpy(d, device="cpu")
    jorder, jbt = jbinning.sort_tables(jst, jcfg)
    with pltpu.force_tpu_interpret_mode():
        ref = unidyn_forces_pallas(jst, jbt, jcfg, b=cap, w_cap=cap,
                                   order=jorder, w_chunk=w_chunk,
                                   subbin_threshold=subbin)
    order, bt = binning.sort_tables(tst, tcfg)
    got = sph_kernels.unidyn_forces_column_plain(tst, bt, tcfg, order,
                                                 subbin_threshold=subbin)
    for f in PAIR_FIELDS:
        _close(got[f].numpy(), np.asarray(ref[f]), f,
               1e-3 if f in LOOSE else 2e-4)
        x = got[f].reshape(n, -1)
        assert bool((x.abs() > 0).any(dim=0).all()), f
    np.testing.assert_array_equal(got["has_pair"].numpy(),
                                  np.asarray(ref["has_pair"]))
    np.testing.assert_array_equal(got["merge_partner"].numpy(),
                                  np.asarray(ref["merge_partner"]))
    assert bool((got["merge_partner"] >= 0).any()) == merge

    col_start = binning.column_start(bt, tcfg).numpy()
    counts = np.diff(col_start)
    assert int(got["overflow"]) == int(ref["overflow"]) == int(
        np.maximum(counts - b, 0).sum())
    g = tcfg.grid_size
    cid = bt.cid.numpy()
    rank = np.arange(n) - col_start[np.minimum(cid // g, g * g - 1)]
    capped = order.numpy()[(cid < tcfg.num_cells) & (rank >= b)]
    if cap == 12:
        assert counts.max() > w_cap and capped.size > 0
    else:
        assert counts.max() <= b and capped.size == 0
    for f in PAIR_FIELDS:
        assert not got[f][capped].any(), f
        assert not np.asarray(ref[f])[capped].any(), f
    assert not (got["merge_partner"][capped] >= 0).any()


def test_column_tank_matches_jax_and_the_resident_kernel(monkeypatch):
    """Three steps of the cut tank through the column family (its plain
    version on the CPU) against JAX op by op, and bit for bit against the
    resident family's plain version: with no column over the cap, the
    capped candidate runs are the uncapped ones."""
    jcfg = jconfig.UNIDYN_CONFIG
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    col = cfg.replace(pallas_kernel="column")
    start = scenes.unidyn_tank(cfg, nf=2000, nb=808, device="cpu")
    assert step.resolve_unidyn_kernel(col, start.capacity) == "column"
    assert binning.suggest_col_cap(start, cfg, headroom=1.0,
                                   minimum=0) == 40     # 36 rounded up
    with jax.disable_jit():
        jst, jm = jstep.run_python(jscenes.unidyn_tank(jcfg, nf=2000, nb=808),
                                   jcfg, 3)
    calls = []
    plain = sph_kernels.unidyn_forces_column_plain
    monkeypatch.setattr(sph_kernels, "unidyn_forces_column_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    tst, tm = step.run_python(start, col, 3)
    assert len(calls) == 3
    _assert_states_close(tst, jst)
    assert int(tm.n_alive) == int(jm.n_alive) == 2808
    assert int(tm.bin_overflow) == int(jm.bin_overflow) == 0
    res, _ = step.run_python(start, cfg, 3)
    for f in ("pos", "vel", "dens", "press", "stress", "solid", "fluid"):
        assert torch.equal(getattr(tst, f), getattr(res, f)), f
