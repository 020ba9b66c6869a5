"""The port's SPH base slice against the JAX package: 10 steps of the
reference's base_dam scene (8000 particles) through
tpufluids_torch.step.run_python on the CPU (the plain force version)
and through tpufluids.step.run_python (its XLA gather path on the CPU),
compared by particle id.

Tolerances are those of tests/test_forces_vs_oracle.py for multi-step
runs: relative 2e-4 (pos), 2e-3 (vel), 1e-4 (dens), 2e-3 (press and
acc), with atol 1e-5 * max(1, max|ref|).  The alive count and the total
mass are equal."""

import dataclasses

import numpy as np
import torch

from tpufluids import scenes as jscenes
from tpufluids import step as jstep
from tpufluids.config import BASE_CONFIG
from tpufluids.oracle import state_to_dict
from tpufluids_torch import convert, scenes, step

STEPS = 10
TOLS = [("pos", 2e-4), ("vel", 2e-3), ("dens", 1e-4), ("press", 2e-3),
        ("acc", 2e-3)]


def test_base_dam_matches_jax_over_ten_steps():
    cfg = convert.config_from_dict(dataclasses.asdict(BASE_CONFIG))
    jst, jm = jstep.run_python(jscenes.base_dam(BASE_CONFIG), BASE_CONFIG,
                               STEPS)
    tst, tm = step.run_python(scenes.base_dam(cfg, device="cpu"), cfg,
                               STEPS)
    got, ref = convert.state_to_numpy(tst), state_to_dict(jst)
    gi, ri = np.argsort(got["pid"]), np.argsort(ref["pid"])
    np.testing.assert_array_equal(got["pid"][gi], ref["pid"][ri])
    for key, rtol in TOLS:
        a = got[key][gi].astype(np.float64)
        b = ref[key][ri].astype(np.float64)
        assert np.isfinite(a).all(), key
        np.testing.assert_allclose(
            a, b, rtol=rtol, atol=1e-5 * max(1.0, np.abs(b).max()),
            err_msg=key)
    assert int(tm.n_alive) == int(jm.n_alive) == 8000
    assert float(tm.total_mass) == float(jm.total_mass) == 8000.0
    assert int(tm.bin_overflow) == int(jm.bin_overflow) == 0
    # the column falls and the step did pressure work
    assert got["pos"][:, 2].min() < -0.2
    assert float(tm.dens_residual) > 0.0
    assert np.abs(got["delpress"]).max() > 0.0
    assert isinstance(tm.max_speed, torch.Tensor)
