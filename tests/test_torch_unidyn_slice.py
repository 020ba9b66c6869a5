"""The port's unidyn slice against the JAX package: steps of the
reference's tank (cut to 2000 fluid and 808 boundary particles) and of a
merge-enabled mixed-phase blob through tpufluids_torch.step.run_python
on the CPU (the plain force passes) and through
tpufluids.step.run_python (its XLA gather path on the CPU), compared by
particle id.

The tank's JAX run goes op by op (``jax.disable_jit``).  Jitted, XLA
folds ``binning.octant``'s division by the cell size into a
multiplication by float32(1 / cell_size), which sends the tank
lattice's particles on half-cell planes (y = -0.46, the floor at
z = -0.7, ...) to another octant than JAX's division op by op, the
port and the reference's ``int()`` of a quotient do
(tests/test_torch_unidyn.py::test_octant_divides_where_jitted_jax_multiplies;
ROADMAP Queue 3).  The sub-bin stencil of overfull cells then differs.
The random merge blob has no particle on such a plane.

Tolerances are those of tests/test_forces_vs_oracle.py's
test_unidyn_step_matches_oracle: relative 2e-4 (pos), 2e-3 (vel), 1e-4
(dens), 2e-3 (press and stress), 1e-3 (solid and fluid), with atol
1e-5 * max(1, max|ref|).  The alive count and the total mass are equal."""

import dataclasses

import jax
import numpy as np

from tests.test_forces_vs_oracle import mixed_blob
from tpufluids import scenes as jscenes
from tpufluids import step as jstep
from tpufluids.config import UNIDYN_CONFIG
from tpufluids.oracle import state_to_dict
from tpufluids_torch import convert, scenes, sph_kernels, step

TOLS = [("pos", 2e-4), ("vel", 2e-3), ("dens", 1e-4), ("press", 2e-3),
        ("solid", 1e-3), ("fluid", 1e-3), ("stress", 2e-3)]
NF, NB = 2000, 808


def _by_pid(got, ref):
    """The two states as numpy dicts, alive rows ordered by pid."""
    got, ref = convert.state_to_numpy(got), state_to_dict(ref)
    gi = np.argsort(np.where(got["alive"], got["pid"], np.iinfo(np.int32).max))
    ri = np.argsort(np.where(ref["alive"], ref["pid"], np.iinfo(np.int32).max))
    n = int(ref["alive"].sum())
    assert int(got["alive"].sum()) == n
    gi, ri = gi[:n], ri[:n]
    np.testing.assert_array_equal(got["pid"][gi], ref["pid"][ri])
    return ({k: v[gi] for k, v in got.items()},
            {k: v[ri] for k, v in ref.items()})


def _assert_states_close(got, ref):
    got, ref = _by_pid(got, ref)
    for key, rtol in TOLS:
        a = got[key].astype(np.float64)
        b = ref[key].astype(np.float64)
        assert np.isfinite(a).all(), key
        np.testing.assert_allclose(
            a, b, rtol=rtol, atol=1e-5 * max(1.0, np.abs(b).max()),
            err_msg=key)
    np.testing.assert_array_equal(got["mass"], ref["mass"])
    return got


def test_tank_matches_jax_over_ten_steps():
    cfg = convert.config_from_dict(dataclasses.asdict(UNIDYN_CONFIG))
    with jax.disable_jit():
        jst, jm = jstep.run_python(
            jscenes.unidyn_tank(UNIDYN_CONFIG, nf=NF, nb=NB), UNIDYN_CONFIG,
            10)
    sph_kernels.reset_launches()
    start = scenes.unidyn_tank(cfg, nf=NF, nb=NB)
    tst, tm = step.run_python(start, cfg, 10)
    # the resident kernel's plain version ran: no launch on the CPU
    assert step.resolve_unidyn_kernel(cfg, tst.capacity) == "resident"
    assert sph_kernels.launch_counts() == dict.fromkeys(
        sph_kernels.launch_counts(), 0)
    got = _assert_states_close(tst, jst)
    assert int(tm.n_alive) == int(jm.n_alive) == NF + NB
    assert float(tm.total_mass) == float(jm.total_mass) == NF + NB
    assert int(tm.bin_overflow) == int(jm.bin_overflow) == 0
    # the block falls and the step did pressure work
    fluid = ~got["boundary"]
    assert got["pos"][fluid, 2].mean() < float(start.pos[:NF, 2].mean())
    assert np.abs(got["delpress"]).max() > 0.0


def test_tank_reaches_the_25_step_anchors():
    """The anchors of tests/test_trajectories.py:36-53 (CPU golden of the
    JAX package), reached by the port alone."""
    cfg = convert.config_from_dict(dataclasses.asdict(UNIDYN_CONFIG))
    st, m = step.run_python(scenes.unidyn_tank(cfg, nf=NF, nb=NB), cfg, 25)
    d = convert.state_to_numpy(st)
    alive = d["alive"]
    pos, vel = d["pos"][alive], d["vel"][alive]
    assert int(alive.sum()) == int(m.n_alive) == 2808
    assert np.isfinite(pos).all() and np.isfinite(vel).all()
    assert int(m.bin_overflow) == 0
    assert abs(pos[:, 2].mean() - (-0.472181)) < 2e-3
    assert np.linalg.norm(vel, axis=1).max() < 1.0
    assert -0.80 < pos[:, 2].min() < -0.70
    assert -0.40 < pos[:, 2].max() < -0.25
    assert np.abs(pos[:, :2]).max() < 0.99


def test_merging_blob_matches_jax():
    jcfg = UNIDYN_CONFIG.replace(merge_dist=0.03, max_per_cell=64)
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    blob = mixed_blob(150, 7, jcfg, span=0.15)
    jst, tst = blob, convert.state_from_numpy(state_to_dict(blob))
    counts = [150]
    for _ in range(3):
        jst, jm = jstep.run_python(jst, jcfg, 1)
        tst, tm = step.run_python(tst, cfg, 1)
        assert int(tm.n_alive) == int(jm.n_alive)
        assert float(tm.total_mass) == float(jm.total_mass)
        assert int(jm.bin_overflow) == 0
        counts.append(int(tm.n_alive))
    assert counts[1] < counts[0] and counts[3] <= counts[1]
    got = _assert_states_close(tst, jst)
    assert (got["mass"] == jcfg.merge_mass_new).any()


def test_split_reinjection_matches_jax():
    """Split triggers re-inject children into the free slots of the pool
    (the reference's latent host block), up to its capacity.  The first
    step has a free slot for every splitter; in the second the splitters
    outnumber the free slots, and which are served follows the pool
    order, which differs (the XLA path sorts the pool, the port does
    not), so only the counts are compared there."""
    jcfg = UNIDYN_CONFIG.replace(split_reinjection=True, split_mass_min=0.5,
                                 split_dens_max=1e9, max_per_cell=64)
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    blob = mixed_blob(120, 11, jcfg, span=0.2)
    d = {k: np.concatenate([v, np.zeros((130,) + v.shape[1:], v.dtype)])
         for k, v in state_to_dict(blob).items()}
    d["pid"][120:] = -1
    jst = type(blob)(**{k: jax.numpy.asarray(v) for k, v in d.items()})
    tst = convert.state_from_numpy(d)
    jst, jm = jstep.run_python(jst, jcfg, 1)
    tst, tm = step.run_python(tst, cfg, 1)
    assert 120 < int(tm.n_alive) == int(jm.n_alive) < 250
    _assert_states_close(tst, jst)
    jst, jm = jstep.run_python(jst, jcfg, 1)
    tst, tm = step.run_python(tst, cfg, 1)
    assert int(tm.n_alive) == int(jm.n_alive) == 250
    assert int(tm.n_split) == int(jm.n_split) > 0
