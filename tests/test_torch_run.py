"""The port's SPH drivers (``step.run``, ``run_chunk``, ``run_python``)
and ``ParticleState.num_alive`` against each other and against the JAX
package's, on the CPU.

``run``, ``run_chunk`` and ``run_python`` run the same steps, so their
final states agree bit for bit.  The snapshot cadence of ``run``'s XLA
pair branch (``force_backend="xla"``) is the JAX package's scan
branch's, the last partial chunk included; on the kernels it is the
multiples of ``snapshot_every``.  A small base dam through ``run`` stays
within the SPH slice tolerances of the JAX ``run`` (those of
tests/test_torch_sph_slice.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from tpufluids import scenes as jscenes
from tpufluids import step as jstep
from tpufluids.config import BASE_CONFIG as JBASE
from tpufluids.oracle import state_to_dict
from tpufluids_torch import convert, scenes, step
from tpufluids_torch.config import BASE_CONFIG, UNIDYN_CONFIG
from tpufluids_torch.state import FIELDS

TOLS = [("pos", 2e-4), ("vel", 2e-3), ("dens", 1e-4), ("press", 2e-3),
        ("acc", 2e-3)]
STEPS = 6

CASES = {
    "base": (BASE_CONFIG.replace(max_per_cell=32), "blob"),
    "base, sort_every 4": (BASE_CONFIG.replace(max_per_cell=32,
                                               sort_every=4), "blob"),
    "base, xla": (BASE_CONFIG.replace(max_per_cell=32,
                                      force_backend="xla"), "blob"),
    "unidyn": (UNIDYN_CONFIG, "tank"),
}


def _scene(kind, cfg):
    if kind == "blob":
        return scenes.random_blob(80, seed=1, span=0.12, cfg=cfg,
                                  device="cpu")
    return scenes.unidyn_tank(cfg, nf=300, nb=120, device="cpu")


def _equal(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS)


@pytest.mark.parametrize("case", list(CASES))
def test_run_run_chunk_and_run_python_agree_bit_for_bit(case):
    cfg, kind = CASES[case]
    st = _scene(kind, cfg)
    ref, last = step.run_python(st, cfg, STEPS)
    got, metrics = step.run(st, cfg, STEPS)
    assert _equal(got, ref)
    for name, m in metrics._asdict().items():
        assert m.shape == (STEPS,), name
        assert torch.equal(m[-1], getattr(last, name)), name
    if cfg.sort_every > 1:   # run_chunk is the scan: no sort cadence
        with pytest.raises(ValueError):
            step.run(st, cfg.replace(force_backend="xla"), STEPS)
        return
    chunk, cm = step.run_chunk(st, cfg, STEPS)
    assert _equal(chunk, ref)
    for name, m in cm._asdict().items():
        assert torch.equal(m, getattr(metrics, name)), name


def _steps_of(run, state, cfg, n, every):
    seen = []
    run(state, cfg, n, snapshot_every=every,
        snapshot_fn=lambda i, host: seen.append((i, host)))
    return seen


def test_snapshot_steps_follow_the_jax_package():
    """n = 12, every 5: the JAX scan branch (force_backend "xla") hands
    over steps 5, 10 and 12, the port's XLA branch too; the port's
    kernel branch 5 and 10, each state on the CPU."""
    jcfg = JBASE.replace(max_per_cell=32, force_backend="xla")
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    jseen = _steps_of(jstep.run, jscenes.random_blob(40, seed=3, span=0.12),
                      jcfg, 12, 5)
    st = scenes.random_blob(40, seed=3, span=0.12, device="cpu")
    xla = _steps_of(step.run, st, cfg, 12, 5)
    kern = _steps_of(step.run, st, cfg.replace(force_backend="auto"), 12, 5)
    assert [i for i, _ in jseen] == [i for i, _ in xla] == [5, 10, 12]
    assert [i for i, _ in kern] == [5, 10]
    for _, host in xla + kern:
        assert all(getattr(host, f).device.type == "cpu" for f in FIELDS)
    # the XLA branch's snapshots are the JAX package's states
    for (_, j), (_, t) in zip(jseen, xla):
        ref, got = state_to_dict(j), convert.state_to_numpy(t)
        np.testing.assert_array_equal(got["pid"], ref["pid"])
        np.testing.assert_allclose(got["pos"], ref["pos"], rtol=2e-4,
                                   atol=1e-5)


def test_run_small_base_dam_matches_jax_run():
    n, steps = 500, 10
    cfg = convert.config_from_dict(dataclasses.asdict(JBASE))
    jst, jm = jstep.run(jscenes.base_dam(JBASE, n=n), JBASE, steps)
    tst, tm = step.run(scenes.base_dam(cfg, n=n, device="cpu"), cfg, steps)
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
    for name in ("n_alive", "total_mass", "bin_overflow"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)), name)
    np.testing.assert_allclose(tm.max_speed.numpy(),
                               np.asarray(jm.max_speed), rtol=2e-3)


def test_num_alive_matches_jax():
    js = jscenes.random_blob(30, seed=5, capacity=41)
    d = {k: np.array(v) for k, v in state_to_dict(js).items()}
    d["alive"][[0, 7, 12]] = False
    ts = convert.state_from_numpy(d, device="cpu")
    got = ts.num_alive()
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(js.replace(alive=d["alive"]).num_alive()) == 27


def test_package_exports_match_jax():
    import dataclasses as dc

    import tpufluids
    import tpufluids_torch
    assert tpufluids_torch.__version__ == tpufluids.__version__
    assert dc.asdict(tpufluids_torch.BASE_CONFIG) == dc.asdict(
        tpufluids.BASE_CONFIG)
    assert dc.asdict(tpufluids_torch.UNIDYN_CONFIG) == dc.asdict(
        tpufluids.UNIDYN_CONFIG)
    assert [f.name for f in dc.fields(tpufluids_torch.SPHConfig)] == [
        f.name for f in dc.fields(tpufluids.SPHConfig)]
    assert [f.name for f in dc.fields(tpufluids_torch.ParticleState)] == [
        f.name for f in dc.fields(tpufluids.ParticleState)]
