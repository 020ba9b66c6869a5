"""The port's main path against the JAX package: 4 steps of the bench.py
configuration at 16^3 through tpufluids_torch.grid.stam.run3d_python on
the CPU, against tpufluids.grid.stam.run3d_python on its dense XLA path
(solver_backend="xla"), from the same seeded state.

The port keeps the dense ghosted layout and reads stored ghosts, so it
reproduces the dense path, whose ghost planes the bench seeding leaves
at 0 next to a seeded z=1 plane.  Fields agree to atol 1e-5 *
max|field| (float32 rounding through four steps of two DCT solves
each), and both final Poisson residuals are <= 1e-8."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from tpufluids.grid import stam as jstam
from tpufluids_torch.grid import convert
from tpufluids_torch.grid import stam as tstam

N, STEPS, TOL = 16, 4, 1e-5


def _bench_config(**kw):
    """bench.py's headline configuration at size N."""
    return jstam.StamConfig(n=N, dt=0.5 / N, jacobi_iters=20,
                            red_black=True, vorticity_eps=2.0,
                            buoyancy_beta=0.5, buoyancy_alpha=0.05,
                            advect_mode="stencil", projection="dct",
                            dct_precision_first="default",
                            solver_backend="xla", **kw)


def _bench_seed(cfg):
    """bench.py's seeded(): dens 1 and temp 3 in a block on the z=1
    plane."""
    s = jstam.make_grid3d(cfg)
    k = cfg.n // 8
    s = s.replace(dens=s.dens.at[3 * k:5 * k, 3 * k:5 * k, 1:k].set(1.0),
                  temp=s.temp.at[3 * k:5 * k, 3 * k:5 * k, 1:k].set(3.0))
    return {f: np.asarray(getattr(s, f)) for f in convert.FIELDS}


@pytest.mark.parametrize("kw", [{}, dict(dct_radix_min=16)],
                         ids=["bench", "radix16"])
def test_port_matches_jax_over_four_bench_steps(kw):
    jcfg = _bench_config(**kw)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    seed = _bench_seed(jcfg)
    jstate = jstam.GridState3D(**{f: jnp.asarray(a) for f, a in seed.items()})
    jstate, jres = jstam.run3d_python(jstate, jcfg, STEPS)
    tstate, tres = tstam.run3d_python(
        convert.state_from_numpy(seed, device="cpu"), tcfg, STEPS)
    got = convert.state_to_numpy(tstate)
    for f in convert.FIELDS:
        ref = np.asarray(getattr(jstate, f))
        assert got[f].shape == ref.shape == (N + 2,) * 3
        assert np.isfinite(got[f]).all()
        np.testing.assert_allclose(got[f], ref, rtol=0,
                                   atol=TOL * float(np.abs(ref).max()),
                                   err_msg=f)
    assert tres.shape == (1,) and jres.shape == (1,)
    assert float(tres[0]) <= 1e-8 and float(jres[0]) <= 1e-8
    # the plume has started to move: the step did real work
    assert float(np.abs(got["w"]).max()) > 1e-3


def test_state_round_trips_through_numpy():
    seed = _bench_seed(_bench_config())
    back = convert.state_to_numpy(convert.state_from_numpy(seed, device="cpu"))
    for f in convert.FIELDS:
        np.testing.assert_array_equal(back[f], seed[f])
    with pytest.raises(ValueError, match="temp"):
        convert.state_from_numpy({f: a for f, a in seed.items()
                                  if f != "temp"}, device="cpu")
