"""The port's multigrid projection and run3d against the JAX package on
the CPU: the V-cycle's parts, mg_solve3d at 16^3 and 32^3 (the JAX dense
path, float32 at every level), the bfloat16 cycle at 48^3 (JAX's Pallas
solves in interpret mode, on a set_bnd-consistent right-hand side), and
four steps of the config 3 scene with ``projection="multigrid"``.

Tolerances:
- The prolongation only copies: bit for bit.  The residual and the
  restriction, 1e-6 * max|ref|: the restriction's mean over 2x2x2
  blocks sums in another order in XLA and in torch.
- mg_solve3d, 1e-5 * max|p|: a cycle carries those orders through its
  levels.  The bfloat16 cycle at 48^3 differs from the float32 one by
  about 1.6e-2 * max|p|, so the bound tells the two routes apart.
- Steps: fields within 1e-5 * max|field|, residuals within 1e-3
  relative, as tests/test_torch_jacobi.py holds whole steps.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpufluids.grid import stam as jstam
from tpufluids_torch.grid import convert, kernels
from tpufluids_torch.grid import stam as tstam

TOL = 1e-6
MG_TOL = 1e-5
STEP_TOL = 1e-5
RESIDUAL_RTOL = 1e-3


def T(a):
    return torch.from_numpy(np.array(a))


def _rhs(seed, n):
    """A set_bnd-consistent right-hand side, as kernels.div3d leaves
    it."""
    x = np.random.default_rng(seed).normal(0, 1, (n + 2,) * 3)
    return np.asarray(jstam.set_bnd3d(0, jnp.asarray(x.astype(np.float32))))


def _close(got, ref, tol):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))


def test_vcycle_parts_match_jax():
    n = 12
    p, x0 = _rhs(1, n), _rhs(2, n)
    r = jstam._mg_residual3d(jnp.asarray(p), jnp.asarray(x0))
    _close(tstam._mg_residual3d(T(p), T(x0)), r, TOL)
    _close(tstam._mg_restrict3d(T(np.asarray(r))),
           jstam._mg_restrict3d(r), TOL)
    e = _rhs(3, n // 2)
    np.testing.assert_array_equal(tstam._mg_prolong3d(T(e)).numpy(),
                                  np.asarray(jstam._mg_prolong3d(
                                      jnp.asarray(e))))


@pytest.mark.parametrize("cycles", [1, 2])
@pytest.mark.parametrize("n", [16, 32])
def test_mg_solve3d_matches_jax(n, cycles):
    x0 = _rhs(10 + n, n)
    kw = dict(n=n, projection="multigrid")
    ref = jstam.mg_solve3d(jnp.asarray(x0),
                           jstam.StamConfig(solver_backend="xla", **kw),
                           cycles)
    got = tstam.mg_solve3d(T(x0), tstam.StamConfig(**kw), cycles)
    _close(got, ref, MG_TOL)
    # a cycle cuts the residual: the solve did work
    r0 = float(np.abs(x0[1:-1, 1:-1, 1:-1]).max())
    r = float(tstam._mg_residual3d(got, T(x0)).abs().max())
    assert r < 0.5 * r0


def test_bf16_cycle_at_48_matches_jax_pallas():
    """At n >= 48 the smoothing runs in bfloat16; below, in float32."""
    n = 48
    x0 = _rhs(5, n)
    kw = dict(n=n, projection="multigrid")
    jcfg = jstam.StamConfig(solver_backend="pallas", solver_dtype="bfloat16",
                            **kw)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jstam.mg_solve3d(jnp.asarray(x0), jcfg, 1))
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    got = tstam.mg_solve3d(T(x0), tcfg, 1)
    _close(got, ref, MG_TOL)
    f32 = tstam.mg_solve3d(T(x0), tcfg.replace(solver_dtype="float32"), 1)
    assert float((got - f32).abs().max()) > 1e-3 * float(f32.abs().max())


def test_levels_below_48_solve_in_float32():
    """A bfloat16 multigrid at 32^3 never reaches the bfloat16 solve."""
    n = 32
    x0 = T(_rhs(6, n))
    cfg = tstam.StamConfig(n=n, projection="multigrid")
    assert torch.equal(tstam.mg_solve3d(x0, cfg),
                       tstam.mg_solve3d(x0, cfg.replace(
                           solver_dtype="bfloat16")))


@pytest.mark.parametrize("with_residual", [False, True])
def test_multigrid_projection_matches_jax(with_residual):
    n = 16
    u, v, w = (np.asarray(jstam.set_bnd3d(b, jnp.asarray(_rhs(20 + b, n))))
               for b in (1, 2, 3))
    kw = dict(n=n, projection="multigrid", mg_cycles=2)
    got = tstam.project3d(T(u), T(v), T(w), tstam.StamConfig(**kw),
                          with_residual=with_residual)
    ref = jstam.project3d(jnp.asarray(u), jnp.asarray(v), jnp.asarray(w),
                          jstam.StamConfig(solver_backend="xla", **kw),
                          with_residual=with_residual)
    for g, r in zip(got[:3], ref[:3]):
        _close(g, r, STEP_TOL)
    if with_residual:
        np.testing.assert_allclose(float(got[3]), float(ref[3]),
                                   rtol=RESIDUAL_RTOL)


# ---------------------------------------------------------------------------
# the slice: the config 3 scene (bench.py:138-156, 214-233) with the
# multigrid projection (cli.py:72-84), four steps at 16^3

N, STEPS = 16, 4
CONFIG3_MG = dict(n=N, dt=0.5 / N, jacobi_iters=20, red_black=True,
                  vorticity_eps=2.0, buoyancy_alpha=0.05, buoyancy_beta=0.5,
                  advect_mode="stencil", projection="multigrid", mg_cycles=2)


def _seed(jcfg):
    s = jstam.make_grid3d(jcfg)
    k = N // 8
    box = (slice(3 * k, 5 * k), slice(3 * k, 5 * k), slice(1, k))
    s = s.replace(dens=s.dens.at[box].set(1.0), temp=s.temp.at[box].set(3.0))
    return {f: np.asarray(getattr(s, f)) for f in convert.FIELDS}


@functools.lru_cache(maxsize=None)
def _config3_multigrid_jax():
    """(JAX config, seed, JAX state and residual of every step).  JAX's
    run3d equals its run3d_python bit for bit, state and last residual,
    and compiles once; both of the port's runners are held to it."""
    jcfg = jstam.StamConfig(solver_backend="xla", **CONFIG3_MG)
    seed = _seed(jcfg)
    jstate = jstam.GridState3D(**{f: jnp.asarray(a) for f, a in seed.items()})
    jstate, jres = jstam.run3d(jstate, jcfg, STEPS)
    return jcfg, seed, jstate, np.asarray(jres)


@pytest.mark.parametrize("runner", ["run3d_python", "run3d"])
def test_config3_multigrid_steps_match_jax(runner):
    jcfg, seed, jstate, jres = _config3_multigrid_jax()
    if runner == "run3d_python":
        jres = jres[-1:]
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    kernels.reset_launches()
    tstate, tres = getattr(tstam, runner)(
        convert.state_from_numpy(seed, device="cpu"), tcfg, STEPS)
    assert set(kernels.launch_counts().values()) == {0}
    got = convert.state_to_numpy(tstate)
    for f in convert.FIELDS:
        ref = np.asarray(getattr(jstate, f))
        assert np.isfinite(got[f]).all()
        np.testing.assert_allclose(got[f], ref, rtol=0,
                                   atol=STEP_TOL * float(np.abs(ref).max()),
                                   err_msg=f)
    # run3d reports every step's residual, run3d_python the last one
    assert tres.shape == jres.shape == ((STEPS,) if runner == "run3d"
                                        else (1,))
    np.testing.assert_allclose(tres.numpy(), np.asarray(jres),
                               rtol=RESIDUAL_RTOL)
    # two V-cycles leave a residual well below twenty red-black sweeps'
    assert 0.0 < float(tres[-1]) < 1e-5
    assert float(np.abs(got["w"]).max()) > 1e-3
