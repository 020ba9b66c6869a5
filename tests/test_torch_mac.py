"""The port's MAC grid (tpufluids_torch.grid.mac) against the JAX
package's (tpufluids.grid.mac) on the CPU: its parts on seeded face
arrays, then steps of the CLI's ``plume3d --mac`` scene (cli.py:87-90,
234-246) at 16^3 with the jacobi, multigrid and dct projections.

Tolerances:
- No-flux pinning, the edge padding and the face averages copy or add
  in the reference's order: 1e-6 * max|ref| (XLA may fuse the adds).
- The divergence and one advection, 1e-6 * max|ref|.
- Steps: fields within 1e-5 * max|field|.  The divergence residual,
  max |div u| after the final projection, within 1e-3 relative for the
  Jacobi and multigrid projections; the DCT projection leaves float32
  rounding (about 1e-6), where the two packages are held to that level.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufluids.grid import mac as jmac
from tpufluids.grid import stam as jstam
from tpufluids_torch.grid import convert, kernels
from tpufluids_torch.grid import mac as tmac

TOL = 1e-6
STEP_TOL = 1e-5
RESIDUAL_RTOL = 1e-3


def T(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))


def _faces(seed, n, scale=1.0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, scale, s).astype(np.float32)
            for s in ((n + 1, n, n), (n, n + 1, n), (n, n, n + 1))]


def test_make_mac3d_matches():
    cfg = jstam.StamConfig(n=6, ambient_temp=0.3)
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    got = convert.mac_state_to_numpy(tmac.make_mac3d(tcfg, device="cpu"))
    ref = jmac.make_mac3d(cfg)
    for f in convert.MAC_FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(ref, f)))


def test_mac_state_round_trips_through_numpy():
    n = 5
    u, v, w = _faces(1, n)
    d = {"u": u, "v": v, "w": w, "dens": np.ones((n,) * 3, np.float32),
         "temp": np.zeros((n,) * 3, np.float32)}
    back = convert.mac_state_to_numpy(
        convert.mac_state_from_numpy(d, device="cpu"))
    for f in d:
        np.testing.assert_array_equal(back[f], d[f])
    with pytest.raises(ValueError, match="missing"):
        convert.mac_state_from_numpy({"u": u}, device="cpu")


def test_noflux_divergence_and_averages_match():
    n = 7
    u, v, w = _faces(2, n)
    for g, r in zip(tmac._noflux(T(u), T(v), T(w)),
                    jmac._noflux(jnp.asarray(u), jnp.asarray(v),
                                 jnp.asarray(w))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    _close(tmac.divergence(T(u), T(v), T(w), n),
           jmac.divergence(jnp.asarray(u), jnp.asarray(v), jnp.asarray(w),
                           n))
    J = jnp.asarray
    pairs = [(tmac._avg_to_u(T(v), T(w)), jmac._avg_to_u(J(v), J(w))),
             (tmac._avg_to_v(T(u), T(w)), jmac._avg_to_v(J(u), J(w))),
             (tmac._avg_to_w(T(u), T(v)), jmac._avg_to_w(J(u), J(v))),
             (tmac._avg_to_cell(T(u), T(v), T(w)),
              jmac._avg_to_cell(J(u), J(v), J(w)))]
    for got, ref in pairs:
        for g, r in zip(got, ref):
            _close(g, r)


@pytest.mark.parametrize("which", ["u", "w", "cell"])
def test_advect_stencil_matches(which):
    """Velocities up to 1.5 cells a step, so both clamps are exercised."""
    n = 8
    dt0 = 0.4
    u, v, w = _faces(3, n, scale=1.5 / dt0)
    J = jnp.asarray
    if which == "u":
        q, (ov, ow) = u, jmac._avg_to_u(J(v), J(w))
        vel = (u, np.asarray(ov), np.asarray(ow))
    elif which == "w":
        q, (ou, ov) = w, jmac._avg_to_w(J(u), J(v))
        vel = (np.asarray(ou), np.asarray(ov), w)
    else:
        q = np.random.default_rng(4).uniform(0, 1, (n,) * 3).astype(
            np.float32)
        vel = tuple(np.asarray(a) for a in jmac._avg_to_cell(J(u), J(v),
                                                             J(w)))
    _close(tmac._advect_stencil(T(q), *map(T, vel), dt0),
           jmac._advect_stencil(J(q), *map(J, vel), dt0))


# ---------------------------------------------------------------------------
# the plume3d --mac scene at 16^3: the CLI's defaults (cli.py:190-197)

N = 16


def _plume_mac(projection):
    """(JAX config, port config, seeded state as numpy): dens 1 and temp 3
    in [3k:5k, 3k:5k, 0:k], k = n/8 (cli.py:237-241)."""
    jcfg = jstam.StamConfig(n=N, dt=0.05, diff=1e-5, visc=1e-5,
                            jacobi_iters=20, projection=projection,
                            buoyancy_alpha=0.05, buoyancy_beta=1.0)
    s = jmac.make_mac3d(jcfg)
    k = N // 8
    box = (slice(3 * k, 5 * k), slice(3 * k, 5 * k), slice(0, k))
    s = s.replace(dens=s.dens.at[box].set(1.0), temp=s.temp.at[box].set(3.0))
    return (jcfg, convert.config_from_dict(dataclasses.asdict(jcfg)),
            {f: np.asarray(getattr(s, f)) for f in convert.MAC_FIELDS})


def _hold(tstate, tres, jstate, jres, projection):
    got = convert.mac_state_to_numpy(tstate)
    for f in convert.MAC_FIELDS:
        ref = np.asarray(getattr(jstate, f))
        assert got[f].shape == ref.shape
        assert np.isfinite(got[f]).all()
        np.testing.assert_allclose(got[f], ref, rtol=0,
                                   atol=STEP_TOL * float(np.abs(ref).max()),
                                   err_msg=f)
    tres, jres = tres.numpy(), np.asarray(jres)
    assert tres.shape == jres.shape
    if projection == "dct":
        assert tres.max() < 1e-5 and jres.max() < 1e-5
    else:
        np.testing.assert_allclose(tres, jres, rtol=RESIDUAL_RTOL)
    assert float(np.abs(got["w"]).max()) > 1e-3


@pytest.mark.parametrize("projection", ["jacobi", "multigrid", "dct"])
def test_plume_mac_run3d_python_matches_jax(projection):
    """Against JAX's run3d, which equals its run3d_python bit for bit
    (state and last residual) and compiles once."""
    jcfg, tcfg, seed = _plume_mac(projection)
    jstate, jres = jmac.run3d(jmac.MacState3D(**{
        f: jnp.asarray(a) for f, a in seed.items()}), jcfg, 3)
    jres = jres[-1:]
    kernels.reset_launches()
    tstate, tres = tmac.run3d_python(
        convert.mac_state_from_numpy(seed, device="cpu"), tcfg, 3)
    assert set(kernels.launch_counts().values()) == {0}
    _hold(tstate, tres, jstate, jres, projection)


def test_plume_mac_step3d_and_run3d_match_jax():
    """step3d with sources, then run3d's residual of every step."""
    projection = "jacobi"
    jcfg, tcfg, seed = _plume_mac(projection)
    src = np.zeros((N,) * 3, np.float32)
    src[6:10, 6:10, 0:2] = 2.0
    jstate = jmac.MacState3D(**{f: jnp.asarray(a) for f, a in seed.items()})
    # jitted: op by op it takes seconds
    jstate = jax.jit(jmac.step3d, static_argnums=1)(
        jstate, jcfg, {"dens": jnp.asarray(src), "temp": jnp.asarray(src)})
    jstate, jres = jmac.run3d(jstate, jcfg, 2)
    tstate = tmac.step3d(convert.mac_state_from_numpy(seed, device="cpu"),
                         tcfg, {"dens": T(src), "temp": T(src)})
    tstate, tres = tmac.run3d(tstate, tcfg, 2)
    assert tres.shape == (2,)
    _hold(tstate, tres, jstate, jres, projection)
