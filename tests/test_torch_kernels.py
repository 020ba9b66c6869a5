"""The plain PyTorch version of each CUDA kernel of the port against the
JAX package's Pallas kernel (run in interpret mode with tx=4, as
tests/test_pallas_kernels.py runs it) and against the JAX dense
composition it replaces, on the CPU.

Inputs have set_bnd-consistent ghosts: the Pallas kernels rebuild the
z ghosts from that invariant, while the port reads stored ghosts.
Tolerances, as atol relative to max|reference|: 3e-6 for advection and
forcing (the Pallas advection folds the z-edge taps with one rounding
more, tests/test_pallas_kernels.py), 1e-6 for divergence and gradient
subtraction.

The CUDA kernels themselves run only on a card: tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpufluids.grid import pallas_kernels as pk
from tpufluids.grid import stam as jstam
from tpufluids_torch.grid import kernels
from tpufluids_torch.grid import stam as tstam

ADVECT_TOL = FORCING_TOL = 3e-6
DIV_TOL = GRADSUB_TOL = 1e-6


def _consistent(seed, n, bnds, lo=-1.0, hi=1.0):
    """Uniform fields on (n+2)^3 with set_bnd3d(b) applied, as numpy."""
    rng = np.random.default_rng(seed)
    return [np.asarray(jstam.set_bnd3d(b, jnp.asarray(
        rng.uniform(lo, hi, (n + 2,) * 3), jnp.float32))) for b in bnds]


def _close(got, ref, tol):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))


def T(a):
    return torch.from_numpy(np.array(a))


def test_advect_plain_matches_pallas_and_dense():
    n, dt = 14, 0.03
    # up to 1.2 cells per step: the one-cell clamp is exercised
    u, v, w = (a / (dt * n) for a in _consistent(5, n, (1, 2, 3), -1.2, 1.2))
    d, t = _consistent(6, n, (0, 0), 0.0, 1.0)
    cfg = jstam.StamConfig(n=n, dt=dt)
    dt0 = float(dt * n)
    tu, tv, tw = T(u), T(v), T(w)
    got_uvw = kernels.advect3d_multi_plain((tu, tv, tw), (1, 2, 3),
                                           tu, tv, tw, dt0)
    got_dt = kernels.advect3d_multi_plain((T(d), T(t)), (0, 0),
                                          tu, tv, tw, dt0)
    ju, jv, jw = map(jnp.asarray, (u, v, w))
    with pltpu.force_tpu_interpret_mode():
        pal_uvw = pk.advect3d_multi_pallas((ju, jv, jw), (1, 2, 3), ju, jv,
                                           jw, dt0, tx=4, self_advect=True)
        pal_dt = pk.advect3d_multi_pallas((jnp.asarray(d), jnp.asarray(t)),
                                          (0, 0), ju, jv, jw, dt0, tx=4)
    dense = [jstam.advect3d_stencil(b, jnp.asarray(q), ju, jv, jw, cfg)
             for b, q in ((1, u), (2, v), (3, w), (0, d), (0, t))]
    for got, pal, ref in zip(got_uvw + got_dt, pal_uvw + pal_dt, dense):
        _close(got, pal, ADVECT_TOL)
        _close(got, ref, ADVECT_TOL)


@pytest.mark.parametrize("coeffs", [
    dict(vorticity_eps=3.0, buoyancy_alpha=0.05, buoyancy_beta=1.0),
    dict(buoyancy_alpha=0.05, buoyancy_beta=1.0),
    dict(vorticity_eps=3.0),
], ids=["both", "buoyancy", "vorticity"])
def test_forcing_plain_matches_pallas_and_dense(coeffs):
    n = 12
    kw = dict(n=n, dt=0.02, ambient_temp=0.2, **coeffs)
    u, v, w = _consistent(6, n, (1, 2, 3), -0.6, 0.6)
    d, t = _consistent(7, n, (0, 0), 0.0, 1.0)
    tcfg, jcfg = tstam.StamConfig(**kw), jstam.StamConfig(**kw)
    got = kernels.forcing3d_plain(T(u), T(v), T(w), T(d), T(t), tcfg)
    ju, jv, jw, jd, jt = map(jnp.asarray, (u, v, w, d, t))
    if jcfg.buoyancy_alpha or jcfg.buoyancy_beta:
        jw = jstam.buoyancy3d(jw, jd, jt, jcfg)
    if jcfg.vorticity_eps:
        ju, jv, jw = jstam.vorticity_confinement3d(ju, jv, jw, jcfg)
    for g, r in zip(got, (ju, jv, jw)):
        _close(g, r, FORCING_TOL)
    if len(coeffs) < 3:
        return      # the Pallas kernel is checked once, on the full case
    with pltpu.force_tpu_interpret_mode():
        pal = pk.forcing3d_pallas(*map(jnp.asarray, (u, v, w, d, t)),
                                  jcfg.dt, 1.0 / n, jcfg.vorticity_eps,
                                  jcfg.buoyancy_alpha, jcfg.buoyancy_beta,
                                  jcfg.ambient_temp, tx=4)
    for g, r in zip(got, pal):
        _close(g, r, FORCING_TOL)


def test_div_and_gradsub_plain_match_pallas_and_dense():
    n = 16
    u, v, w, p = _consistent(4, n, (1, 2, 3, 0))
    ju, jv, jw, jp = map(jnp.asarray, (u, v, w, p))
    div = kernels.div3d_plain(T(u), T(v), T(w))
    sub = kernels.gradsub3d_plain(T(p), T(u), T(v), T(w))
    with pltpu.force_tpu_interpret_mode():
        pal_div = pk.div3d_pallas(ju, jv, jw, tx=4)
        pal_sub = pk.gradsub3d_pallas(jp, ju, jv, jw, tx=4)
    dense_div = jstam.set_bnd3d(0, jnp.zeros_like(ju).at[1:-1, 1:-1, 1:-1]
                                .set(jstam.divergence3d(ju, jv, jw)))
    _close(div, pal_div, DIV_TOL)
    _close(div, dense_div, DIV_TOL)
    h = 1.0 / n
    dense_sub = [
        jstam.set_bnd3d(1, ju.at[1:-1, 1:-1, 1:-1].add(
            -0.5 * (jp[2:, 1:-1, 1:-1] - jp[:-2, 1:-1, 1:-1]) / h)),
        jstam.set_bnd3d(2, jv.at[1:-1, 1:-1, 1:-1].add(
            -0.5 * (jp[1:-1, 2:, 1:-1] - jp[1:-1, :-2, 1:-1]) / h)),
        jstam.set_bnd3d(3, jw.at[1:-1, 1:-1, 1:-1].add(
            -0.5 * (jp[1:-1, 1:-1, 2:] - jp[1:-1, 1:-1, :-2]) / h)),
    ]
    for got, pal, ref in zip(sub, pal_sub, dense_sub):
        _close(got, pal, GRADSUB_TOL)
        _close(got, ref, GRADSUB_TOL)


def test_wrappers_run_the_plain_version_on_cpu_without_counting():
    n = 6
    u, v, w, p = map(T, _consistent(8, n, (1, 2, 3, 0)))
    d, t = map(T, _consistent(9, n, (0, 0), 0.0, 1.0))
    cfg = tstam.StamConfig(n=n, dt=0.05, vorticity_eps=2.0,
                           buoyancy_beta=0.5)
    kernels.reset_launches()
    pairs = [
        (kernels.advect3d_multi((d, t), (0, 0), u, v, w, 0.3),
         kernels.advect3d_multi_plain((d, t), (0, 0), u, v, w, 0.3)),
        (kernels.forcing3d(u, v, w, d, t, cfg),
         kernels.forcing3d_plain(u, v, w, d, t, cfg)),
        ((kernels.div3d(u, v, w),), (kernels.div3d_plain(u, v, w),)),
        (kernels.gradsub3d(p, u, v, w), kernels.gradsub3d_plain(p, u, v, w)),
    ]
    for got, want in pairs:
        for g, r in zip(got, want):
            assert torch.equal(g, r)
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("bad", ["float64", "strided", "shape", "noncubic",
                                 "meta"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    u, v, w = map(T, _consistent(10, 6, (1, 2, 3)))
    if bad == "float64":
        w, err = w.double(), TypeError
    elif bad == "strided":
        w, err = w.transpose(0, 2), ValueError
    elif bad == "shape":
        w, err = w[:-1, :-1, :-1].contiguous(), ValueError
    elif bad == "noncubic":
        u, v, w = (q[:, :, :-1].contiguous() for q in (u, v, w))
        err = ValueError
    else:
        u, v, w = (torch.empty_like(q, device="meta") for q in (u, v, w))
        err = ValueError
    with pytest.raises(err):
        kernels.div3d(u, v, w)
    with pytest.raises(err):
        kernels.advect3d_multi((u,), (1,), u, v, w, 0.3)


def test_advect_wrapper_rejects_bad_field_lists():
    u, v, w = map(T, _consistent(11, 6, (1, 2, 3)))
    with pytest.raises(ValueError):
        kernels.advect3d_multi((u, v, w, u), (1, 2, 3, 1), u, v, w, 0.3)
    with pytest.raises(ValueError):
        kernels.advect3d_multi((u,), (4,), u, v, w, 0.3)
    with pytest.raises(ValueError):
        kernels.advect3d_multi((u, v), (1,), u, v, w, 0.3)
