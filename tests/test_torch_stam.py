"""Each function of the port's 3D step against its JAX counterpart
(tpufluids.grid.stam) on the same seeded float32 inputs, on the CPU.

Tolerance: atol = 1e-6 * max|reference| (rtol 0).  The two packages
sum in different orders and use different BLAS, so results agree to
float32 rounding, not bit for bit; set_bnd3d only copies and negates,
so it must agree exactly.  The DCT solve is the exception: its small
eigenvalues (about 0.04 at n = 16) amplify float32 rounding, and each
package lands about 1.5e-6 * max|p| from a float64 solve, in different
directions.  So the solve and the projection are held to 3e-6 of a
float64 solve each and to DCT_TOL = 5e-6 of each other."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufluids.grid import stam as jstam
from tpufluids_torch.grid import kernels as tkernels
from tpufluids_torch.grid import stam as tstam

TOL = 1e-6
DCT_TOL = 5e-6


def _fields(seed, n, count, scale=1.0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, scale, (n + 2,) * 3).astype(np.float32)
            for _ in range(count)]


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))


J = jnp.asarray


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("b", [0, 1, 2, 3])
def test_set_bnd3d_matches(b):
    (x,) = _fields(0, 12, 1)
    np.testing.assert_array_equal(tstam.set_bnd3d(b, T(x)).numpy(),
                                  np.asarray(jstam.set_bnd3d(b, J(x))))


def test_set_bnd3d_closed_form():
    """A ghost cell is the product of the signs of its out-of-range axes
    times the value at the clamped interior index (what the CUDA kernels
    compute), for every b."""
    n = 5
    (x,) = _fields(1, n, 1)
    idx = np.clip(np.arange(n + 2), 1, n)
    out = np.arange(n + 2) != idx
    for b in range(4):
        sign = np.ones((n + 2,) * 3, np.float32)
        for a in range(3):
            if b == a + 1:
                flip = out.reshape([-1 if c == a else 1 for c in range(3)])
                sign = np.where(flip, -sign, sign)
        want = sign * x[np.ix_(idx, idx, idx)]
        np.testing.assert_array_equal(tstam.set_bnd3d(b, T(x)).numpy(), want)


def test_divergence_and_poisson_residual_match():
    u, v, w, p, d = _fields(2, 12, 5)
    _close(tstam.divergence3d(T(u), T(v), T(w)),
           jstam.divergence3d(J(u), J(v), J(w)))
    _close(tstam.poisson_residual3d(T(p), T(d)),
           jstam.poisson_residual3d(J(p), J(d)))


def test_buoyancy_and_vorticity_confinement_match():
    u, v, w = _fields(3, 12, 3, scale=0.4)
    d, t = (np.abs(f) for f in _fields(4, 12, 2))
    kw = dict(n=12, dt=0.02, vorticity_eps=3.0, buoyancy_alpha=0.05,
              buoyancy_beta=1.0, ambient_temp=0.2)
    tcfg, jcfg = tstam.StamConfig(**kw), jstam.StamConfig(**kw)
    _close(tstam.buoyancy3d(T(w), T(d), T(t), tcfg),
           jstam.buoyancy3d(J(w), J(d), J(t), jcfg))
    for got, ref in zip(tstam.vorticity_confinement3d(T(u), T(v), T(w), tcfg),
                        jstam.vorticity_confinement3d(J(u), J(v), J(w),
                                                      jcfg)):
        _close(got, ref)


@pytest.mark.parametrize("b", [0, 1, 2, 3])
def test_advect3d_stencil_matches(b):
    # velocities up to 1.5 cells per step, so both clamps are exercised
    rng = np.random.default_rng(5)
    n = 12
    shape = (n + 2,) * 3
    u, v, w = (rng.uniform(-1.5, 1.5, shape).astype(np.float32) / (0.03 * n)
               for _ in range(3))
    q = rng.uniform(0, 1, shape).astype(np.float32)
    kw = dict(n=n, dt=0.03, advect_mode="stencil")
    _close(tstam.advect3d_stencil(b, T(q), T(u), T(v), T(w),
                                  tstam.StamConfig(**kw)),
           jstam.advect3d_stencil(b, J(q), J(u), J(v), J(w),
                                  jstam.StamConfig(**kw)))


@pytest.mark.parametrize("kw", [
    dict(dct_radix_min=0),
    dict(dct_radix_min=16, dct_radix_levels=1),
    dict(dct_radix_min=16, dct_radix_levels=2),
    dict(dct_precision="default"),
], ids=["direct", "radix1", "radix2", "default-tier"])
def test_dct_solve3d_matches(kw):
    (x,) = _fields(6, 16, 1)
    x = np.asarray(jstam.set_bnd3d(0, J(x)))
    kw = dict(n=16, projection="dct", **kw)
    got = tstam.dct_solve3d(T(x), tstam.StamConfig(**kw)).numpy()
    ref = np.asarray(jstam.dct_solve3d(J(x), jstam.StamConfig(**kw)))
    _close(got, ref, DCT_TOL)
    exact = _dct_solve_float64(x)
    for p in (got, ref):
        np.testing.assert_allclose(p[1:-1, 1:-1, 1:-1], exact, rtol=0,
                                   atol=3e-6 * np.abs(exact).max())


def _dct_solve_float64(x):
    """The interior of the Neumann-Poisson solve, direct DCT in float64."""
    n = x.shape[0] - 2
    i = np.arange(n, dtype=np.float64)
    C = np.cos(np.pi / n * i[:, None] * (i[None, :] + 0.5))
    Ci = C.T * (np.where(i == 0, 1.0, 2.0) / n)
    lam1 = 2.0 - 2.0 * np.cos(np.pi * i / n)
    a = x[1:-1, 1:-1, 1:-1].astype(np.float64)
    for ax in range(3):
        a = np.moveaxis(np.tensordot(C, a, axes=([1], [ax])), 0, ax)
    lam = lam1[:, None, None] + lam1[None, :, None] + lam1[None, None, :]
    a = a / np.where(lam == 0.0, 1.0, lam)
    a[0, 0, 0] = 0.0
    for ax in range(3):
        a = np.moveaxis(np.tensordot(Ci, a, axes=([1], [ax])), 0, ax)
    return a


@pytest.mark.parametrize("final", [True, False])
def test_project3d_dct_matches(final):
    u, v, w = (np.asarray(jstam.set_bnd3d(b, J(f)))
               for b, f in zip((1, 2, 3), _fields(7, 16, 3)))
    kw = dict(n=16, projection="dct", dct_precision_first="default",
              solver_backend="xla")
    got = tstam.project3d(T(u), T(v), T(w), tstam.StamConfig(**kw),
                          with_residual=True, final=final)
    ref = jstam.project3d(J(u), J(v), J(w), jstam.StamConfig(**kw),
                          with_residual=True, final=final)
    for g, r in zip(got[:3], ref[:3]):
        _close(g, r, DCT_TOL)
    assert float(got[3]) < 1e-5 and float(ref[3]) < 1e-5


def test_matmul_precision_pins_tf32_per_tier():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    before = torch.get_float32_matmul_precision()
    for tier, device, want in (("highest", cuda, "highest"),
                               ("default", cuda, "high"),
                               ("high", cuda, "high"),
                               ("default", cpu, "highest")):
        with tstam._matmul_precision(tier, device):
            assert torch.get_float32_matmul_precision() == want
            assert torch.backends.cuda.matmul.allow_tf32 == (want == "high")
        assert torch.get_float32_matmul_precision() == before
    with pytest.raises(ValueError):
        with tstam._matmul_precision("bogus", cpu):
            pass


_CONFIG_IDS = dict(ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))


@pytest.mark.parametrize("kw", [
    dict(projection="jacobi"),
    dict(visc=1e-5),
    dict(diff=1e-5),
    dict(temp_diff=1e-5),
    dict(advect_mode="gather"),
], **_CONFIG_IDS)
def test_configs_once_outside_the_slice_match_jax(kw):
    """The Jacobi projection, the three diffusions and gather advection,
    which raised before their slices: one step with a residual from a
    seeded moving state, against the JAX dense path (fields at 1e-5 *
    max, as tests/test_torch_jacobi.py holds whole steps)."""
    n = 8
    base = dict(n=n, dt=0.05, advect_mode="stencil", projection="dct",
                jacobi_iters=6, buoyancy_beta=0.5)
    tcfg = tstam.StamConfig(**{**base, **kw})
    jcfg = jstam.StamConfig(solver_backend="xla", **{**base, **kw})
    fields = dict(zip(("u", "v", "w", "dens", "temp"),
                      (np.asarray(jstam.set_bnd3d(b, J(f))) for b, f in
                       zip((1, 2, 3, 0, 0), _fields(8, n, 5, scale=0.3)))))
    got, gres = tstam.step3d(tstam.GridState3D(**{k: T(a) for k, a in
                                                  fields.items()}),
                             tcfg, with_residual=True)
    ref, rres = jstam.step3d(jstam.GridState3D(**{k: J(a) for k, a in
                                                  fields.items()}),
                             jcfg, with_residual=True)
    for f in fields:
        _close(getattr(got, f), getattr(ref, f), 1e-5)
    if tcfg.projection == "jacobi":
        np.testing.assert_allclose(float(gres), float(rres), rtol=1e-3)
    else:   # a DCT residual is rounding: hold both to its level
        assert float(gres) < 1e-6 and float(rres) < 1e-6


@pytest.mark.parametrize("entry", ["step2d", "run2d_python"])
def test_2d_entry_points_once_outside_the_slice_match_jax(entry):
    """The 2D entry points, which raised before the 2D slice: two steps
    of the smoke2d scene (gather advection, BASELINE config 1's
    coefficients) at 16^2 with its sources, against the JAX package."""
    n = 16
    kw = dict(n=n, dt=0.1, diff=1e-5, visc=1e-5, jacobi_iters=20)
    src = np.zeros((n + 2, n + 2), np.float32)
    src[n // 2 - 4:n // 2 + 4, 4:8] = 5.0
    sources = {"dens": src, "fv": 0.4 * src}
    tcfg, jcfg = tstam.StamConfig(**kw), jstam.StamConfig(**kw)
    jstate = jstam.run2d_python(jstam.make_grid2d(jcfg), jcfg, 2,
                                sources={k: J(a) for k, a in sources.items()})
    tsrc = {k: T(a) for k, a in sources.items()}
    tstate = tstam.make_grid2d(tcfg, device="cpu")
    if entry == "step2d":
        for _ in range(2):
            tstate = tstam.step2d(tstate, tcfg, tsrc)
    else:
        tstate = tstam.run2d_python(tstate, tcfg, 2, sources=tsrc)
    for f in ("u", "v", "dens", "temp"):
        _close(getattr(tstate, f), getattr(jstate, f), 1e-5)
    assert float(tstate.v.abs().max()) > 0.0


def test_gather_step_inside_the_whole_gate_takes_no_whole_step(monkeypatch):
    """A 16^3 Jacobi config with gather advection, stepped without the
    residual, is inside the whole step's size gate, but the whole step
    advects by the stencil: it runs the separate stages, as the
    reference takes its whole step only for advect_mode="stencil"."""
    n = 16
    kw = dict(n=n, dt=0.05, diff=1e-5, visc=1e-5, jacobi_iters=20,
              red_black=True, buoyancy_alpha=0.05, buoyancy_beta=1.0,
              vorticity_eps=2.0, advect_mode="gather")
    tcfg = tstam.StamConfig(**kw)
    jcfg = jstam.StamConfig(solver_backend="xla", **kw)
    fields = dict(zip(("u", "v", "w", "dens", "temp"),
                      (np.asarray(jstam.set_bnd3d(b, J(f))) for b, f in
                       zip((1, 2, 3, 0, 0), _fields(9, n, 5, scale=0.3)))))
    tstate = tstam.GridState3D(**{k: T(a) for k, a in fields.items()})
    assert tkernels.step_whole_ok(tstate.u)

    def refuse(*args):
        raise AssertionError("the gather step took the whole step")

    monkeypatch.setattr(tkernels, "step3d_whole", refuse)
    monkeypatch.setattr(tkernels, "step3d_whole_plain", refuse)
    got = tstam.step3d(tstate, tcfg)
    ref = jstam.step3d(jstam.GridState3D(**{k: J(a) for k, a in
                                            fields.items()}), jcfg)
    for f in fields:
        _close(getattr(got, f), getattr(ref, f), 1e-5)
