"""The port's 2D step and gather advection against the JAX package on the
CPU: set_bnd2d, the 2D solve against tpufluids.grid.stam's dense solver
and the interpret-mode lin_solve2d_pallas, advection, the projection,
the whole step's plain version against the interpret-mode
step2d_whole_pallas, and four steps of BASELINE config 1 and the smoke2d
scene's variants at 32^2.

Tolerances:
- set_bnd2d only copies, negates and averages two values: exact.
- At the pressure coefficients (a = 1, c = 4) the solves agree bit for
  bit: one neighbour order, one rounding per operation.
- At diffusion coefficients, 1e-6 * max|reference|: the JAX solve is a
  compiled loop, where XLA contracts x0 + a * nb into a fused
  multiply-add (ROADMAP Queue 3, "Jitted FMA in the JAX solves").
- Advection, the projection and the whole step's plain version against
  the Pallas kernel, 1e-6 * max|reference|; whole steps, 1e-5 * max per
  field (as tests/test_torch_jacobi.py); Jacobi residuals within 1e-3
  relative, DCT residuals both below 1e-6 (float32 rounding).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpufluids.grid import pallas_kernels as pk
from tpufluids.grid import stam as jstam
from tpufluids_torch.grid import convert, kernels
from tpufluids_torch.grid import stam as tstam

TOL = 1e-6
STEP_TOL = 1e-5
RESIDUAL_RTOL = 1e-3
ITERS = 6
N = 32                    # the steps' size
J = jnp.asarray


def T(a):
    return torch.from_numpy(np.array(a))


def _rand(seed, n, count=1, scale=1.0, ndim=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, scale, (n + 2,) * ndim).astype(np.float32)
            for _ in range(count)]


def _consistent(b, x):
    return np.asarray(jstam.set_bnd2d(b, J(x)))


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# set_bnd2d and the solve


@pytest.mark.parametrize("b", [0, 1, 2])
def test_set_bnd2d_is_bitwise_jax(b):
    (x,) = _rand(b, 12)
    got = tstam.set_bnd2d(b, T(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jstam.set_bnd2d(b, J(x))))
    # a corner is 0.5 (sy c + sx c): c for b = 0, 0 for b = 1 or 2
    c = x[1, 1]
    assert got[0, 0] == (c if b == 0 else 0.0)


@pytest.mark.parametrize("b", [0, 1, 2])
def test_lin_solve2d_is_bitwise_jax(b):
    """a = 1, c = 4 (as tests/test_pallas_kernels.py), on consistent, raw
    and zero initial guesses, against the dense solve and the
    interpret-mode Pallas kernel."""
    n = 16
    x, x0 = _rand(10 + b, n, 2)
    for guess in (_consistent(b, x), x, None):
        jguess = J(np.zeros_like(x) if guess is None else guess)
        ref = np.asarray(jstam.lin_solve2d(b, jguess, J(x0), 1.0, 4.0, ITERS))
        with pltpu.force_tpu_interpret_mode():
            pal = np.asarray(pk.lin_solve2d_pallas(b, jguess, J(x0), 1.0, 4.0,
                                                   ITERS))
        got = tstam.lin_solve2d(b, None if guess is None else T(guess),
                                T(x0), 1.0, 4.0, ITERS).numpy()
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, pal)


@pytest.mark.parametrize("b", [0, 1, 2])
def test_lin_solve2d_diffusion_coefficients_match_jax(b):
    n = 15
    a = 0.1 * 1e-5 * n * n
    x, x0 = _rand(20 + b, n, 2)
    for guess in (_consistent(b, x), x):
        ref = jstam.lin_solve2d(b, J(guess), J(x0), a, 1 + 4 * a, ITERS)
        _close(tstam.lin_solve2d(b, T(guess), T(x0), a, 1 + 4 * a, ITERS),
               ref)
    kw = dict(n=n, dt=0.1, jacobi_iters=ITERS)
    _close(tstam.diffuse2d(b, T(x), tstam.StamConfig(**kw), 3e-4),
           jstam.diffuse2d(b, J(x), jstam.StamConfig(solver_backend="xla",
                                                     **kw), 3e-4))


# ---------------------------------------------------------------------------
# advection


def _velocities(seed, n, dt, ndim):
    """Velocities up to 1.5 cells per step (both clamps of the stencil,
    and gather backtraces past a cell and out of the domain)."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1.5, 1.5, (n + 2,) * ndim).astype(np.float32)
            / (dt * n) for _ in range(ndim)]


@pytest.mark.parametrize("b", [0, 1, 2])
@pytest.mark.parametrize("mode", ["gather", "stencil"])
def test_advect2d_matches_jax(mode, b):
    n, dt = 14, 0.1
    u, v = _velocities(30 + b, n, dt, 2)
    (q,) = _rand(31 + b, n)
    kw = dict(n=n, dt=dt, advect_mode=mode)
    fn = "advect2d" if mode == "gather" else "advect2d_stencil"
    _close(getattr(tstam, fn)(b, T(q), T(u), T(v), tstam.StamConfig(**kw)),
           getattr(jstam, fn)(b, J(q), J(u), J(v), jstam.StamConfig(**kw)))


@pytest.mark.parametrize("b", [0, 1, 3])
def test_advect3d_gather_matches_jax(b):
    n, dt = 10, 0.05
    u, v, w = _velocities(40 + b, n, dt, 3)
    (q,) = _rand(41 + b, n, ndim=3)
    kw = dict(n=n, dt=dt)
    _close(tstam.advect3d(b, T(q), T(u), T(v), T(w), tstam.StamConfig(**kw)),
           jstam.advect3d(b, J(q), J(u), J(v), J(w), jstam.StamConfig(**kw)))


# ---------------------------------------------------------------------------
# the projection and the forcings


@pytest.mark.parametrize("projection", ["jacobi", "dct", "multigrid"])
def test_project2d_matches_jax(projection):
    """Every projection but "dct" is the Jacobi solve in 2D."""
    n = 16
    u, v = (_consistent(b, f) for b, f in zip((1, 2), _rand(50, n, 2)))
    kw = dict(n=n, projection=projection, jacobi_iters=ITERS)
    got = tstam.project2d(T(u), T(v), tstam.StamConfig(**kw),
                          with_residual=True)
    ref = jstam.project2d(J(u), J(v), jstam.StamConfig(solver_backend="xla",
                                                       **kw),
                          with_residual=True)
    for g, r in zip(got[:2], ref[:2]):
        _close(g, r)
    if projection == "dct":
        assert float(got[2]) < 1e-6 and float(ref[2]) < 1e-6
    else:
        np.testing.assert_allclose(float(got[2]), float(ref[2]),
                                   rtol=RESIDUAL_RTOL)
        assert float(got[2]) > 1e-3     # six sweeps leave a residual


def test_divergence_and_forcings_match_jax():
    n = 12
    u, v, p, d = _rand(60, n, 4, scale=0.4)
    t = np.abs(_rand(61, n)[0])
    kw = dict(n=n, dt=0.02, vorticity_eps=3.0, buoyancy_alpha=0.05,
              buoyancy_beta=1.0, ambient_temp=0.2)
    tcfg, jcfg = tstam.StamConfig(**kw), jstam.StamConfig(**kw)
    _close(tstam.divergence2d(T(u), T(v)), jstam.divergence2d(J(u), J(v)))
    _close(tstam.poisson_residual2d(T(p), T(d)),
           jstam.poisson_residual2d(J(p), J(d)))
    _close(tstam.buoyancy2d(T(v), T(d), T(t), tcfg),
           jstam.buoyancy2d(J(v), J(d), J(t), jcfg))
    for g, r in zip(tstam.vorticity_confinement2d(T(u), T(v), tcfg),
                    jstam.vorticity_confinement2d(J(u), J(v), jcfg)):
        _close(g, r)


# ---------------------------------------------------------------------------
# the whole step's plain version


FORCING = dict(buoyancy_alpha=0.04, buoyancy_beta=0.9, vorticity_eps=1.5,
               temp_diff=2e-5)


def _sources(n):
    """bench.py:308-311's sources at size n (cli.py:202-205), with a temp
    source for the forcing cases (tests/test_pallas_kernels.py:318-321)."""
    src = np.zeros((n + 2, n + 2), np.float32)
    box = (slice(n // 2 - 4, n // 2 + 4), slice(4, 8))
    out = {}
    for key, val in (("dens", 5.0), ("fv", 2.0), ("temp", 1.0)):
        out[key] = src.copy()
        out[key][box] = val
    return out


def _whole_case(forcing):
    """tests/test_pallas_kernels.py:306-321's step at 32^2: 8 iterations,
    dens and temp on a positive background, its sources added once."""
    kw = dict(n=N, dt=0.1, diff=1e-5, visc=1e-5, jacobi_iters=8,
              advect_mode="stencil", **(FORCING if forcing else {}))
    s = jstam.make_grid2d(jstam.StamConfig(**kw))
    fields = {"u": np.asarray(s.u), "v": np.asarray(s.v),
              "dens": np.full_like(s.dens, 0.1),
              "temp": np.full_like(s.temp, 0.2)}
    src = _sources(N)
    fields["v"] = fields["v"] + 0.1 * src["fv"]
    fields["dens"] = fields["dens"] + 0.1 * src["dens"]
    if forcing:
        fields["temp"] = fields["temp"] + 0.1 * src["temp"]
    return kw, fields


@pytest.mark.parametrize("forcing", [False, True], ids=["config1", "forcing"])
def test_step2d_whole_plain_matches_pallas(forcing):
    kw, fields = _whole_case(forcing)
    jcfg = jstam.StamConfig(**kw)

    def ac(coeff):
        a = jcfg.dt * coeff * N * N
        return float(a), float(1.0 + 4.0 * a)

    with pltpu.force_tpu_interpret_mode():
        refs = pk.step2d_whole_pallas(
            *(J(fields[f]) for f in convert.FIELDS2D), iters=jcfg.jacobi_iters,
            dt=float(jcfg.dt), h=1.0 / N, n=N,
            eps=float(jcfg.vorticity_eps),
            b_alpha=float(jcfg.buoyancy_alpha),
            b_beta=float(jcfg.buoyancy_beta),
            t_amb=float(jcfg.ambient_temp), visc_ac=ac(jcfg.visc),
            diff_ac=ac(jcfg.diff),
            temp_ac=ac(jcfg.temp_diff) if jcfg.temp_diff else None,
            dt0=float(jcfg.dt * N))
    got = kernels.step2d_whole_plain(*(T(fields[f]) for f in convert.FIELDS2D),
                                     tstam.StamConfig(**kw))
    for g, r, f in zip(got, refs, convert.FIELDS2D):
        _close(g, r)
        assert np.isfinite(g.numpy()).all(), f


@pytest.mark.parametrize("case", [
    {}, FORCING, dict(FORCING, visc=0.0, diff=0.0),
    dict(buoyancy_beta=0.9), dict(vorticity_eps=1.5, diff=0.0)],
    ids=["config1", "forcing", "no_diffusion", "buoyancy", "vorticity"])
def test_step2d_whole_plain_equals_the_multi_call_step(case):
    """The whole step's plain version is step2d_multi's sequence, bit for
    bit, in each combination of its phases; step2d takes it for a step
    without the residual."""
    kw, fields = _whole_case(False)
    cfg = tstam.StamConfig(**{**kw, "n": 12, **case})
    fields = [T(f[10:24, 10:24]) for f in fields.values()]
    got = kernels.step2d_whole_plain(*fields, cfg)
    multi = tstam.step2d_multi(tstam.GridState2D(*fields), cfg)
    routed = tstam.step2d(tstam.GridState2D(*fields), cfg)
    for g, f in zip(got, convert.FIELDS2D):
        assert torch.equal(g, getattr(multi, f)), f
        assert torch.equal(g, getattr(routed, f)), f


# ---------------------------------------------------------------------------
# the slice: four steps of config 1 and the smoke2d variants at 32^2

CONFIG1 = dict(n=N, dt=0.1, diff=1e-5, visc=1e-5, jacobi_iters=20)
CASES = {
    "config1": dict(advect_mode="stencil"),             # bench.py:305-306
    "smoke2d_gather": {},                                # cli.py:190-197
    "smoke2d_dct": dict(projection="dct"),               # --projection dct
    "forcing": dict(FORCING, ambient_temp=0.1),
    "multigrid": dict(projection="multigrid"),           # Jacobi in 2D
    "bfloat16": dict(advect_mode="stencil", solver_dtype="bfloat16"),
}


def _run_both(kw, steps):
    jcfg = jstam.StamConfig(solver_backend="xla", **kw)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    src = _sources(N)
    jstate = jstam.run2d_python(jstam.make_grid2d(jcfg), jcfg, steps,
                                sources={k: J(a) for k, a in src.items()})
    kernels.reset_launches()
    tstate = tstam.run2d_python(tstam.make_grid2d(tcfg, device="cpu"), tcfg,
                                steps, sources={k: T(a) for k, a in
                                                src.items()})
    assert set(kernels.launch_counts().values()) == {0}
    return jstate, tstate


@pytest.mark.parametrize("name", list(CASES))
def test_port_matches_jax_over_four_steps(name):
    jstate, tstate = _run_both({**CONFIG1, **CASES[name]}, 4)
    got = convert.state_to_numpy(tstate)
    for f in convert.FIELDS2D:
        ref = np.asarray(getattr(jstate, f))
        assert got[f].shape == ref.shape == (N + 2,) * 2
        assert np.isfinite(got[f]).all()
        np.testing.assert_allclose(got[f], ref, rtol=0,
                                   atol=STEP_TOL * float(np.abs(ref).max()),
                                   err_msg=f)
    # the source rose and spread: the step did real work
    assert float(np.abs(got["v"]).max()) > 1e-2 and got["dens"].sum() > 0


@pytest.mark.parametrize("mode", ["stencil", "gather"])
def test_run2d_residuals_match_jax(mode):
    kw = dict(CONFIG1, advect_mode=mode)
    jstate, _ = _run_both(kw, 2)
    start = convert.state_from_numpy(
        {f: np.asarray(getattr(jstate, f)) for f in convert.FIELDS2D},
        device="cpu")
    jcfg = jstam.StamConfig(solver_backend="xla", **kw)
    jstate, jres = jstam.run2d(jstate, jcfg, 3)
    tstate, tres = tstam.run2d(start, tstam.StamConfig(**kw), 3)
    assert tres.shape == jres.shape == (3,)
    np.testing.assert_allclose(tres.numpy(), np.asarray(jres),
                               rtol=RESIDUAL_RTOL)
    assert float(tres.min()) > 1e-7
    for f in convert.FIELDS2D:
        _close(getattr(tstate, f), getattr(jstate, f), STEP_TOL)


def test_run2d_python_snapshots_on_the_cpu():
    cfg = tstam.StamConfig(**CONFIG1)
    src = {k: T(a) for k, a in _sources(N).items()}
    frames = []
    out = tstam.run2d_python(tstam.make_grid2d(cfg, device="cpu"), cfg, 5,
                             sources=src, snapshot_every=2,
                             snapshot_fn=lambda i, s: frames.append((i, s)))
    assert [i for i, _ in frames] == [2, 4]
    for _, s in frames:
        assert isinstance(s, tstam.GridState2D)
        assert all(getattr(s, f).device.type == "cpu"
                   for f in convert.FIELDS2D)
        assert np.asarray(s.dens).shape == (N + 2, N + 2)
    # the frames are the states of those steps
    again = tstam.run2d_python(tstam.make_grid2d(cfg, device="cpu"), cfg, 4,
                               sources=src)
    assert torch.equal(frames[1][1].dens, again.dens)
    assert not torch.equal(out.dens, again.dens)


# ---------------------------------------------------------------------------
# conversion, wrappers, gates


def test_state2d_and_config_round_trip():
    kw, fields = _whole_case(True)
    state = convert.state_from_numpy(fields, device="cpu")
    assert isinstance(state, tstam.GridState2D)
    back = convert.state_to_numpy(state)
    assert set(back) == set(convert.FIELDS2D)
    for f in convert.FIELDS2D:
        np.testing.assert_array_equal(back[f], fields[f])
    jcfg = jstam.StamConfig(**kw)
    assert dataclasses.asdict(convert.config_from_dict(
        dataclasses.asdict(jcfg))) == dataclasses.asdict(jcfg)
    with pytest.raises(ValueError, match="temp"):
        convert.state_from_numpy({f: a for f, a in fields.items()
                                  if f != "temp"}, device="cpu")
    grid = tstam.make_grid2d(tstam.StamConfig(n=6, ambient_temp=0.3), "cpu")
    assert grid.u.shape == (8, 8) and float(grid.temp.min()) == \
        np.float32(0.3)


def test_2d_wrappers_run_the_plain_version_on_cpu_without_counting():
    kw, fields = _whole_case(True)
    cfg = tstam.StamConfig(**{**kw, "n": 12})
    fields = [T(f[10:24, 10:24]) for f in fields.values()]
    kernels.reset_launches()
    pairs = [((kernels.lin_solve2d(1, fields[0], fields[1], 0.5, 3.0, 3),),
              (kernels.lin_solve2d_plain(1, fields[0], fields[1], 0.5, 3.0,
                                         3),)),
             (kernels.step2d_whole(*fields, cfg),
              kernels.step2d_whole_plain(*fields, cfg))]
    for got, want in pairs:
        for g, r in zip(got, want):
            assert torch.equal(g, r)
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("bad", ["b", "iters", "float64", "cube", "oblong",
                                 "meta"])
def test_2d_wrappers_reject_what_the_kernels_do_not_take(bad):
    x, x0 = (T(f) for f in _rand(70, 6, 2))
    b, iters, err = 0, 2, ValueError
    cfg = tstam.StamConfig(n=6, advect_mode="stencil")
    if bad == "b":
        b = 3
    elif bad == "iters":
        iters = 0
    elif bad == "float64":
        x, err = x.double(), TypeError
    elif bad == "cube":
        x = T(_rand(71, 6, ndim=3)[0])
    elif bad == "oblong":
        x = x[:-1].contiguous()
    else:
        x = x.to("meta")
    with pytest.raises(err):
        kernels.lin_solve2d(b, x, x0, 0.1, 1.4, iters)
    if bad not in ("b", "iters"):
        with pytest.raises(err):
            kernels.step2d_whole(x0, x, x0, x0, cfg)


@pytest.mark.parametrize("bad", [dict(advect_mode="gather"),
                                 dict(projection="dct"),
                                 dict(solver_dtype="bfloat16")],
                         ids=["gather", "dct", "bfloat16"])
def test_step2d_whole_rejects_other_steps(bad):
    cfg = tstam.StamConfig(**{"n": 6, "advect_mode": "stencil", **bad})
    x = T(_rand(72, 6)[0])
    with pytest.raises(ValueError):
        kernels.step2d_whole(x, x, x, x, cfg)


def test_2d_gates():
    def field(n):
        return torch.empty((n + 2,) * 2, device="meta")
    # the whole step: the reference's gate, nx ny 4 B x 20 <= 96 MiB, up
    # to 1121^2 cells (n = 1119), as pallas_kernels.step2d_whole_ok
    for n in (128, 168, 169, 510, 1119, 1120):
        assert kernels.step2d_whole_ok(field(n)) == \
            pk.step2d_whole_ok((n + 2, n + 2)) == (n <= 1119)
