"""The port's CUDA kernels against their plain PyTorch versions on the
card, at 64^3 and at the main path's 256^3 (the 2D kernels at 15^2 to
200^2 fields), and the steps' launch counts and final residual.  Marked ``gpu`` and skipped without a CUDA device;
on the card (tests/conftest.py sets up JAX, which these tests do not
use):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

The kernels are built with -fmad=false, so they round like their plain
versions; the tolerances (relative to max|plain output|) are those of
the JAX package's Pallas tests: 3e-6 for advection and forcing, 1e-6
for divergence, gradient subtraction and the Jacobi solves, 1e-5 for
whole steps.  The whole tier (one cooperative launch) must equal the
streamed kernels bit for bit, and the 2D kernels their plain versions."""

import numpy as np
import pytest
import torch

from tpufluids_torch.grid import kernels, stam

pytestmark = pytest.mark.gpu

SIZES = [64, 256]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fields(dev, n, seed, bnds, lo, hi):
    rng = np.random.default_rng(seed)
    return [stam.set_bnd3d(b, torch.from_numpy(
        rng.uniform(lo, hi, (n + 2,) * 3).astype(np.float32)).to(dev))
        for b in bnds]


def _close(got, want, tol):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.device == w.device
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= tol * scale


def _bench(n, **kw):
    return stam.StamConfig(**{**dict(
        n=n, dt=0.5 / n, vorticity_eps=2.0, buoyancy_beta=0.5,
        buoyancy_alpha=0.05, advect_mode="stencil", projection="dct",
        dct_precision_first="default"), **kw})


def _seeded(cfg, dev):
    s = stam.make_grid3d(cfg, dev)
    k = cfg.n // 8
    s.dens[3 * k:5 * k, 3 * k:5 * k, 1:k] = 1.0
    s.temp[3 * k:5 * k, 3 * k:5 * k, 1:k] = 3.0
    return s


@pytest.mark.parametrize("n", SIZES)
def test_advect_kernel_matches_plain(cuda, n):
    dt0 = 0.5
    u, v, w = _fields(cuda, n, 1, (1, 2, 3), -1.2 / dt0, 1.2 / dt0)
    d, t = _fields(cuda, n, 2, (0, 0), 0.0, 1.0)
    before = kernels.advect3d_multi.launches
    for fields, bnds in (((u, v, w), (1, 2, 3)), ((d, t), (0, 0)),
                         ((d,), (3,))):
        got = kernels.advect3d_multi(fields, bnds, u, v, w, dt0)
        want = kernels.advect3d_multi_plain(fields, bnds, u, v, w, dt0)
        _close(got, want, 3e-6)
    assert kernels.advect3d_multi.launches == before + 3


@pytest.mark.parametrize("coeffs", [
    dict(vorticity_eps=2.0, buoyancy_alpha=0.05, buoyancy_beta=0.5),
    dict(buoyancy_alpha=0.05, buoyancy_beta=0.5, ambient_temp=0.2),
    dict(vorticity_eps=2.0),
], ids=["both", "buoyancy", "vorticity"])
@pytest.mark.parametrize("n", SIZES)
def test_forcing_kernel_matches_plain(cuda, n, coeffs):
    cfg = stam.StamConfig(n=n, dt=0.5 / n, **coeffs)
    u, v, w = _fields(cuda, n, 3, (1, 2, 3), -1.0, 1.0)
    d, t = _fields(cuda, n, 4, (0, 0), 0.0, 1.0)
    before = kernels.forcing3d.launches
    got = kernels.forcing3d(u, v, w, d, t, cfg)
    _close(got, kernels.forcing3d_plain(u, v, w, d, t, cfg), 3e-6)
    assert kernels.forcing3d.launches == before + 1


@pytest.mark.parametrize("n", SIZES)
def test_div_and_gradsub_kernels_match_plain(cuda, n):
    u, v, w, p = _fields(cuda, n, 5, (1, 2, 3, 0), -1.0, 1.0)
    _close((kernels.div3d(u, v, w),), (kernels.div3d_plain(u, v, w),), 1e-6)
    _close(kernels.gradsub3d(p, u, v, w),
           kernels.gradsub3d_plain(p, u, v, w), 1e-6)


def test_step_launches_residual_and_plain_agreement(cuda, monkeypatch):
    cfg = _bench(64)
    state = _seeded(cfg, cuda)
    kernels.reset_launches()
    out, res = stam.run3d_python(state, cfg, 2)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {
        "advect3d_multi": 4, "forcing3d": 2, "div3d": 4, "gradsub3d": 4,
        "lin_solve3d": 0, "lin_solve3d_rb": 0, "diffuse3d_multi": 0,
        "project3d_whole": 0, "step3d_whole": 0, "lin_solve2d": 0,
        "step2d_whole": 0}
    # the final solve runs TF32-free: the residual stays at float32 level
    assert float(res[0]) <= 1e-8
    for name in ("advect3d_multi", "forcing3d", "div3d", "gradsub3d"):
        monkeypatch.setattr(kernels, name, getattr(kernels, name + "_plain"))
    ref, ref_res = stam.run3d_python(state, cfg, 2)
    for f in ("u", "v", "w", "dens", "temp"):
        _close((getattr(out, f),), (getattr(ref, f),), 1e-5)
        assert bool(torch.isfinite(getattr(out, f)).all())


def test_card_matches_cpu_over_four_steps(cuda):
    # first solve at "highest": its TF32 tier is the one intended
    # difference between the card and the CPU
    cfg = _bench(16, dct_precision_first="highest")
    gpu, _ = stam.run3d_python(_seeded(cfg, cuda), cfg, 4)
    cpu, _ = stam.run3d_python(_seeded(cfg, "cpu"), cfg, 4)
    for f in ("u", "v", "w", "dens", "temp"):
        _close((getattr(gpu, f).cpu(),), (getattr(cpu, f),), 1e-5)


def _raw(dev, n, seed, count):
    """Random fields whose ghosts are not set_bnd-consistent: the solves
    read the stored ghosts on their first sweep."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0, 1, (n + 2,) * 3).astype(
        np.float32)).to(dev) for _ in range(count)]


@pytest.mark.parametrize("red_black", [False, True], ids=["jacobi", "rb"])
@pytest.mark.parametrize("n", [15, 16, 64])
def test_solve_kernels_match_plain(cuda, n, red_black):
    """Every b, pressure and diffusion coefficients, zero, consistent
    and raw initial guesses; odd n puts both parities on each face."""
    kern = kernels.lin_solve3d_rb if red_black else kernels.lin_solve3d
    plain = (kernels.lin_solve3d_rb_plain if red_black
             else kernels.lin_solve3d_plain)
    x, x0 = _raw(cuda, n, 6, 2)
    a = 0.05 * 1e-5 * n * n
    for b in range(4):
        for guess in (None, stam.set_bnd3d(b, x), x):
            for coeffs in ((1.0, 6.0), (a, 1 + 6 * a)):
                got = kern(b, guess, x0, *coeffs, 5)
                _close((got,), (plain(b, guess, x0, *coeffs, 5),), 1e-6)


@pytest.mark.parametrize("n", [16, 64])
def test_whole_tier_matches_plain_and_streamed(cuda, n):
    u, v, w = _fields(cuda, n, 7, (1, 2, 3), -1.0, 1.0)
    a = 0.05 * 1e-5 * n * n
    params = ((1, a, 1 + 6 * a), (2, 2 * a, 1 + 12 * a), (0, a, 1 + 6 * a))
    got = kernels.diffuse3d_multi((u, v, w), params, 20)
    _close(got, kernels.diffuse3d_multi_plain((u, v, w), params, 20), 1e-6)
    for g, q, (b, a_, c) in zip(got, (u, v, w), params):
        assert torch.equal(g, kernels.lin_solve3d(b, q, q, a_, c, 20))
    for red_black in (False, True):
        got = kernels.project3d_whole(u, v, w, 20, red_black)
        _close(got, kernels.project3d_whole_plain(u, v, w, 20, red_black),
               1e-6)
        solve = kernels.lin_solve3d_rb if red_black else kernels.lin_solve3d
        div = kernels.div3d(u, v, w)
        streamed = kernels.gradsub3d(solve(0, None, div, 1.0, 6.0, 20), u,
                                     v, w)
        for g, r in zip(got, streamed):
            assert torch.equal(g, r)


@pytest.mark.parametrize("n", [15, 48])
def test_reciprocal_h_kernels_are_bitwise_plain(cuda, n):
    """The kernels that difference by h take 1/h from Python, as PyTorch
    on the card divides by h (test_scalar_division_rounds_as_the_2d_kernel_
    takes_it): bit for bit against their plain versions where n is not a
    power of two (48^3 is inside the whole tier's gate)."""
    u, v, w, p = _fields(cuda, n, 30, (1, 2, 3, 0), -1.0, 1.0)
    d, t = _fields(cuda, n, 31, (0, 0), 0.0, 1.0)
    for coeffs in (dict(vorticity_eps=2.0, buoyancy_alpha=0.05,
                        buoyancy_beta=0.5),
                   dict(vorticity_eps=2.0)):
        cfg = stam.StamConfig(n=n, dt=0.5 / n, **coeffs)
        for g, r in zip(kernels.forcing3d(u, v, w, d, t, cfg),
                        kernels.forcing3d_plain(u, v, w, d, t, cfg)):
            assert torch.equal(g, r), coeffs
    for g, r in zip(kernels.gradsub3d(p, u, v, w),
                    kernels.gradsub3d_plain(p, u, v, w)):
        assert torch.equal(g, r)
    for red_black in (False, True):
        for g, r in zip(kernels.project3d_whole(u, v, w, 20, red_black),
                        kernels.project3d_whole_plain(u, v, w, 20,
                                                      red_black)):
            assert torch.equal(g, r), red_black
    for cfg in (_config(n, True), _config(n, True).replace(red_black=False),
                _config(n, False)):
        got = kernels.step3d_whole(u, v, w, d, t, cfg)
        want = kernels.step3d_whole_plain(u, v, w, d, t, cfg)
        for g, r, f in zip(got, want, FIELDS):
            assert torch.equal(g, r), (cfg.red_black, f)


FIELDS = ("u", "v", "w", "dens", "temp")


def _config(n, plume):
    """BASELINE config 2, or config 4 with ``plume`` (bench.py:323-329)."""
    kw = (dict(buoyancy_alpha=0.05, buoyancy_beta=1.0, vorticity_eps=2.0)
          if plume else {})
    return stam.StamConfig(n=n, dt=0.05, diff=1e-5, visc=1e-5,
                           jacobi_iters=20, red_black=True,
                           advect_mode="stencil", **kw)


def _seeded_plume(cfg, dev):
    """bench.py:330-333 at 64^3, scaled to n."""
    s = stam.make_grid3d(cfg, dev)
    lo, hi, top = 3 * cfg.n // 8, 5 * cfg.n // 8, max(cfg.n // 8, 2) + 1
    s.dens[lo:hi, lo:hi, 1:top] = 1.0
    s.temp[lo:hi, lo:hi, 1:top] = 3.0
    return s


@pytest.mark.parametrize("plume", [False, True], ids=["config2", "config4"])
def test_jacobi_configs_card_match_cpu(cuda, plume):
    cfg = _config(16, plume)
    gpu, gres = stam.run3d_python(_seeded_plume(cfg, cuda), cfg, 4)
    cpu, cres = stam.run3d_python(_seeded_plume(cfg, "cpu"), cfg, 4)
    for f in ("u", "v", "w", "dens", "temp"):
        _close((getattr(gpu, f).cpu(),), (getattr(cpu, f),), 1e-5)
    assert abs(float(gres[0]) - float(cres[0])) <= 1e-3 * float(cres[0])


@pytest.mark.parametrize("case", [
    dict(plume=False),
    dict(plume=True),
    dict(plume=True, red_black=False),
    dict(plume=True, vorticity_eps=0.0, temp_diff=2e-5),
    dict(plume=True, buoyancy_alpha=0.0, buoyancy_beta=0.0, diff=0.0),
    dict(plume=False, visc=0.0, temp_diff=2e-5),
], ids=["config2", "config4", "config4_jacobi", "buoyancy", "vorticity",
        "no_visc"])
@pytest.mark.parametrize("n", [16, 64])
def test_whole_step_matches_plain_and_separate_calls(cuda, n, case):
    """The whole step (one cooperative launch) against its plain version,
    and bit for bit against the separate kernels of stam.step3d_multi,
    on a moving state."""
    case = dict(case)
    cfg = _config(n, case.pop("plume")).replace(**case)
    u, v, w = _fields(cuda, n, 8, (1, 2, 3), -1.0, 1.0)
    d, t = _fields(cuda, n, 9, (0, 0), 0.0, 1.0)
    before = kernels.step3d_whole.launches
    got = kernels.step3d_whole(u, v, w, d, t, cfg)
    assert kernels.step3d_whole.launches == before + 1
    _close(got, kernels.step3d_whole_plain(u, v, w, d, t, cfg), 1e-5)
    multi = stam.step3d_multi(stam.GridState3D(u, v, w, d, t), cfg)
    for g, f in zip(got, ("u", "v", "w", "dens", "temp")):
        assert torch.equal(g, getattr(multi, f)), f


def test_jacobi_step_launches(cuda):
    """Config 4 at 64^3: one whole-step launch a step; the last step
    reports the residual, so it runs the separate kernels: a forcing, two
    whole-tier diffusions, a fused projection, two advections, and the
    streamed final projection (div, red-black solve, gradsub)."""
    cfg = _config(64, True)
    kernels.reset_launches()
    out, res = stam.run3d_python(_seeded_plume(cfg, cuda), cfg, 3)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {
        "advect3d_multi": 2, "forcing3d": 1, "div3d": 1, "gradsub3d": 1,
        "lin_solve3d": 0, "lin_solve3d_rb": 1, "diffuse3d_multi": 2,
        "project3d_whole": 1, "step3d_whole": 2, "lin_solve2d": 0,
        "step2d_whole": 0}
    assert bool(torch.isfinite(out.w).all()) and 0.0 < float(res[0]) < 1e-2


def test_gather_step_takes_no_whole_step(cuda):
    """A 3D gather config inside the whole step's gate runs the separate
    kernels: no step3d_whole launch, no stencil advection."""
    cfg = _config(16, True).replace(advect_mode="gather")
    kernels.reset_launches()
    gpu, gres = stam.run3d_python(_seeded_plume(cfg, cuda), cfg, 3)
    cpu, cres = stam.run3d_python(_seeded_plume(cfg, "cpu"), cfg, 3)
    counts = kernels.launch_counts()
    assert counts["step3d_whole"] == 0 and counts["advect3d_multi"] == 0
    assert counts["forcing3d"] == 3 and counts["diffuse3d_multi"] == 6
    for f in ("u", "v", "w", "dens", "temp"):
        _close((getattr(gpu, f).cpu(),), (getattr(cpu, f),), 1e-5)
    assert abs(float(gres[0]) - float(cres[0])) <= 1e-3 * float(cres[0])


# ---------------------------------------------------------------------------
# the 2D kernels: bit for bit against their plain versions


def _fields2d(dev, n, seed, bnds, lo, hi, raw=False):
    rng = np.random.default_rng(seed)
    out = []
    for b in bnds:
        a = torch.from_numpy(rng.uniform(lo, hi, (n + 2,) * 2).astype(
            np.float32)).to(dev)
        out.append(a if raw else stam.set_bnd2d(b, a))
    return out


def test_scalar_division_rounds_as_the_2d_kernel_takes_it(cuda):
    """The plain 2D stages divide by the Python scalar h; PyTorch on the
    card computes that as a product with fl(1 / h), the reciprocal taken
    in double, which is what csrc/grid2d.cu multiplies by.  (On the CPU
    it divides by fl(h); the two meet when n is a power of two.)"""
    x = torch.from_numpy(np.random.default_rng(23).normal(
        0, 1, 1 << 16).astype(np.float32)).to(cuda)
    for n in (13, 14, 128):
        h = 1.0 / n
        assert torch.equal(x / h, x * (1.0 / h))


@pytest.mark.parametrize("n", [13, 14, 128, 198])
def test_lin_solve2d_kernel_is_bitwise_plain(cuda, n):
    """Fields of 15^2, 16^2, 130^2 and 200^2 cells (the last past shared
    memory: its buffers in device memory); every b, zero, consistent and
    raw guesses, pressure and diffusion coefficients, odd and even sweep
    counts."""
    x, x0 = _fields2d(cuda, n, 20, (0, 0), -1.0, 1.0, raw=True)
    a = 0.1 * 1e-5 * n * n
    before = kernels.lin_solve2d.launches
    calls = 0
    for b in range(3):
        for guess in (None, stam.set_bnd2d(b, x), x):
            for coeffs, iters in (((1.0, 4.0), 20), ((a, 1 + 4 * a), 7)):
                got = kernels.lin_solve2d(b, guess, x0, *coeffs, iters)
                want = kernels.lin_solve2d_plain(b, guess, x0, *coeffs,
                                                 iters)
                assert torch.equal(got, want), (b, coeffs, iters)
                calls += 1
    assert kernels.lin_solve2d.launches == before + calls
    assert kernels.step2d_whole_ok(x0) == (n < 169)


def _config1(n, **kw):
    """BASELINE config 1 (bench.py:305-306) at size n."""
    return stam.StamConfig(**{**dict(n=n, dt=0.1, diff=1e-5, visc=1e-5,
                                     jacobi_iters=20, advect_mode="stencil"),
                              **kw})


FORCING = dict(buoyancy_alpha=0.04, buoyancy_beta=0.9, vorticity_eps=1.5,
               temp_diff=2e-5, ambient_temp=0.1)


@pytest.mark.parametrize("case", [
    {}, FORCING, dict(FORCING, visc=0.0, diff=0.0),
    dict(buoyancy_beta=0.9, diff=0.0), dict(vorticity_eps=1.5)],
    ids=["config1", "forcing", "no_diffusion", "buoyancy", "vorticity"])
@pytest.mark.parametrize("n", [13, 14, 128])
def test_step2d_whole_is_bitwise_plain_and_multi(cuda, n, case):
    """One whole-step launch against its plain version and against the
    multi-call step through the solve kernel, on a moving state."""
    cfg = _config1(n, **case)
    u, v = _fields2d(cuda, n, 21, (1, 2), -1.0 / (cfg.dt * n),
                     1.0 / (cfg.dt * n))
    d, t = _fields2d(cuda, n, 22, (0, 0), 0.0, 1.0)
    before = kernels.step2d_whole.launches
    got = kernels.step2d_whole(u, v, d, t, cfg)
    assert kernels.step2d_whole.launches == before + 1
    want = kernels.step2d_whole_plain(u, v, d, t, cfg)
    multi = stam.step2d_multi(stam.GridState2D(u, v, d, t), cfg)
    for g, w, f in zip(got, want, ("u", "v", "dens", "temp")):
        assert torch.equal(g, w), f
        assert torch.equal(g, getattr(multi, f)), f
    assert float(got[0].abs().max()) > 0.0


def _sources2d(n, dev):
    """bench.py:308-311's sources at size n (cli.py:202-205)."""
    src = torch.zeros((n + 2, n + 2), device=dev)
    fv = torch.zeros_like(src)
    src[n // 2 - 4:n // 2 + 4, 4:8] = 5.0
    fv[n // 2 - 4:n // 2 + 4, 4:8] = 2.0
    return {"dens": src, "fv": fv}


@pytest.mark.parametrize("mode", ["stencil", "gather"])
def test_2d_card_matches_cpu_over_four_steps(cuda, mode):
    cfg = _config1(32, advect_mode=mode)
    gpu = stam.run2d_python(stam.make_grid2d(cfg, cuda), cfg, 4,
                            sources=_sources2d(32, cuda))
    cpu = stam.run2d_python(stam.make_grid2d(cfg, "cpu"), cfg, 4,
                            sources=_sources2d(32, "cpu"))
    for f in ("u", "v", "dens", "temp"):
        _close((getattr(gpu, f).cpu(),), (getattr(cpu, f),), 1e-5)


def test_2d_launch_counts(cuda):
    """Config 1 at 128^2: one step2d_whole launch a step; the smoke2d
    default (gather) five lin_solve2d launches a step (two velocity
    diffusions, two projections, the dens diffusion); run2d reports the
    residual every step, so it takes the multi-call step too."""
    cfg = _config1(128)
    expect = dict.fromkeys(kernels.launch_counts(), 0)
    for c, steps, want in ((cfg, 3, dict(step2d_whole=3)),
                           (cfg.replace(advect_mode="gather"), 3,
                            dict(lin_solve2d=15))):
        kernels.reset_launches()
        s = stam.run2d_python(stam.make_grid2d(c, cuda), c, steps,
                              sources=_sources2d(128, cuda))
        torch.cuda.synchronize()
        assert kernels.launch_counts() == {**expect, **want}
        assert bool(torch.isfinite(s.dens).all()) and float(s.dens.sum()) > 0
    kernels.reset_launches()
    s, res = stam.run2d(s, cfg, 2)
    assert kernels.launch_counts() == {**expect, "lin_solve2d": 10}
    assert res.shape == (2,) and 0.0 < float(res.max()) < 1e-2
