"""The port's CUDA kernels against their plain PyTorch versions on the
card, at 64^3 and at the main path's 256^3, and the step's launch counts
and final residual.  Marked ``gpu`` and skipped without a CUDA device;
on the card (tests/conftest.py sets up JAX, which these tests do not
use):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

The kernels are built with -fmad=false, so they round like their plain
versions; the tolerances (relative to max|plain output|) are those of
the JAX package's Pallas tests: 3e-6 for advection and forcing, 1e-6
for divergence and gradient subtraction, 1e-5 for whole steps."""

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
    assert kernels.launch_counts() == {"advect3d_multi": 4, "forcing3d": 2,
                                       "div3d": 4, "gradsub3d": 4}
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
