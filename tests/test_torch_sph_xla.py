"""The JAX package's XLA pair path in the port, on the CPU: the base
variant with ``subbin_parity`` (sub-binned overfull cells), and any
configuration with ``force_backend="xla"``, whose neighbour runs are
clipped at ``3 * max_per_cell`` rows and count the dropped slots in
``bin_overflow``.  Held against the JAX package's own XLA path
(``compute_forces``, ``sph_step``; jitted) at up to 400 particles, with
inputs made from numpy seeds.

Tolerances, those of tests/test_torch_sph.py and tests/test_torch_unidyn.py:
the base force pass rtol 2e-4 and atol 1e-6 * max(1, max|ref|); steps by
particle id rtol 2e-4 (base) or 1e-3 (unidyn), atol 1e-5 * max(1,
max|ref|); the overflow counts, particle ids and masses exactly."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.test_forces_vs_oracle import mixed_blob
from tpufluids import binning as jbinning
from tpufluids import config as jconfig
from tpufluids import forces as jforces
from tpufluids import step as jstep
from tpufluids.oracle import state_to_dict
from tpufluids.scenes import random_blob as jblob
from tpufluids_torch import binning, config, convert, sph_kernels, step
from tpufluids_torch.state import FIELDS
from tests.test_torch_unidyn_lanes import share_of_the_cores  # noqa: F401

JB = jconfig.BASE_CONFIG
JU = jconfig.UNIDYN_CONFIG.replace(max_per_cell=64)
_JSTEP = jax.jit(jstep.sph_step, static_argnames=("cfg", "subbin_parity"))


def _port(jcfg):
    return convert.config_from_dict(dataclasses.asdict(jcfg))


def _dense_blob():
    """400 particles in a 0.2 cube: about 6 a cell of 0.05, many cells
    over the sub-bin threshold of 6."""
    return jblob(400, seed=3, span=0.1, boundary_frac=0.1)


def _mixed():
    """A mixed-phase blob of 300 in a 0.3 cube: about 19 a cell of 0.12."""
    return mixed_blob(300, 5, JU, span=0.15, boundary_frac=0.1)


def _both(jst):
    return jst, convert.state_from_numpy(state_to_dict(jst), device="cpu")


def _by_pid(d):
    alive = d["alive"].astype(bool)
    rows = np.argsort(d["pid"][alive])
    return {k: v[alive][rows] for k, v in d.items()}


def _close(got, ref, name, rtol, atol):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol * max(1.0, np.abs(ref).max()),
                               err_msg=name)


def _steps(jcfg, jst, tst, n, fields, rtol, subbin_parity=None):
    """n steps of both packages; the states by pid, and each step's
    bin_overflow equal."""
    cfg = _port(jcfg)
    for _ in range(n):
        jst, jm = _JSTEP(jst, jcfg, subbin_parity)
        tst, tm = step.sph_step(tst, cfg, subbin_parity)
        assert int(tm.bin_overflow) == int(jm.bin_overflow)
        assert int(tm.n_alive) == int(jm.n_alive)
    got = _by_pid(convert.state_to_numpy(tst))
    want = _by_pid(state_to_dict(jst))
    np.testing.assert_array_equal(got["pid"], want["pid"])
    np.testing.assert_array_equal(got["mass"], want["mass"])
    for f in fields:
        _close(got[f], want[f], f, rtol, 1e-5)
    return tst, tm


def test_subbinned_base_forces_match_compute_forces():
    """One force pass of the sub-binned base variant: the octant rule of
    overfull cells cuts pairs (the sums differ from the full stencil's)
    and the sums equal JAX's compute_forces."""
    jst, tst = _both(_dense_blob())
    jcfg = JB.replace(subbin_parity=True)
    cfg = _port(jcfg)
    sorted_j, jbt = jbinning.sort_by_cell(jst, jcfg)
    ref = jax.jit(jforces.compute_forces, static_argnames=(
        "cfg", "subbin_parity", "subbin_threshold"))(
        sorted_j, jbt, jcfg, subbin_parity=True,
        subbin_threshold=jcfg.subbin_threshold)
    sorted_t, bt = step.sort_for_forces(tst, cfg)
    assert int(bt.home_count.max()) > cfg.subbin_threshold
    acc, overflow = step.dispatch_forces(sorted_t, bt, cfg)
    assert int(overflow) == int(jbt.overflow) == 0
    np.testing.assert_array_equal(sorted_t.pid.numpy(),
                                  np.asarray(sorted_j.pid))
    for f in ("sum_w", "dpress"):
        _close(getattr(acc, f).numpy(), getattr(ref, f), f, 2e-4, 1e-6)
    full, _ = step.dispatch_forces(sorted_t, bt, cfg, subbin_parity=False)
    assert not torch.allclose(full.sum_w, acc.sum_w)


@pytest.mark.parametrize("how", ["cfg", "call"])
def test_subbinned_base_steps_match_jax(how):
    """Three steps of the base variant with subbin_parity, from the
    configuration or the call, by particle id."""
    jst, tst = _both(_dense_blob())
    if how == "cfg":
        _steps(JB.replace(subbin_parity=True), jst, tst, 3,
               ("pos", "vel", "dens", "press", "acc"), 2e-4)
    else:
        _steps(JB, jst, tst, 3, ("pos", "vel", "dens", "press", "acc"),
               2e-4, subbin_parity=True)


@pytest.mark.parametrize("variant", ["base", "unidyn"])
def test_clipped_runs_count_what_they_drop(variant):
    """force_backend="xla" with runs over 3 * max_per_cell rows: each
    step's bin_overflow equals JAX's exactly, and the states agree."""
    if variant == "base":
        jcfg = JB.replace(force_backend="xla", max_per_cell=2)
        jst, tst = _both(_dense_blob())
        fields, rtol = ("pos", "vel", "dens", "press"), 2e-4
    else:
        jcfg = JU.replace(force_backend="xla", max_per_cell=4)
        jst, tst = _both(_mixed())
        fields, rtol = ("pos", "vel", "dens", "solid", "stress"), 1e-3
    _, bt = binning.sort_tables(tst, _port(jcfg))
    assert int(binning.clipped_runs(bt, _port(jcfg))[2]) > 0
    _steps(jcfg, jst, tst, 2, fields, rtol)


@pytest.mark.parametrize("merge", [False, True], ids=["plain", "merge"])
def test_unidyn_xla_path_matches_jax(merge):
    """The unidyn variant with force_backend="xla" (its sub-binning on,
    as the preset has it): three steps by particle id."""
    jcfg = JU.replace(force_backend="xla",
                      merge_dist=0.03 if merge else -10.0)
    jst, tst = _both(_mixed())
    tst, m = _steps(jcfg, jst, tst, 3,
                    ("pos", "vel", "dens", "solid", "fluid", "stress"), 1e-3)
    assert (int(m.n_alive) < 300) == merge


@pytest.mark.parametrize("variant", ["base", "unidyn"])
def test_xla_path_equals_the_kernels_where_nothing_clips(variant,
                                                         monkeypatch):
    """Without a clipped run the XLA path walks the kernels' runs in the
    same chunks: its force pass equals the plain kernels' bit for bit
    (by sort row), though its pool is permuted into cell order; a step
    agrees by particle id to the last bit of the update's torch.pow,
    whose vector and scalar loops round differently on the CPU.  No
    kernel wrapper runs on the XLA path."""
    if variant == "base":
        cfg, jst = _port(JB.replace(max_per_cell=64)), _dense_blob()
    else:
        cfg, jst = _port(JU), _mixed()
    xcfg = cfg.replace(force_backend="xla")
    tst = convert.state_from_numpy(state_to_dict(jst), device="cpu")
    kern, _ = step.dispatch_forces(tst, *step.sort_for_forces(tst, cfg)[1:],
                                   cfg)
    kern_step, _ = step.sph_step(tst, cfg)
    for k in sph_kernels.KERNELS:
        monkeypatch.setattr(sph_kernels, k.__name__ + "_plain", None)
    sorted_t, bt = step.sort_for_forces(tst, xcfg)
    assert not torch.equal(sorted_t.pid, tst.pid)
    xla, overflow = step.dispatch_forces(sorted_t, bt, xcfg)
    assert int(overflow) == 0
    perm = sorted_t.pid.long()              # pids are the rows here
    for f in xla._fields:
        a, b = getattr(kern, f), getattr(xla, f)
        if a is None:
            assert b is None, f
            continue
        if f == "merge_partner":
            a = torch.where(a >= 0, torch.argsort(perm)[a.clamp(min=0)], -1)
        assert torch.equal(a[perm], b), f
    xla_step, m = step.sph_step(tst, xcfg)
    assert int(m.bin_overflow) == 0
    a = _by_pid(convert.state_to_numpy(kern_step))
    b = _by_pid(convert.state_to_numpy(xla_step))
    for f in FIELDS:
        np.testing.assert_allclose(a[f], b[f], rtol=1e-6, atol=0, err_msg=f)


@pytest.mark.parametrize("cfg,kw", [
    (JB.replace(sort_every=4, force_backend="xla"), {}),
    (JB.replace(sort_every=4), dict(subbin_parity=True)),
], ids=["xla", "subbin"])
def test_sort_every_on_the_xla_path_raises_as_in_jax(cfg, kw):
    jst, tst = _both(jblob(20, seed=0))
    with pytest.raises(ValueError, match="Pallas"):
        jstep.run_python(jst, cfg, 2, **kw)
    with pytest.raises(ValueError, match="Pallas"):
        step.run_python(tst, _port(cfg), 2, **kw)
    with pytest.raises(ValueError, match="Pallas"):
        step.sph_step(tst, _port(cfg), **kw)


@pytest.mark.parametrize("variant", ["base", "unidyn"])
@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("subbin", [False, True])
def test_use_kernels_is_use_pallas_forces(variant, backend, subbin):
    """The kernels take what the JAX package's Pallas backend takes; its
    "auto", the Pallas backend on a TPU, is the kernels in the port."""
    jcfg = (JB if variant == "base" else JU).replace(force_backend=backend)
    assert step.use_kernels(_port(jcfg), subbin) == (
        jstep.use_pallas_forces(jcfg, subbin))
    assert step.use_kernels(_port(jcfg.replace(force_backend="auto")),
                            subbin) == (variant != "base" or not subbin)


def test_a_drift_hook_never_takes_the_resident_kernel():
    cfg = config.UNIDYN_CONFIG
    assert step.resolve_unidyn_kernel(cfg, 14040) == "resident"
    assert step.resolve_unidyn_kernel(cfg, 14040, hooked=True) == "rowblock"
    assert step.resolve_unidyn_kernel(
        cfg.replace(pallas_kernel="resident"), 14040, hooked=True) == (
        "column")
    assert step.resolve_unidyn_kernel(cfg, 300000, hooked=True) == "column"
