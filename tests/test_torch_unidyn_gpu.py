"""The port's unidyn force kernels (resident, row-block and column)
against their plain PyTorch versions on the card, and their run-to-run
determinism.  Marked ``gpu`` and skipped
without a CUDA device; on the card (tests/conftest.py sets up JAX, which
these tests do not use):

    python -m pytest --noconftest -m gpu tests/test_torch_unidyn_gpu.py

Inputs are mixed-phase (solid in (0, 1) with some pure rows, fluid =
1 - solid, seeded stress, delpress, vel, dens and press): on the
reference's own tank the drift, velocity gradient, stress acceleration
and mixture terms are exactly 0.  Tolerance: 1e-5 * max|plain| per output
column.  The kernels are built with -fmad=false and follow the plain
version's operations per pair, but sum their candidates one by one where
torch reduces them in another order."""

import numpy as np
import pytest
import torch

from tpufluids_torch import binning, scenes, sph_kernels, state, step
from tpufluids_torch.config import UNIDYN_CONFIG

pytestmark = pytest.mark.gpu

TOL = 1e-5
FIELDS = ("sum_w", "dpress", "diffusion", "vel_grad", "stress_accel",
          "solid_drift", "fluid_drift", "mixture_accel", "delsolid",
          "delfluid")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(name, dev):
    if name == "tank":
        return scenes.unidyn_tank(UNIDYN_CONFIG, device=dev)
    pos = np.random.default_rng(0).uniform(-0.9, 0.9, (46656, 3))
    return state.make_state(pos.astype(np.float32), cfg=UNIDYN_CONFIG,
                            device=dev)


def _columns(r):
    return [c for k in FIELDS for c in r[k].reshape(r[k].shape[0], -1).T]


@pytest.mark.parametrize("name,merge", [("tank", False), ("fill", True)])
def test_kernels_match_plain_and_repeat(cuda, name, merge):
    cfg = UNIDYN_CONFIG.replace(merge_dist=0.03 if merge else -10.0)
    st = scenes.mixed_phase(_scene(name, cuda), 1)
    order, bt = binning.sort_tables(st, cfg)

    def fix(s, f):
        return s * 0.5, f * 2.0

    for kern, plain, kw in (
            (sph_kernels.unidyn_forces_resident,
             sph_kernels.unidyn_forces_resident_plain, {}),
            (sph_kernels.unidyn_forces_rowblock,
             sph_kernels.unidyn_forces_rowblock_plain, {}),
            (sph_kernels.unidyn_forces_rowblock,
             sph_kernels.unidyn_forces_rowblock_plain, {"drift_fix": fix})):
        before = kern.launches
        got = kern(st, bt, cfg, order, subbin_threshold=6, **kw)
        again = kern(st, bt, cfg, order, subbin_threshold=6, **kw)
        want = plain(st, bt, cfg, order, subbin_threshold=6, **kw)
        torch.cuda.synchronize()
        assert kern.launches == before + 2
        for k in (*FIELDS, "has_pair", "merge_partner"):
            assert torch.equal(got[k], again[k]), k
        for gc, wc in zip(_columns(got), _columns(want)):
            scale = float(wc.abs().max())
            assert scale > 0.0
            assert float((gc - wc).abs().max()) <= TOL * scale
        assert torch.equal(got["has_pair"], want["has_pair"])
        assert torch.equal(got["merge_partner"], want["merge_partner"])
        assert bool((got["merge_partner"] >= 0).any()) == merge


@pytest.mark.parametrize("name,cap,merge", [("tank", 128, False),
                                            ("fill", 64, True)])
def test_column_kernels_match_plain_and_repeat(cuda, name, cap, merge):
    """The mixed tank at UNIDYN_CONFIG's cap (128, no column over it) and
    the mixed fill at cap 64, over which its columns run: the overflow
    count and the rows over the cap (zeros, no partner) are exact."""
    cfg = UNIDYN_CONFIG.replace(merge_dist=0.03 if merge else -10.0,
                                pallas_col_cap=cap)
    st = scenes.mixed_phase(_scene(name, cuda), 1)
    order, bt = binning.sort_tables(st, cfg)
    kern = sph_kernels.unidyn_forces_column
    before = kern.launches
    got = kern(st, bt, cfg, order, subbin_threshold=6)
    again = kern(st, bt, cfg, order, subbin_threshold=6)
    want = sph_kernels.unidyn_forces_column_plain(st, bt, cfg, order,
                                                  subbin_threshold=6)
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    for k in (*FIELDS, "has_pair", "merge_partner", "overflow"):
        assert torch.equal(got[k], again[k]), k
    for gc, wc in zip(_columns(got), _columns(want)):
        scale = float(wc.abs().max())
        assert scale > 0.0
        assert float((gc - wc).abs().max()) <= TOL * scale
    assert torch.equal(got["has_pair"], want["has_pair"])
    assert torch.equal(got["merge_partner"], want["merge_partner"])
    assert bool((got["merge_partner"] >= 0).any()) == merge
    assert int(got["overflow"]) == int(want["overflow"])
    assert (int(got["overflow"]) > 0) == (name == "fill")
    cs = binning.column_start(bt, cfg)
    cid = bt.cid.long()
    g = cfg.grid_size
    rank = torch.arange(st.capacity, device=cuda) - cs[
        torch.clamp(cid // g, max=g * g - 1)]
    capped = order[(cid < cfg.num_cells) & (rank >= cap)]
    assert (capped.numel() > 0) == (name == "fill")
    for k in FIELDS:
        assert not got[k][capped].any(), k
    assert not bool((got["merge_partner"][capped] >= 0).any())


def test_column_steps_equal_resident_steps(cuda):
    """No column of the tank is over the cap for 5 steps, so the column
    kernels sum the resident kernels' pairs in their order: bit for bit."""
    runs = []
    for kernel in ("column", "resident"):
        sph_kernels.reset_launches()
        st, m = step.run_python(_scene("tank", cuda),
                                UNIDYN_CONFIG.replace(pallas_kernel=kernel), 5)
        assert sph_kernels.launch_counts(f"unidyn_forces_{kernel}") == {
            f"unidyn_forces_{kernel}": 5}
        assert int(m.n_alive) == 14040 and int(m.bin_overflow) == 0
        runs.append(st)
    for f in state.FIELDS:
        assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), f


def test_rowblock_and_resident_steps_are_bitwise_equal(cuda):
    cfg = UNIDYN_CONFIG
    runs = []
    for kernel in ("resident", "rowblock", "resident"):
        sph_kernels.reset_launches()
        st, m = step.run_python(_scene("tank", cuda),
                                cfg.replace(pallas_kernel=kernel), 5)
        counts = sph_kernels.launch_counts(f"unidyn_forces_{kernel}")
        assert counts == {f"unidyn_forces_{kernel}": 5}
        assert int(m.n_alive) == 14040 and int(m.bin_overflow) == 0
        runs.append(st)
    for f in state.FIELDS:
        assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), f
        assert torch.equal(getattr(runs[0], f), getattr(runs[2], f)), f
