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
torch reduces them in another order.

The kernels are also held against ``forces.unidyn_lane_pass`` run on the
card, the emulation of their lane schedule (UNIDYN_LANES lanes a home row,
a fixed shuffle butterfly), every column bit for bit and within 1e-6 *
max|emulation|: both sum the same pairs in the same order, each term
formed in the kernels' order and association.  Merge partners and pair
counts are exact.  These print how many columns are bit for bit (run
with -s)."""

import numpy as np
import pytest
import torch

from torch_unidyn_inputs import (NAMES, blob_positions, drift_fix,
                                       held, unidyn_input)
from tpufluids_torch import binning, forces, scenes, sph_kernels, state, step
from tpufluids_torch.config import UNIDYN_CONFIG, column_caps

pytestmark = pytest.mark.gpu

TOL = 1e-5
LANE_TOL = 1e-6
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


# --- against the emulation of the lane schedule -----------------------------


def _against_lanes(st, cfg, threshold=6, caps=None, fix=None, what=""):
    """Each wrapper that takes the input (column: with ``caps``; else
    resident, and row-block with ``fix``) against forces.unidyn_lane_pass
    on the card; returns the wrappers' results."""
    order, bt = binning.sort_tables(st, cfg)
    lanes = sph_kernels.unidyn_info(st.pos.device.index or 0)["lanes"]
    assert lanes == sph_kernels.UNIDYN_LANES
    want = forces.unidyn_lane_pass(st, bt, cfg, lanes, threshold, fix, caps)
    if caps is not None:
        calls = {"column": lambda: sph_kernels.unidyn_forces_column(
            st, bt, cfg, order, subbin_threshold=threshold)}
    else:
        calls = {"resident": lambda: sph_kernels.unidyn_forces_resident(
            st, bt, cfg, order, subbin_threshold=threshold),
                 "rowblock": lambda: sph_kernels.unidyn_forces_rowblock(
            st, bt, cfg, order, drift_fix=fix, subbin_threshold=threshold)}
        if fix is not None:
            del calls["resident"]
    results = {}
    for name, call in calls.items():
        got = call()
        torch.cuda.synchronize()
        worst, same, cols = held(got, want, FIELDS, LANE_TOL)
        print(f"{what} {name}: {same} of {cols} columns bit for bit with "
              f"the lane emulation, worst {worst:.3e} of max")
        assert same == cols
        assert torch.equal(got["has_pair"], want["has_pair"])
        assert torch.equal(got["merge_partner"], want["merge_partner"])
        results[name] = got
    return results


@pytest.mark.parametrize("name", NAMES)
def test_kernels_match_lane_emulation(cuda, name):
    st, cfg, threshold, caps, fix = unidyn_input(name, cuda)
    _against_lanes(st, cfg, threshold, caps, fix, name)


@pytest.mark.parametrize("name,cap", [("tank", None), ("tank", 128),
                                      ("fill", None), ("fill", 64)])
def test_kernels_match_lane_emulation_at_size(cuda, name, cap):
    """The mixed tank (sub-binned, no merging) and the mixed 46656 fill
    (merging on), and the column family at the tank's cap and at a cap
    over which the fill's columns run; the row-block wrapper with a
    drift fix."""
    merge = 0.03 if name == "fill" else -10.0
    cfg = UNIDYN_CONFIG.replace(merge_dist=merge)
    st = scenes.mixed_phase(_scene(name, cuda), 1)
    if cap is None:
        _against_lanes(st, cfg, what=name)
        _against_lanes(st, cfg, fix=drift_fix, what=f"{name}, drift fix")
    else:
        cfg = cfg.replace(pallas_col_cap=cap)
        _against_lanes(st, cfg, caps=column_caps(cfg),
                       what=f"{name}, cap {cap}")


def test_full_home_cell(cuda):
    """A blob of 4000 particles in a 0.24 cube: its cells hold 250 rows
    and more, so a row walks several hundred slots sub-binned and over a
    thousand on the full stencil."""
    cfg = UNIDYN_CONFIG.replace(merge_dist=0.03)
    pos = np.random.default_rng(11).uniform(-0.12, 0.12, (4000, 3))
    st = scenes.mixed_phase(state.make_state(pos, cfg=cfg, device=cuda), 3)
    _, bt = binning.sort_tables(st, cfg)
    assert int(bt.home_count.max()) >= 224
    for threshold in (6, None):
        row = forces.lane_slots(bt, cfg, sph_kernels.UNIDYN_LANES,
                                threshold)[0]
        assert int(torch.bincount(row).max()) >= 224
        _against_lanes(st, cfg, threshold, what=f"full cells, {threshold}")


@pytest.mark.parametrize("n", [1, 2, 31, 33, 1001])
def test_pool_not_a_multiple_of_the_block(cuda, n):
    """Pools of n rows, so that the last block holds rows past n (and n
    = 1, a single row with no pair): they write nothing, and the rows
    below n are right."""
    cfg = UNIDYN_CONFIG.replace(merge_dist=0.03)
    pos = blob_positions(seed=n)[:n]
    st = scenes.mixed_phase(state.make_state(pos, cfg=cfg, device=cuda), 5)
    order, bt = binning.sort_tables(st, cfg)
    got = sph_kernels.unidyn_forces_resident(st, bt, cfg, order,
                                             subbin_threshold=6)
    want = forces.unidyn_lane_pass(st, bt, cfg, sph_kernels.UNIDYN_LANES, 6)
    torch.cuda.synchronize()
    for k in FIELDS:
        g, w = got[k], want[k]
        assert g.shape == w.shape, k
        ok = torch.isfinite(w)
        assert torch.equal(ok, torch.isfinite(g)), k
        scale = max(float(w[ok].abs().max()) if ok.any() else 0.0, 1e-30)
        assert float((g[ok] - w[ok]).abs().max()) <= (
            LANE_TOL * scale), k
    assert torch.equal(got["has_pair"], want["has_pair"])
    assert torch.equal(got["merge_partner"], want["merge_partner"])
    if n == 1:
        assert not bool(got["has_pair"].any())
        assert int(got["merge_partner"][0]) == -1


def test_rows_out_of_the_domain_get_zeros(cuda):
    """The blob's rows beyond the domain's faces and its dead rows get
    zero sums and no partner; they are candidates of no row."""
    st, cfg, threshold, caps, fix = unidyn_input("blob", cuda)
    order, bt = binning.sort_tables(st, cfg)
    got = _against_lanes(st, cfg, threshold, what="blob")["resident"]
    out = ~(bt.in_dom[torch.argsort(order)])     # pool order
    assert int(out.sum()) >= 24 + 32
    for k in ("sum_w", "dpress", "diffusion", "solid_drift", "fluid_drift",
              "mixture_accel", "delsolid", "delfluid"):
        assert not bool(got[k][out].any()), k
    assert not bool(got["has_pair"][out].any())
    assert bool((got["merge_partner"][out] == -1).all())
