"""The port's SPH force kernels (row-block and column, fresh and stale)
against their plain PyTorch versions on the card, at the base_dam scene
and at 262144- and 524288-particle uniform fills, the identities between
them, the column and sort-cadence steps' launches, and run-to-run
determinism.  Marked ``gpu`` and skipped without a CUDA device; on the
card (tests/conftest.py sets up JAX, which these tests do not use):

    python -m pytest --noconftest -m gpu tests/test_torch_sph_gpu.py

Tolerance: 1e-5 * max|plain| for sum_w and each dpress component.  The
kernel is built with -fmad=false and follows the plain version's
operations per pair, but sums its candidates one by one where torch
reduces them in another order.  Against ``forces.base_lane_pass`` run
on the card, the emulation of the kernels' lane schedule (the same
pairs summed in the same order, each term formed in the kernel's order
and association): every column bit for bit, and within 1e-6 *
max|emulation|.  Overflow
counts, the pair counts of the stale window and the zeros of rows over
the column cap are exact, the pack kernel equals ``forces.pack_rows``
and ``forces.column_shift`` bit for bit, and so are the identities: the
column kernel equals the row-block kernel bit for bit when no column
overflows (fresh and stale), and on a just-sorted pool the stale pass
equals the fresh one."""

import numpy as np
import pytest
import torch

from torch_base_inputs import blob_state
from torch_base_inputs import sorted_and_moved as far_moved
from tpufluids_torch import (binning, config, forces, scenes, sph_kernels,
                             state, step)
from tpufluids_torch.config import BASE_CONFIG

pytestmark = pytest.mark.gpu

TOL = 1e-5
LANE_TOL = 1e-6
FILL = 262144
BIG_FILL = 524288


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randomised(st, seed):
    """dens, press and vel drawn from ``seed``: at a scene's first step
    press = 0 and dpress would be 0."""
    n = st.capacity
    rng = np.random.default_rng(seed)
    dev = st.pos.device

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    return st.replace(dens=t(rng.uniform(9300.0, 9900.0, n)),
                      press=t(rng.normal(0.0, 3e4, n)),
                      vel=t(rng.normal(0.0, 0.5, (n, 3))))


def _scene(name, dev):
    if name == "base_dam":
        return scenes.base_dam(BASE_CONFIG, device=dev)
    n = BIG_FILL if name == "fill-524k" else FILL
    pos = np.random.default_rng(0).uniform(-0.9, 0.9, (n, 3))
    return state.make_state(pos.astype(np.float32), cfg=BASE_CONFIG,
                            device=dev)


def _close(got, want):
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == w.shape and g.device == w.device
        for gc, wc in zip(g.reshape(g.shape[0], -1).T,
                          w.reshape(w.shape[0], -1).T):
            scale = float(wc.abs().max())
            assert scale > 0.0
            assert float((gc - wc).abs().max()) <= TOL * scale


def _sorted_and_moved(st, cfg, seed):
    """(the pool sorted into cell order, its tables, the pool moved by up
    to 0.4 of a cell): a stale step's inputs."""
    st, bt, _ = binning.sort_by_cell(st, cfg)
    rng = np.random.default_rng(seed)
    dev = st.pos.device
    shift = torch.from_numpy(rng.uniform(-0.02, 0.02, (st.capacity, 3))
                             .astype(np.float32)).to(dev)
    return st, bt, st.replace(pos=st.pos + shift)


@pytest.mark.parametrize("name,cap", [("base_dam", 32), ("fill-524k", None)])
@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "xy_cells"])
def test_column_kernel_matches_plain(cuda, name, cap, stale):
    """base_dam at cap 32 overflows; the fill at its suggest_col_cap
    (584) does not."""
    st = _randomised(_scene(name, cuda), 2)
    cfg = BASE_CONFIG.replace(pallas_col_cap=cap or binning.suggest_col_cap(
        st, BASE_CONFIG))
    sorted_st, bt, moved = _sorted_and_moved(st, cfg, 3)
    if stale:
        st = moved
    else:
        _, bt = binning.sort_tables(st, cfg)
    kern = sph_kernels.base_forces_column
    before = kern.launches
    got = kern(st, bt, cfg, bt.order, stale)
    again = kern(st, bt, cfg, bt.order, stale)
    want = sph_kernels.base_forces_column_plain(st, bt, cfg, bt.order, stale)
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    _close(got, want)
    assert int(got[2]) == int(want[2])
    assert (int(got[2]) > 0) == (cap == 32)
    b, _ = config.column_caps(cfg)
    cs = binning.column_start(bt, cfg)
    cid = bt.cid.long()
    g = cfg.grid_size
    rank = torch.arange(st.capacity, device=cuda) - cs[
        torch.clamp(cid // g, max=g * g - 1)]
    capped = bt.order[(cid < cfg.num_cells) & (rank >= b)]
    assert (capped.numel() > 0) == (cap == 32)
    assert not got[0][capped].any() and not got[1][capped].any()


@pytest.mark.parametrize("name", ["base_dam", "fill"])
def test_stale_rowblock_kernel_matches_plain(cuda, name):
    st = _randomised(_scene(name, cuda), 4)
    _, bt, moved = _sorted_and_moved(st, BASE_CONFIG, 5)
    kern = sph_kernels.base_forces_rowblock
    got = kern(moved, bt, BASE_CONFIG, bt.order, True)
    again = kern(moved, bt, BASE_CONFIG, bt.order, True)
    want = sph_kernels.base_forces_rowblock_plain(moved, bt, BASE_CONFIG,
                                                  bt.order, True)
    torch.cuda.synchronize()
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    _close(got, want)


def test_column_identities_are_bitwise(cuda):
    """On the fill: the column kernel equals the row-block kernel where no
    column overflows (fresh, and stale with caps above every column), and
    on a just-sorted pool its stale pass equals its fresh one."""
    st = _randomised(_scene("fill", cuda), 6)
    cap = binning.suggest_col_cap(st, BASE_CONFIG)
    cfg = BASE_CONFIG.replace(pallas_col_cap=cap)
    col, row = sph_kernels.base_forces_column, sph_kernels.base_forces_rowblock
    order, bt = binning.sort_tables(st, cfg)
    fresh = col(st, bt, cfg, order)
    assert int(fresh[2]) == 0
    for g, r in zip(fresh[:2], row(st, bt, cfg, order)[:2]):
        assert torch.equal(g, r)
    sorted_st, sbt, moved = _sorted_and_moved(st, cfg, 7)
    for g, r in zip(col(sorted_st, sbt, cfg, sbt.order, True)[:2],
                    col(sorted_st, sbt, cfg, sbt.order, False)[:2]):
        assert torch.equal(g, r)
    big = cfg.replace(pallas_col_cap=st.capacity)
    for g, r in zip(col(moved, sbt, big, sbt.order, True)[:2],
                    row(moved, sbt, cfg, sbt.order, True)[:2]):
        assert torch.equal(g, r)


@pytest.mark.parametrize("path", ["column", "sort_every"])
def test_column_and_cadence_steps_launch_once_a_step(cuda, path):
    """base_dam through the column family (pallas_kernel="column"), and
    through the sort cadence at sort_every 8: one force launch a step,
    one sort step in 8."""
    cfg = BASE_CONFIG.replace(**({"pallas_kernel": "column"}
                                 if path == "column" else {"sort_every": 8}))
    kernel = ("base_forces_column" if path == "column"
              else "base_forces_rowblock")
    sph_kernels.reset_launches()
    step.sph_sort_step.calls = 0
    st, m = step.run_python(_scene("base_dam", cuda), cfg, 20)
    assert sph_kernels.launch_counts(kernel) == {kernel: 20}
    assert sum(sph_kernels.launch_counts().values()) == 20
    assert step.sph_sort_step.calls == (3 if path == "sort_every" else 0)
    assert int(m.n_alive) == 8000 and int(m.bin_overflow) == 0
    assert bool(torch.isfinite(st.pos).all())


@pytest.mark.parametrize("name", ["base_dam", "fill"])
def test_kernel_matches_plain_and_is_deterministic(cuda, name):
    st = _randomised(_scene(name, cuda), 1)
    order, bt = binning.sort_tables(st, BASE_CONFIG)
    before = sph_kernels.base_forces_rowblock.launches
    got = sph_kernels.base_forces_rowblock(st, bt, BASE_CONFIG, order)
    again = sph_kernels.base_forces_rowblock(st, bt, BASE_CONFIG, order)
    want = sph_kernels.base_forces_rowblock_plain(st, bt, BASE_CONFIG, order)
    torch.cuda.synchronize()
    assert sph_kernels.base_forces_rowblock.launches == before + 2
    for g, a, w in zip(got[:2], again[:2], want[:2]):
        assert g.shape == w.shape and g.device == w.device
        assert torch.equal(g, a)
        cols = w.reshape(w.shape[0], -1).T
        for gc, wc in zip(g.reshape(g.shape[0], -1).T, cols):
            scale = float(wc.abs().max())
            assert scale > 0.0
            assert float((gc - wc).abs().max()) <= TOL * scale
    assert int(got[2]) == 0


def test_fill_steps_are_bitwise_repeatable(cuda):
    runs = []
    for _ in range(2):
        sph_kernels.reset_launches()
        st, m = step.run_python(_scene("fill", cuda), BASE_CONFIG, 3)
        runs.append(st)
        assert sph_kernels.launch_counts("base_forces_rowblock") == {
            "base_forces_rowblock": 3}
        assert int(m.n_alive) == FILL and int(m.bin_overflow) == 0
    for f in ("pos", "vel", "acc", "dens", "press", "delpress"):
        assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), f
        assert bool(torch.isfinite(getattr(runs[0], f)).all()), f


def _lane_close(got, want):
    """Each output column within LANE_TOL of max|want| and equal to it bit
    for bit; returns the number of columns equal bit for bit."""
    same = 0
    for g, w in zip(got[:2], want[:2]):
        for gc, wc in zip(g.reshape(g.shape[0], -1).T,
                          w.reshape(w.shape[0], -1).T):
            scale = float(wc.abs().max())
            assert scale > 0.0
            assert float((gc - wc).abs().max()) <= LANE_TOL * scale
            assert torch.equal(gc, wc)
            same += 1
    return same


def _lane_case(name, dev, capped, stale):
    """(pool, tables, cfg, caps) of a base_dam (cap 32, overflowing), fill
    (its suggest_col_cap) or blob (cap 10) input; stale: the sorted pool
    moved since, by 0.4 of a cell, the blob ``far`` (several cells, a
    fast row, homes out of the domain, an infinite and a NaN row)."""
    if name == "blob":
        st = blob_state(dev)
        cfg = BASE_CONFIG.replace(pallas_col_cap=10, pallas_w_chunk=0)
    else:
        st = _randomised(_scene(name, dev), 8)
        cfg = BASE_CONFIG.replace(pallas_col_cap=32 if name == "base_dam"
                                  else binning.suggest_col_cap(st,
                                                               BASE_CONFIG))
    if not capped:
        cfg = BASE_CONFIG
    if stale:
        _, bt, st = far_moved(st, cfg, 9, far=name == "blob")
    else:
        _, bt = binning.sort_tables(st, cfg)
    return st, bt, cfg, config.column_caps(cfg) if capped else None


@pytest.mark.parametrize("capped", [False, True], ids=["rowblock", "column"])
@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("name", ["base_dam", "fill", "blob"])
def test_kernels_match_lane_emulation(cuda, name, stale, capped):
    """The four instances against forces.base_lane_pass on the card at
    sph_kernels.BASE_LANES (bit for bit, and 1e-6 of max) and against
    the plain version (1e-5 of max)."""
    st, bt, cfg, caps = _lane_case(name, cuda, capped, stale)
    kern, plain = ((sph_kernels.base_forces_column,
                    sph_kernels.base_forces_column_plain) if capped else
                   (sph_kernels.base_forces_rowblock,
                    sph_kernels.base_forces_rowblock_plain))
    got = kern(st, bt, cfg, bt.order, stale)
    lanes = sph_kernels.base_info(torch.cuda.current_device())["lanes"]
    assert lanes == sph_kernels.BASE_LANES
    want = forces.base_lane_pass(st, bt, cfg, lanes, caps, stale)
    torch.cuda.synchronize()
    same = _lane_close(got, want)
    print(f"{name}, {'column' if capped else 'rowblock'}, "
          f"{'stale' if stale else 'fresh'}: {same} of 4 columns bit for "
          f"bit with the lane emulation")
    _close(got, plain(st, bt, cfg, bt.order, stale))


def test_far_stale_window_keeps_the_whole_columns_pairs(cuda):
    """The fill moved far (a tenth of its rows by 2-4 cells in z, a fast
    row, homes out of the domain, an infinite and a NaN row): the window
    walk's pairs are the whole-column walk's (chip_smoke.pair_count),
    in fewer slots, and the kernel agrees with the emulation and the
    plain version."""
    import chip_smoke
    st = _randomised(_scene("fill", cuda), 10)
    _, bt, moved = far_moved(st, BASE_CONFIG, 11, far=True)
    rows = forces.pack_rows(moved, bt.order, bt.in_dom)
    shift = forces.column_shift(rows, bt, BASE_CONFIG)
    assert int(shift.max()) >= BASE_CONFIG.grid_size
    assert int(((shift > 1) & (shift < BASE_CONFIG.grid_size)).sum()) > 100
    got = sph_kernels.base_forces_rowblock(moved, bt, BASE_CONFIG, bt.order,
                                           True)
    want = forces.base_lane_pass(moved, bt, BASE_CONFIG,
                                 sph_kernels.BASE_LANES, stale=True)
    _lane_close(got, want)
    _close(got, sph_kernels.base_forces_rowblock_plain(
        moved, bt, BASE_CONFIG, bt.order, True))
    sph = type("Sph", (), dict(forces=forces, binning=binning))
    whole = chip_smoke.pair_count(sph, moved, bt, BASE_CONFIG, stale=True)
    assert int(want[2]) == whole > 0
    cz = binning.cell_trunc(rows[:, 0:3], BASE_CONFIG)[:, 2]
    walked = binning.run_table(bt, BASE_CONFIG, window=(cz, shift))[1]
    assert int(walked.sum()) < int(binning.run_table(
        bt, BASE_CONFIG, whole=True)[1].sum())


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("name", ["base_dam", "blob"])
def test_pack_kernel_is_the_plain_pack(cuda, name, stale):
    """sph_kernels.base_pack on the card equals forces.pack_rows and, stale,
    binning.cell_trunc and forces.column_shift, bit for bit (the far
    blob's NaN row is NaN in both: bit patterns are compared)."""
    st, bt, cfg, _ = _lane_case(name, cuda, False, stale)
    rows, cells, shift = sph_kernels.base_pack(st, bt, cfg, bt.order, stale)
    want = forces.pack_rows(st, bt.order, bt.in_dom)
    torch.cuda.synchronize()
    assert torch.equal(rows.view(torch.int32), want.view(torch.int32))
    if stale:
        now = binning.cell_trunc(want[:, 0:3], cfg)
        assert torch.equal(cells[:, 0:3].view(torch.int32),
                           now.view(torch.int32))
        assert not cells[:, 3].any()
        assert torch.equal(shift, forces.column_shift(want, bt, cfg))
        assert int(shift.max()) > 0
    else:
        assert cells is None and shift is None
