"""The unidyn kernels' lane schedule (csrc/sph_unidyn.cu) on the CPU.

The kernels give each cell-sorted home row L lanes of one warp.  Every
lane walks the row's 9 runs; the t-th walked slot (every slot of the
walked cells, pair or not, sub-binned and capped as the pass is) goes to
lane t mod L, each lane sums its pairs in its slot order, a shuffle
butterfly at offsets L/2, ..., 1 combines the lanes, and the merge
partner is the least (distance, sorted row) over the lanes.
``forces.unidyn_lane_pass`` emulates that in plain torch over the plain
version's terms of a pair (``_unidyn_a_chunk``, ``_unidyn_b_chunk``);
the GPU tests hold the kernels against it on the card.

Here the emulation is held:
* against the plain version (``forces.unidyn_pair_pass``) at 1e-5 *
  max|plain| per output column, pair counts and merge partners equal,
  at L = 1, 4, 8, 32 on the inputs of tests/torch_unidyn_inputs.py
  (the cut tank, a blob with rows outside the domain and dead rows,
  sub-binned and not, with merging, a drift fix and column caps that cut
  rows, and a lattice whose rows have several nearest partners);
* against a transcription of the kernels' cell-by-cell walk (the slots
  of each lane, exactly), and against that walk's lane sums and
  butterfly computed row by row (bit for bit);
* once against the JAX package's interpret-mode
  ``unidyn_forces_resident`` on a small blob, at the tolerances of
  tests/test_torch_unidyn.py.
"""

import functools
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_unidyn import (CFG, JCFG, PAIR_FIELDS, _both,
                                     _force_close, _mixed, jax_resident)
from torch_unidyn_inputs import NAMES, held, unidyn_input
from tpufluids_torch import binning, forces, sph_kernels

LANES = (1, 4, 8, 32)
TOL = 1e-5


@pytest.fixture(autouse=True)
def share_of_the_cores():
    """The emulation runs thousands of small torch ops: under several
    test workers (pytest-xdist) each worker's intra-op threads would
    contend for the cores on every one of them, so each takes its share
    of the threads."""
    threads = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, threads // workers))
    yield
    torch.set_num_threads(threads)


@functools.cache
def _case(name):
    """(state, cfg, threshold, caps, fix, bt, plain result) of input
    ``name``."""
    st, cfg, threshold, caps, fix = unidyn_input(name, "cpu")
    _, bt = binning.sort_tables(st, cfg)
    plain = forces.unidyn_pair_pass(st, bt, cfg, threshold, fix, caps)
    return st, cfg, threshold, caps, fix, bt, plain


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("name", NAMES)
def test_lane_pass_matches_plain(name, lanes):
    st, cfg, threshold, caps, fix, bt, plain = _case(name)
    got = forces.unidyn_lane_pass(st, bt, cfg, lanes, threshold, fix, caps)
    held(got, plain, PAIR_FIELDS, TOL)
    assert torch.equal(got["has_pair"], plain["has_pair"])
    assert torch.equal(got["merge_partner"], plain["merge_partner"])
    assert bool((plain["merge_partner"] >= 0).any()) == (cfg.merge_dist > 0)
    if caps is not None:
        assert int(binning.column_overflow(bt, cfg, caps[0])) > 0


@functools.cache
def _kernel_walk(name, lanes):
    """(S, 4) int64 (row, j, lane, q) of every slot the kernels walk,
    transcribed from their loop as it walks cell by cell: a row of cell
    c, rank below the home cap, over the 9 (dx, dy) runs and the cells
    z-1..z+1 of each (sub-binned: offsets {0, dir} per axis), capped at
    w_cap rows of each neighbour column; slot t to lane t mod lanes."""
    _, cfg, threshold, caps, _, bt, _ = _case(name)
    g = cfg.grid_size
    cs, cid = bt.cell_start.tolist(), bt.cid.tolist()
    octs = bt.octant.tolist()
    out = []
    for i, c in enumerate(cid):
        if c >= g ** 3 or (caps and i - cs[c - c % g] >= caps[0]):
            continue
        cz, cy, cx = c % g, (c // g) % g, c // (g * g)
        sub = threshold is not None and cs[c + 1] - cs[c] > threshold
        o = octs[i]
        dirs = (1 if o & 1 else -1, 1 if o & 2 else -1, -1 if o & 4 else 1)

        def near(v, d, a):
            return 0 <= v < g and not (sub and d not in (0, dirs[a]))

        t = 0
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                if not (near(cx + dx, dx, 0) and near(cy + dy, dy, 1)):
                    continue
                base = ((cx + dx) * g + cy + dy) * g
                for dz in (-1, 0, 1):
                    if not near(cz + dz, dz, 2):
                        continue
                    end = cs[base + cz + dz + 1]
                    if caps:
                        end = min(end, cs[base] + caps[1])
                    for j in range(cs[base + cz + dz], end):
                        out.append((i, j, t % lanes, t // lanes))
                        t += 1
    return torch.tensor(out, dtype=torch.int64).reshape(-1, 4)


@pytest.mark.parametrize("lanes", (4, 32))
@pytest.mark.parametrize("name", ("tank", "blob-full", "capped", "lattice"))
def test_lane_slots_are_the_kernel_walk(name, lanes):
    st, cfg, threshold, caps, _, bt, _ = _case(name)
    got = torch.stack(forces.lane_slots(bt, cfg, lanes, threshold, caps), 1)
    want = _kernel_walk(name, lanes)
    assert torch.equal(got, want)
    # a row's slots spread over all its lanes, pairs or not
    assert int(torch.bincount(want[:, 0]).max()) > lanes


def _butterfly(v):
    """The shuffle butterfly on a list of per-lane values: lane l adds
    lane l ^ off, for off = L/2, ..., 1; lane 0's value."""
    off = len(v) // 2
    while off:
        v = [v[lane] + v[lane ^ off] for lane in range(len(v))]
        off //= 2
    return v[0]


@pytest.mark.parametrize("lanes", (4, 32))
@pytest.mark.parametrize("name", ("tank", "blob-fix", "capped", "lattice"))
def test_lane_sums_follow_the_kernel_walk_bitwise(name, lanes):
    """Row by row, on every 7th walking row and the longest walk: each
    lane's slots of the transcribed walk, their pair terms added one by
    one, the butterfly, and the partner search equal the emulation's
    sums and partners bit for bit."""
    st, cfg, threshold, caps, fix, bt, _ = _case(name)
    out_a, out_b, partner, sdv, fdv = forces.lane_sums(
        st, bt, cfg, lanes, threshold, fix, caps)
    walk = _kernel_walk(name, lanes)
    order, n = bt.order, st.capacity
    rows = forces.pack_unidyn_rows(st, order, bt.in_dom, cfg)
    hx = torch.cat([st.delpress, st.stress.reshape(n, 9)], dim=1)[order]
    drift = torch.cat([sdv, fdv], dim=1)[order]
    longest = int(torch.bincount(walk[:, 0]).argmax())
    homes = set(torch.unique(walk[:, 0])[::7].tolist()) | {longest}
    walk = walk[torch.isin(walk[:, 0], torch.tensor(sorted(homes)))]
    i, j = walk[:, 0], walk[:, 1]
    one = torch.ones((len(j), 1), dtype=torch.bool)
    ta, best = forces._unidyn_a_chunk(rows[i], hx[i], rows[j][:, None], one,
                                      cfg)
    tb = forces._unidyn_b_chunk(rows[i], drift[i], rows[j][:, None],
                                drift[j][:, None], one, cfg)
    r = rows[i, :3] - rows[j, :3]
    ds = torch.sqrt(r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1] + r[:, 2] * r[:, 2])
    ta, tb, ds = ta.numpy(), tb.numpy(), ds.tolist()
    elig = (best == 0).tolist()
    sums = {h: [[np.zeros(forces.A_COLS, np.float32),
                 np.zeros(forces.B_COLS, np.float32), float("inf"), n]
                for _ in range(lanes)] for h in homes}
    for s, (h, c, lane, _) in enumerate(walk.tolist()):  # by row, then t
        acc = sums[h][lane]
        acc[0] = acc[0] + ta[s]
        acc[1] = acc[1] + tb[s]
        if elig[s] and ds[s] < acc[2]:
            acc[2], acc[3] = ds[s], c
    for h, lanes_of in sums.items():
        assert np.array_equal(_butterfly([x[0] for x in lanes_of]),
                              out_a[h].numpy()), h
        assert np.array_equal(_butterfly([x[1] for x in lanes_of]),
                              out_b[h].numpy()), h
        assert int(partner[h]) == min((x[2], x[3]) for x in lanes_of)[1], h


def test_lane_pass_matches_jax_interpret():
    """The emulation at the kernels' lanes against the JAX package's
    resident Pallas kernel, in interpret mode, on a mixed blob with
    sub-binning and merging."""
    jcfg, tcfg = JCFG.replace(merge_dist=0.03), CFG.replace(merge_dist=0.03)
    jst, tst = _both(_mixed(140, 3, 0.5, capacity=160))
    from tpufluids import binning as jbinning
    jorder, jbt = jbinning.sort_tables(jst, jcfg)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_resident(jst, jbt, jcfg, order=jorder, subbin_threshold=6)
    _, bt = binning.sort_tables(tst, tcfg)
    got = forces.unidyn_lane_pass(tst, bt, tcfg, sph_kernels.UNIDYN_LANES, 6)
    alive = tst.alive.numpy()     # Pallas leaves NaN in the dead rows
    for f in PAIR_FIELDS:
        _force_close(got[f].numpy()[alive], np.asarray(ref[f])[alive], f)
    np.testing.assert_array_equal(got["has_pair"].numpy(),
                                  np.asarray(ref["has_pair"]))
    np.testing.assert_array_equal(got["merge_partner"].numpy(),
                                  np.asarray(ref["merge_partner"]))
    assert (got["merge_partner"] >= 0).any()


def test_lattice_ties_land_on_several_lanes():
    """The lattice input is a test of the partner order: most of its rows
    have several eligible partners at the least distance, on different
    lanes of the kernels' schedule."""
    st, cfg, threshold, _, _, bt, plain = _case("lattice")
    lanes = sph_kernels.UNIDYN_LANES
    row, j, lane, _ = forces.lane_slots(bt, cfg, lanes, threshold)
    rows = forces.pack_unidyn_rows(st, bt.order, bt.in_dom, cfg)
    r = rows[row, :3] - rows[j, :3]
    ds = torch.sqrt(r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1] + r[:, 2] * r[:, 2])
    ok = (ds > 0) & (ds <= cfg.merge_dist)
    least = torch.full((st.capacity,), float("inf")).scatter_reduce(
        0, row[ok], ds[ok], "amin")
    tie = ok & (ds == least[row])
    spread = torch.zeros((st.capacity, lanes), dtype=torch.bool)
    spread[row[tie], lane[tie]] = True
    assert int((spread.sum(1) > 1).sum()) > st.capacity // 2
    assert bool((plain["merge_partner"] >= 0).all())


def test_lanes_constant_is_the_kernels():
    """sph_kernels.UNIDYN_LANES is kLanes of csrc/sph_unidyn.cu, a power of
    two that divides a warp."""
    text = (Path(forces.__file__).parent / "csrc" /
            "sph_unidyn.cu").read_text()
    lanes = sph_kernels.UNIDYN_LANES
    assert f"constexpr int kLanes = {lanes};" in text
    assert 32 % lanes == 0 and lanes & (lanes - 1) == 0
