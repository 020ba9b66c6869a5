"""The base force kernels' lane schedule and stale window
(csrc/sph_forces.cu) on the CPU.

The kernels give each cell-sorted home row L lanes of one warp.  Every
lane walks the row's 9 runs; the t-th walked slot (pair or not) goes to
lane t mod L, each lane sums its pairs in its slot order, and a shuffle
butterfly at offsets L/2, ..., 1 joins the lanes.  Stale, a run is not
the whole neighbour column but the cells within 1 + d of the home row's
current z-cell, d the column's largest z-cell shift
(``forces.column_shift``, ``binning.stale_window``).
``forces.base_lane_pass`` emulates that in plain torch over the plain
version's terms of a pair (``forces._chunk_sums``); the GPU tests hold
the kernels against it on the card.

Here, on the inputs of tests/torch_base_inputs.py (a blob with rows
outside the domain and dead rows; stale, moved by 0.4 of a cell, or
``far``: several cells in z, one fast row, homes that left the domain,
an infinite and a NaN row), fresh and stale, capped and not:
* the emulation against the plain version (``base_forces_*_plain``) at
  L = 1, 4, 8, 16, 32, within 1e-5 * max|plain| per output column;
* at L = 1 the windowed stale walk against the whole-column walk, bit
  for bit and with the same pair count, walking fewer slots; and on a
  just-sorted pool the stale walk's slots and sums against the fresh
  walk's, exactly;
* ``forces.column_shift`` against a direct loop, and the lane slots
  against a transcription of the kernels' walk, exactly;
* the emulation at ``BASE_LANES`` against the JAX package's
  interpret-mode ``base_forces_rowblock`` and ``base_forces_pallas``,
  fresh, on in-domain blobs, at the tolerances of tests/test_torch_sph.py
  and tests/test_torch_column.py.
"""

import dataclasses
import functools
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_unidyn_lanes import share_of_the_cores  # noqa: F401
from torch_base_inputs import blob_state, sorted_and_moved
from tpufluids import binning as jbinning
from tpufluids import config as jconfig
from tpufluids import scenes as jscenes
from tpufluids import state as jstate
from tpufluids.oracle import state_to_dict
from tpufluids.sph_pallas import base_forces_pallas
from tpufluids.sph_pallas import base_forces_rowblock as jax_rowblock
from tpufluids_torch import binning, config, convert, forces, sph_kernels
from tpufluids_torch.config import BASE_CONFIG

LANES = (1, 4, 8, 16, 32)
TOL = 1e-5
# a cap of 10 rows a column, for the home rows and the candidates alike:
# the blob's columns run over it
CAPPED = BASE_CONFIG.replace(pallas_col_cap=10, pallas_w_chunk=0)
NAMES = ("fresh", "capped", "stale", "stale-capped", "far", "far-capped")
STALE = NAMES[2:]


@functools.cache
def _case(name):
    """(pool, tables, cfg, caps, stale) of input ``name``."""
    cfg = CAPPED if name.endswith("capped") else BASE_CONFIG
    caps = config.column_caps(cfg) if name.endswith("capped") else None
    st = blob_state("cpu")
    if name in STALE:
        _, bt, st = sorted_and_moved(st, cfg, 5, far=name.startswith("far"))
    else:
        _, bt = binning.sort_tables(st, cfg)
    return st, bt, cfg, caps, name in STALE


@functools.cache
def _plain(name):
    st, bt, cfg, _, stale = _case(name)
    fn = (sph_kernels.base_forces_column_plain if name.endswith("capped")
          else sph_kernels.base_forces_rowblock_plain)
    return fn(st, bt, cfg, bt.order, stale)


def _windowed(name):
    """(rows, current cells, shift, windowed runs) of stale input
    ``name``: the kernels' walk."""
    st, bt, cfg, caps, _ = _case(name)
    rows = forces.pack_rows(st, bt.order, bt.in_dom)
    cells = binning.cell_trunc(rows[:, 0:3], cfg)
    shift = forces.column_shift(rows, bt, cfg)
    return rows, cells, shift, binning.run_table(
        bt, cfg, caps, window=(cells[:, 2], shift))


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("name", NAMES)
def test_lane_pass_matches_plain(name, lanes):
    st, bt, cfg, caps, stale = _case(name)
    want = _plain(name)
    got = forces.base_lane_pass(st, bt, cfg, lanes, caps, stale)
    for g, w in zip(got[:2], want[:2]):
        for gc, wc in zip(g.reshape(g.shape[0], -1).T,
                          w.reshape(w.shape[0], -1).T):
            scale = float(wc.abs().max())
            assert scale > 0.0
            assert float((gc - wc).abs().max()) <= TOL * scale
    assert int(got[2]) > 0
    if caps is not None:
        assert int(want[2]) > 0 and int(
            binning.column_start(bt, cfg).diff().max()) > caps[1]


@pytest.mark.parametrize("name", STALE)
def test_window_equals_whole_columns_bitwise(name):
    """At one lane the window walks every pair of the whole columns in
    the same order, so its sums are the same bits; it walks fewer
    slots, and the far input needs shifts beyond one cell."""
    st, bt, cfg, caps, _ = _case(name)
    rows, cells, shift, runs = _windowed(name)
    whole = binning.run_table(bt, cfg, caps, whole=True)
    got, pairs = forces.base_lane_sums(rows, bt, cfg, 1, runs, cells)
    want, want_pairs = forces.base_lane_sums(rows, bt, cfg, 1, whole, cells)
    assert torch.equal(got, want)
    assert int(pairs) == int(want_pairs) > 0
    assert int(runs[1].sum()) < int(whole[1].sum())
    d = int(shift.max())
    assert (d >= cfg.grid_size) == name.startswith("far")
    if name.startswith("far"):
        assert int((shift > 1).sum()) > 20
        assert int(((shift > 1) & (shift < cfg.grid_size)).sum()) > 10


@pytest.mark.parametrize("lanes", (4, 32))
@pytest.mark.parametrize("capped", (False, True), ids=["rowblock", "column"])
def test_just_sorted_stale_walk_is_the_fresh_walk(capped, lanes):
    """On a pool just sorted (shift 0 everywhere) the stale window is the
    fresh walk's cells: the same slots on the same lanes, the same sums
    bit for bit (the kernels' stale = fresh identity)."""
    cfg = CAPPED if capped else BASE_CONFIG
    caps = config.column_caps(cfg) if capped else None
    st, bt, _ = sorted_and_moved(blob_state("cpu"), cfg, 5)
    rows = forces.pack_rows(st, bt.order, bt.in_dom)
    assert not forces.column_shift(rows, bt, cfg).any()
    fresh = forces.base_lane_pass(st, bt, cfg, lanes, caps)
    stale = forces.base_lane_pass(st, bt, cfg, lanes, caps, stale=True)
    for f, s in zip(fresh, stale):
        assert torch.equal(f, s)
    cz = binning.cell_trunc(rows[:, 0:3], cfg)[:, 2]
    window = binning.run_table(bt, cfg, caps, window=(
        cz, forces.column_shift(rows, bt, cfg)))
    for a, b in zip(forces.lane_slots(bt, cfg, lanes, caps=caps),
                    forces.lane_slots(bt, cfg, lanes, runs=window)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", STALE)
def test_column_shift_is_a_loop_over_rows(name):
    _, bt, cfg, _, _ = _case(name)
    rows, cells, shift, _ = _windowed(name)
    g = cfg.grid_size
    want = [0] * (g * g)
    for c, alive, cz in zip(bt.cid.tolist(), rows[:, 9].tolist(),
                            cells[:, 2].tolist()):
        if c < g ** 3 and alive > 0.5 and not math.isnan(cz):
            d = min(abs(cz - c % g), g)
            want[c // g] = max(want[c // g], int(d))
    assert shift.tolist() == want


@pytest.mark.parametrize("name", ("fresh", "far"))
def test_base_pack_plain_is_the_kernels_layout(name):
    """``sph_kernels.base_pack`` on CPU tensors: the rows of pack_rows,
    whose column 10 is press / dens^2 (the base kernels' per-row term)
    and column 11 zero, and, stale, the current cells with a zero column
    and the column shifts."""
    st, bt, cfg, _, stale = _case(name)
    rows, cells, shift = sph_kernels.base_pack(st, bt, cfg, bt.order, stale)
    p = st.press[bt.order]
    d = st.dens[bt.order]
    assert torch.equal(rows[:, 10], p / (d * d)) and not rows[:, 11].any()
    if not stale:
        assert cells is None and shift is None
        return
    now = binning.cell_trunc(rows[:, 0:3], cfg)
    assert torch.equal(cells[:, 0:3].isnan(), now.isnan())
    assert torch.equal(torch.nan_to_num(cells[:, 0:3]), torch.nan_to_num(now))
    assert not cells[:, 3].any()
    assert torch.equal(shift, forces.column_shift(rows, bt, cfg))


def _kernel_walk(name, lanes):
    """(S, 4) int64 (row, j, lane, q) of every slot the kernels walk,
    transcribed from their loops cell by cell: a row of cell c, rank
    below the home cap, over the 9 (dx, dy) columns and, fresh, the cells
    z-1..z+1 of each, stale the window of tf_sph::stale_window; capped at
    w_cap rows of each neighbour column; slot t to lane t mod lanes."""
    _, bt, cfg, caps, stale = _case(name)
    g = cfg.grid_size
    cs, cid = bt.cell_start.tolist(), bt.cid.tolist()
    if stale:
        _, cells, shift, _ = _windowed(name)
        cz_now, shift = cells[:, 2].tolist(), shift.tolist()
    edge = 2.0 * g + 2.0
    out = []
    for i, c in enumerate(cid):
        if c >= g ** 3 or (caps and i - cs[c - c % g] >= caps[0]):
            continue
        cz, cy, cx = c % g, (c // g) % g, c // (g * g)
        t = 0
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                if not (0 <= cx + dx < g and 0 <= cy + dy < g):
                    continue
                col = (cx + dx) * g + cy + dy
                if not stale:
                    z0, z1 = max(cz - 1, 0), min(cz + 1, g - 1)
                elif shift[col] >= g:
                    z0, z1 = 0, g - 1
                else:
                    z = cz_now[i]
                    z = int(-edge if math.isnan(z) else min(max(z, -edge),
                                                            edge))
                    z0 = max(z - 1 - shift[col], 0)
                    z1 = min(z + 1 + shift[col], g - 1)
                for z in range(z0, z1 + 1):
                    end = cs[col * g + z + 1]
                    if caps:
                        end = min(end, cs[col * g] + caps[1])
                    for j in range(cs[col * g + z], end):
                        out.append((i, j, t % lanes, t // lanes))
                        t += 1
    return torch.tensor(out, dtype=torch.int64).reshape(-1, 4)


@pytest.mark.parametrize("lanes", (4, 32))
@pytest.mark.parametrize("name", NAMES)
def test_lane_slots_are_the_kernel_walk(name, lanes):
    _, bt, cfg, caps, stale = _case(name)
    runs = _windowed(name)[3] if stale else None
    got = torch.stack(forces.lane_slots(bt, cfg, lanes, caps=caps,
                                        runs=runs), 1)
    want = _kernel_walk(name, lanes)
    assert torch.equal(got, want)
    assert int(torch.bincount(want[:, 0]).max()) > lanes


def _jax_close(got, ref, name):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    np.testing.assert_allclose(got, ref, rtol=2e-4,
                               atol=1e-6 * max(1.0, np.abs(ref).max()),
                               err_msg=name)
    assert float(np.abs(ref).max()) > 0.0


def _in_domain_blob(jcfg, n, span, seed):
    """(JAX state, port state) of a blob in the domain, with dens, press
    and vel drawn from ``seed`` (the JAX kernels floor cell coordinates
    where the port truncates, ROADMAP Queue 3: keep away from low faces)."""
    d = state_to_dict(jscenes.random_blob(n, seed=seed, cfg=jcfg, span=span,
                                          boundary_frac=0.1))
    rng = np.random.default_rng(seed + 100)
    d["dens"] = rng.uniform(9300.0, 9900.0, n).astype(np.float32)
    d["press"] = rng.normal(0.0, 3e4, n).astype(np.float32)
    d["vel"] = rng.normal(0.0, 0.5, (n, 3)).astype(np.float32)
    return (jstate.ParticleState(**{k: jnp.asarray(v) for k, v in d.items()}),
            convert.state_from_numpy(d, device="cpu"))


def test_lane_pass_matches_jax_rowblock_interpret():
    jcfg = jconfig.BASE_CONFIG
    jst, tst = _in_domain_blob(jcfg, 300, 0.5, 2)
    jorder, jbt = jbinning.sort_tables(jst, jcfg)
    with pltpu.force_tpu_interpret_mode():
        sw, dp, _ = jax_rowblock(jst, jbt, jcfg, order=jorder)
    _, bt = binning.sort_tables(tst, BASE_CONFIG)
    got = forces.base_lane_pass(tst, bt, BASE_CONFIG,
                                sph_kernels.BASE_LANES)
    _jax_close(got[0].numpy(), sw, "sum_w")
    _jax_close(got[1].numpy(), dp, "dpress")


def test_lane_pass_matches_jax_column_interpret():
    """At a cap the columns run over: a 0.6 box of 12^3 cells, which
    cuts the interpret-mode kernel to 144 column programs."""
    box = dict(xmin=-0.3, ymin=-0.3, zmin=-0.3, xmax=0.3, ymax=0.3,
               zmax=0.3, grid_size=12)
    jcfg = jconfig.BASE_CONFIG.replace(pallas_col_cap=8, pallas_w_chunk=12,
                                       **box)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    jst, tst = _in_domain_blob(jcfg, 400, 0.15, 3)
    jorder, jbt = jbinning.sort_tables(jst, jcfg)
    with pltpu.force_tpu_interpret_mode():
        sw, dp, ovf = base_forces_pallas(jst, jbt, jcfg, b=8, w_cap=8,
                                         order=jorder, w_chunk=12)
    _, bt = binning.sort_tables(tst, tcfg)
    caps = config.column_caps(tcfg)
    got = forces.base_lane_pass(tst, bt, tcfg, sph_kernels.BASE_LANES, caps)
    _jax_close(got[0].numpy(), sw, "sum_w")
    _jax_close(got[1].numpy(), dp, "dpress")
    assert int(ovf) == int(binning.column_overflow(bt, tcfg, caps[0])) > 0


def test_lanes_constant_is_the_kernels():
    """sph_kernels.BASE_LANES is kLanes of csrc/sph_forces.cu, a power of
    two that divides a warp."""
    text = (Path(forces.__file__).parent / "csrc" /
            "sph_forces.cu").read_text()
    lanes = sph_kernels.BASE_LANES
    assert f"constexpr int kLanes = {lanes};" in text
    assert 32 % lanes == 0 and lanes & (lanes - 1) == 0
