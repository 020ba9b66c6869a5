"""The benchmark's arithmetic on synthetic inputs, against numbers worked
by hand: the 95th percentile, the spread, the device's busy and idle
time from overlapping intervals, the roofline counts from shapes, and
the readers."""

import pytest

from fluidbench import common, trace
from fluidbench.roofline import advect, peaks, rb_solve, step, step_whole

STAM256 = {"n": 256, "jacobi_iters": 20, "buoyancy_alpha": 0.05,
           "buoyancy_beta": 0.5, "vorticity_eps": 2.0, "visc": 0.0,
           "diff": 0.0, "temp_diff": 0.0, "projection": "jacobi"}
PLUME64 = dict(STAM256, n=64, visc=1e-5, diff=1e-5, buoyancy_beta=1.0)
FIELD256 = 258 ** 3 * 4              # 68,694,048 bytes


def test_p95_over_all_frames():
    # 21 frames: position 0.95 * 20 = 19, the 20th smallest exactly
    assert common.p95(range(1, 22)) == 20.0
    # 11 values 0..10: position 9.5, halfway between 9 and 10
    assert common.p95([10, 0, 9, 1, 8, 2, 7, 3, 6, 4, 5]) == 9.5
    assert common.p95([4.0]) == 4.0


def test_quartiles_are_the_statistics_ones():
    # statistics.quantiles([1..8], n=4) = [2.25, 4.5, 6.75]
    assert common.quartiles(range(1, 9)) == (2.25, 4.5, 6.75)


def make_slice(device, start=0.0, end=100.0, counters=None, spans=(),
               host=(), stam=None):
    return trace.Slice(frames=2, steps=20, start=start, end=end,
                       device=list(device), host=sorted(host, key=lambda h: h[1]),
                       counters=counters or {}, spans=list(spans),
                       stam=stam or STAM256)


def test_idle_share_from_overlapping_intervals():
    # busy [10, 30] u [20, 40] u [35, 50] = [10, 50] and [60, 70], plus
    # [95, 120] clipped to the window's end: 40 + 10 + 5 = 55 of 100 us
    tr = make_slice([("a", 10, 30), ("b", 20, 40), ("c", 35, 50),
                     ("d", 60, 70), ("e", 95, 120)])
    assert tr.busy_s() == pytest.approx(55e-6)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.gaps() == [(0.0, 10), (50, 60), (70, 95)]
    reader = common.module("metrics", "device_idle_share").read
    assert reader(tr) == pytest.approx(0.45)


def test_idle_gaps_named_by_the_host():
    host = [(trace.FRAME, 0, 55), ("aten::mm", 45, 52),
            (trace.READ, 55, 100), ("aten::item", 56, 99)]
    tr = make_slice([("k1", 10, 44), ("k2", 52, 60), ("k3", 62, 100)],
                    host=host)
    b = tr.breakdown()
    assert b["device_ops"][0] == ["k3", pytest.approx(38e-6)]
    assert b["device_ops"][1] == ["k1", pytest.approx(34e-6)]
    # gaps: [0, 10] python inside the enqueue mark, [44, 52] in
    # aten::mm, [60, 62] in aten::item
    idle = dict((k, v) for k, v in b["idle_gaps"])
    assert idle == {"enqueue:python": pytest.approx(10e-6),
                    "enqueue:aten::mm": pytest.approx(8e-6),
                    "read:aten::item": pytest.approx(2e-6)}


def test_idle_gap_inside_a_long_mark():
    # 400 host ops before the gap: the mark that covers it began long
    # before them
    host = [(trace.FRAME, 0, 1000)] + [("aten::add", k, k + 0.5)
                                       for k in range(1, 401)]
    tr = make_slice([("k", 0, 500), ("k", 600, 1000)], end=1000.0, host=host)
    assert tr.breakdown()["idle_gaps"] == [["enqueue:python",
                                            pytest.approx(100e-6)]]


def test_rb_solve_bytes_and_operations_from_shapes():
    [(nbytes, ops, rate)] = rb_solve.work(STAM256)
    assert nbytes == 2 * FIELD256
    assert ops == 8 * 20 * 256 ** 3 == 2_684_354_560
    t, what = peaks.bound_s(nbytes, ops, rate)
    # 137,388,096 B / 3.35e12 B/s = 41.01 us > 2.684e9 / 67e12 = 40.06 us
    assert what == "bytes" and t == pytest.approx(41.0114e-6, rel=1e-5)


def test_advect_counts_both_calls():
    (b3, o3, _), (b2, o2, _) = advect.work(STAM256)
    assert b3 == 6 * FIELD256 and o3 == 267 * 256 ** 3
    assert b2 == 7 * FIELD256 and o2 == 213 * 256 ** 3


def test_step_whole_operations():
    # config 4: 2 (6 + 160 + 15) + 267 + 213 + 6 + 70 + 160 (3 + 1)
    assert step_whole.step_ops(PLUME64) == 1558
    [(nbytes, ops, _)] = step_whole.work(PLUME64)
    assert nbytes == 10 * 66 ** 3 * 4 and ops == 1558 * 64 ** 3
    t, what = peaks.bound_s(nbytes, ops)
    assert what == "operations" and t == pytest.approx(6.0960e-6, rel=1e-4)


def test_step_count_of_the_dct_projection():
    # each DCT solve: 15 log2(256) + 1 = 121 in place of 8 * 20 = 160
    dct = dict(STAM256, projection="dct")
    assert step.step_ops(dct) == step_whole.step_ops(STAM256) - 2 * 39


def test_kernel_share_and_its_event_check():
    calls = 4
    events = [("void rb_blocked_kernel<F>", 0, 100)] * 10 * calls + [
        ("void ghost_kernel<float>", 0, 10)] * calls
    tr = make_slice(events, counters={"lin_solve3d_rb": calls})
    least = calls * peaks.bound_s(*rb_solve.work(STAM256)[0])[0]
    busy = (10 * calls * 100 + calls * 10) / 1e6
    reader = common.module("metrics", "rb_solve_roofline").read
    assert reader(tr) == pytest.approx(100 * least / busy)
    short = make_slice(events[:calls - 1], counters={"lin_solve3d_rb": calls})
    with pytest.raises(trace.IncompleteTrace):
        reader(short)
    assert reader(make_slice([], counters={})) is None
    assert reader(make_slice(events, counters={})) is None
    # calls counted but no event of the kernel's name: a renamed kernel
    advect = common.module("metrics", "advect_roofline").read
    with pytest.raises(trace.IncompleteTrace):
        advect(make_slice([("void other_kernel", 0, 100)] * 4,
                          counters={"advect3d_multi": 2}))


def test_span_readers():
    spans = [(0.004, 0.060, 10, False), (0.006, 0.070, 10, False),
             (0.5, 0.5, 10, True)]
    tr = make_slice([("k", 0, 1)] * 30, spans=spans,
                    counters={"advect3d_multi": 20})
    enqueue = common.module("metrics", "enqueue_ms_per_step").read
    assert enqueue(tr) == pytest.approx(1e3 * 0.010 / 20)
    mfu = common.module("metrics", "step_mfu").read
    wall = 0.140 / 20
    least = peaks.bound_s(*step.work(STAM256)[0])[0]
    assert mfu(tr) == pytest.approx(100 * least / wall)
    launches = common.module("metrics", "launches_per_step").read
    assert launches(tr) == 30 / 20
    with pytest.raises(trace.IncompleteTrace):
        launches(make_slice([("k", 0, 1)] * 19,
                            counters={"advect3d_multi": 20}))
