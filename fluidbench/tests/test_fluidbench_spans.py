"""The program's spans as the benchmark reads them (spans.py): the
attribution of device operations to the spans around their launch, the
readers of the span metrics on hand-made slices with the arithmetic
written out, the DCT solve's count by hand, and a whole span run at
16^3 on the CPU."""

import types

import pytest
import torch

from fluidbench import common, spans, trace
from fluidbench.roofline import dct_solve, peaks

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

# host events (name, start, end, thread, launched): a frame holding a
# DCT solve (its forward phase holds an aten::mm, which launched a GEMM;
# the solve span itself launched a ghost pass, as a hand kernel's
# wrapper does), an add inside the frame alone, a mul outside any span;
# another thread's span covers the mm's time
HOST = [("grid.frame", 0.0, 100.0, 1, []),
        ("grid.solve:dct", 10.0, 50.0, 1, [("ghost", 1.0)]),
        ("grid.dct:forward", 12.0, 30.0, 1, []),
        ("aten::mm", 14.0, 20.0, 1, [("gemm", 30.0)]),
        ("aten::add", 60.0, 70.0, 1, [("add", 5.0)]),
        ("aten::mul", 200.0, 210.0, 1, [("mul", 2.0), ("mul", 2.0)]),
        ("grid.solve:rb", 0.0, 300.0, 2, [])]


def test_attribution_follows_the_launch():
    device_us, ops, alone = spans.attribute(HOST)
    assert alone == 2
    assert device_us["grid.dct:forward"] == device_us["grid.dct"] == 30.0
    assert ops["grid.dct:forward"] == ops["grid.dct"] == 1
    # the gemm's 30 us and the ghost pass's 1 us
    assert device_us["grid.solve"] == device_us["grid.solve:dct"] == 31.0
    assert ops["grid.solve"] == 2
    assert device_us["grid.frame"] == 36.0 and ops["grid.frame"] == 3
    # thread 2's span holds the mm's time but launched nothing
    assert "grid.solve:rb" not in ops


def test_innermost_span_of_a_time_and_an_interval():
    tree = spans.Tree([h for h in HOST if h[3] == 1
                       and spans.is_program(h[0])])
    labels = [h[0] for h in tree.spans]
    assert labels == ["grid.frame", "grid.solve:dct", "grid.dct:forward"]
    assert tree.parent == [-1, 0, 1]
    assert labels[tree.innermost(15.0, 16.0)] == "grid.dct:forward"
    assert labels[tree.innermost(40.0, 40.0)] == "grid.solve:dct"
    assert labels[tree.innermost(29.0, 31.0)] == "grid.solve:dct"
    assert labels[tree.innermost(65.0, 65.0)] == "grid.frame"
    assert tree.innermost(150.0, 150.0) == -1
    assert tree.chain(2) == labels[::-1]


def test_events_of_the_profiler():
    """A host event keeps the device operations linked to it, less a
    user annotation's event on the device's timeline (the harness's
    marks, any record_function); device events themselves are no host
    events."""
    kernel = lambda name, us: types.SimpleNamespace(name=name, duration=us)
    ev = lambda name, kind, kernels=(), note=False: types.SimpleNamespace(
        name=name, device_type=kind, thread=1, kernels=list(kernels),
        is_user_annotation=note,
        time_range=types.SimpleNamespace(start=1, end=2))
    events = [ev("grid.solve:dct", CPU, [kernel("ghost", 1.5)]),
              ev(trace.FRAME, CPU, [kernel(trace.FRAME, 9.0)], True),
              ev("region", CPU, [kernel("region", 3.0),
                                 kernel("gemm", 4.0)], True),
              ev("gemm", CUDA), ev("region", CUDA, note=True)]
    assert spans.host_events(events) == [
        ("grid.solve:dct", 1.0, 2.0, 1, [("ghost", 1.5)]),
        (trace.FRAME, 1.0, 2.0, 1, []),
        ("region", 1.0, 2.0, 1, [("gemm", 4.0)])]


def test_stretch_counts_labels_and_names():
    def rec(name, detail, ns):
        r = types.SimpleNamespace(name=name, detail=detail, start_ns=0,
                                  end_ns=ns)
        r.label = f"{name}:{detail}" if detail else name
        return r
    assert spans.stretch([rec("grid.solve", "dct", 5),
                          rec("grid.solve", "dct", 7),
                          rec("grid.frame", "", 20)]) == {
        "grid.solve:dct": 12, "grid.solve": 12, "grid.frame": 20}


def test_dct_solve_count_by_hand():
    # a solve at 256^3: (15 * 8 + 1) * 256^3 = 2,030,043,136 operations
    # (30.3 us at 67 TFLOP/s); 2 * 258^3 * 4 = 137,388,096 bytes (41.0 us
    # at 3.35 TB/s): bytes bind, and a step's two solves take 82.0 us
    nbytes, ops, rate = dct_solve.solve_work(256)
    assert (nbytes, ops, rate) == (137_388_096, 2_030_043_136,
                                   peaks.FP32_OPS_PER_S)
    assert peaks.bound_s(nbytes, ops) == pytest.approx((41.0114e-6,
                                                        "bytes"), rel=1e-5)
    step_s = sum(peaks.bound_s(*w)[0] for w in dct_solve.work({"n": 256}))
    assert step_s == pytest.approx(82.0227e-6, rel=1e-5)


def traced(program, device=(("gemm", 0.0, 1.0),), n=256):
    return spans.TracedSlice(frames=12, steps=120, start=0.0, end=1e6,
                             device=list(device), host=[], counters={},
                             spans=[], stam={"n": n}, program=program)


def program(**kw):
    base = dict(steps=120, device_us={}, ops={}, events={})
    return spans.Program(**{**base, **kw})


def test_span_readers_by_hand():
    read = lambda name, tr: common.reader(name)(tr)
    p = program(device_us={"grid.solve": 540_000.0,
                           "grid.solve:dct": 360_000.0},
                ops={"grid.solve": 2640},
                events={"grid.solve:dct": 240},
                stretch_steps=120, host_ns={"grid.solve": 96_000_000},
                setup_frame_s=1.25)
    tr = traced(p)
    # 540,000 us over 120 steps: 4.5 ms a step
    assert read("solve_device_ms_per_step", tr) == pytest.approx(4.5)
    # 2640 operations over 120 steps
    assert read("solve_launches_per_step.host_paced", tr) == 22.0
    # 96 ms of host time over the stretch's 120 steps
    assert read("solve_enqueue_ms_per_step", tr) == pytest.approx(0.8)
    # 240 solves of at least 41.0114 us (9,842.7 us) in 360,000 us
    assert read("dct_solve_roofline.host_paced", tr) == pytest.approx(
        100 * 240 * 41.0114e-6 / 0.36, rel=1e-5)
    assert read("setup_program_s", tr) == 1.25


@pytest.mark.parametrize("name", spans.NAMES)
def test_span_readers_find_nothing_without_spans(name):
    read = common.reader(name)
    assert read(trace.Slice(1, 10, 0.0, 1.0, [("k", 0.0, 1.0)], [], {}, [],
                            {"n": 16})) is None
    assert read(traced(None)) is None
    if name != "setup_program_s":
        # a slice without solves, or without device operations
        assert read(traced(program())) is None
        assert read(traced(program(events={"grid.solve:rb": 4},
                                   ops={"grid.solve": 8},
                                   device_us={"grid.solve": 1.0}),
                           device=())) is None


def test_span_run_on_the_cpu(small_cells):
    """The DCT cell, the one with the most spans a step (the other cells
    run the whole step at 16^3, tens of seconds on the CPU)."""
    name = "stam3d-256.dct"
    out = spans.measure(name, 2 ** 31 + 11, device="cpu", require=False)
    man = common.manifest()
    w = common.workload(man, name)
    sfx = spans.suffix(man, w)
    assert set(out["metrics"]) == {
        n + ("" if n == "setup_program_s" else sfx) for n in spans.NAMES}
    assert set(out["existing_on_off"]) == {
        m["name"] for m in common.per_layer(man, w)}
    assert out["metrics"]["setup_program_s"] > 0
    assert out["metrics"]["solve_enqueue_ms_per_step" + sfx] > 0
    assert out["same_frame_bit_for_bit"]
    assert out["device_events_named_after_spans"] == []
    assert out["setup"]["warmup_frame_s"] <= out["setup"]["setup_s"]
    labels = [row[0] for row in out["table"]]
    assert "grid.frame" in labels and "grid.step:multi" in labels
