"""The port's spans (``tpufluids_torch.diagnostics``), on the CPU: off
by default and then nothing is kept; on, ``run3d_python`` at 16^3 opens
the documented tree at the grid step's layer boundaries (frame, step,
stage, solve, the DCT's phases) for every projection, and gives the
same state bit for bit as a run with tracing off; a span closes when
its body raises; under ``torch.profiler`` the spans are host ranges
that are not user annotations, with the solve's aten ops inside them;
``profile`` and the kernel library's load open spans of their own."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpufluids_torch import _build, diagnostics
from tpufluids_torch.grid import kernels, stam

N = 16
STEPS = 2
SMOKE = dict(n=N, dt=0.5 / N, advect_mode="stencil", vorticity_eps=2.0,
             buoyancy_alpha=0.05, buoyancy_beta=0.5)
# projection -> (StamConfig keywords, grid.solve detail)
SOLVES = {
    "dct": (dict(projection="dct", dct_precision_first="default"), "dct"),
    "rb": (dict(red_black=True), "rb"),
    "jacobi": ({}, "jacobi"),
    "rb_bf16": (dict(red_black=True, solver_dtype="bfloat16"), "rb_bf16"),
    "jacobi_bf16": (dict(solver_dtype="bfloat16"), "jacobi_bf16"),
    "multigrid": (dict(projection="multigrid"), "multigrid"),
}


@pytest.fixture
def traced():
    """Tracing on and the records empty; off and empty again after."""
    was = diagnostics.tracing(True)
    diagnostics.clear_spans()
    yield
    diagnostics.tracing(was)
    diagnostics.clear_spans()


@pytest.fixture
def above_the_gates(monkeypatch):
    """Every step as at 256^3: step3d_multi, no fused projection and no
    whole solve or diffusion, so a step runs two projection solves."""
    monkeypatch.setattr(kernels, "step_whole_ok", lambda u: False)
    monkeypatch.setattr(kernels, "solve_whole_ok", lambda x, dtype: False)


def seeded_state(cfg):
    gen = torch.Generator().manual_seed(5)
    s = stam.make_grid3d(cfg, device="cpu")
    for f in ("u", "v", "w"):
        getattr(s, f).copy_(torch.rand(getattr(s, f).shape, generator=gen)
                            - 0.5)
    s.dens[6:10, 6:10, 1:4] = 1.0
    s.temp[6:10, 6:10, 1:4] = 3.0
    return s


def run(cfg, on):
    was = diagnostics.tracing(on)
    try:
        return stam.run3d_python(seeded_state(cfg), cfg, STEPS)
    finally:
        diagnostics.tracing(was)


def children(recs, i):
    return [r for r in recs if r.parent == i]


def check_nesting(recs):
    """Each record closed, inside its parent, in frame 0."""
    for i, r in enumerate(recs):
        assert r.index == i and r.frame == 0
        assert 0 < r.start_ns <= r.end_ns
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns


def test_off_keeps_nothing():
    assert diagnostics.span("grid.solve", "dct") is diagnostics.span("x")
    diagnostics.clear_spans()
    run(stam.StamConfig(**SMOKE, projection="dct"), on=False)
    assert diagnostics.spans() == []


@pytest.mark.parametrize("kind", list(SOLVES))
def test_step_tree_above_the_gates(traced, above_the_gates, kind):
    kw, detail = SOLVES[kind]
    cfg = stam.StamConfig(**SMOKE, **kw)
    state, res = run(cfg, on=True)
    recs = diagnostics.spans()
    check_nesting(recs)
    (frame,) = [r for r in recs if r.parent == -1]
    assert frame.label == "grid.frame" and frame.index == 0
    steps = children(recs, 0)
    assert [s.label for s in steps] == ["grid.step:multi"] * STEPS
    for k, step in enumerate(steps):
        last = k == STEPS - 1
        assert [r.label for r in children(recs, step.index)] == [
            "grid.forcing", "grid.project:first", "grid.advect:velocity",
            "grid.project:final", "grid.advect:scalars"]
        for proj in children(recs, step.index)[1::2]:
            inner = [r.label for r in children(recs, proj.index)]
            residual = last and proj.detail == "final"
            assert inner == [f"grid.solve:{detail}"] + (
                ["grid.residual"] if residual else [])
    solves = [r for r in recs if r.name == "grid.solve"]
    assert len(solves) == 2 * STEPS
    assert sum(r.name == "grid.residual" for r in recs) == 1
    phases = [[r.label for r in children(recs, s.index)] for s in solves]
    assert phases == [["grid.dct:forward", "grid.dct:scale",
                       "grid.dct:inverse"] if kind == "dct" else []] * len(
                           solves)
    plain_state, plain_res = run(cfg, on=False)
    for f in ("u", "v", "w", "dens", "temp"):
        assert torch.equal(getattr(state, f), getattr(plain_state, f)), f
    assert torch.equal(res, plain_res)


def test_step_tree_inside_the_gates(traced):
    """BASELINE config 4 at 16^3: whole steps, then the frame's last step
    (the residual's) with the fused first projection and the
    multi-field diffusions."""
    cfg = stam.StamConfig(n=N, dt=0.05, diff=1e-5, visc=1e-5,
                          red_black=True, advect_mode="stencil",
                          buoyancy_alpha=0.05, buoyancy_beta=1.0,
                          vorticity_eps=2.0)
    state, res = run(cfg, on=True)
    recs = diagnostics.spans()
    check_nesting(recs)
    steps = children(recs, 0)
    assert [s.label for s in steps] == (["grid.step:whole"] * (STEPS - 1)
                                        + ["grid.step:multi"])
    assert children(recs, steps[0].index) == []
    last = children(recs, steps[-1].index)
    assert [r.label for r in last] == [
        "grid.forcing", "grid.diffuse:velocity", "grid.project:fused",
        "grid.advect:velocity", "grid.project:final", "grid.diffuse:scalars",
        "grid.advect:scalars"]
    assert [r.label for r in children(recs, last[4].index)] == [
        "grid.solve:rb", "grid.residual"]
    plain_state, plain_res = run(cfg, on=False)
    for f in ("u", "v", "w", "dens", "temp"):
        assert torch.equal(getattr(state, f), getattr(plain_state, f)), f
    assert torch.equal(res, plain_res)


def test_frames_share_their_index(traced):
    cfg = stam.StamConfig(**SMOKE, projection="dct")
    s = seeded_state(cfg)
    for _ in range(3):
        s, _ = stam.run3d_python(s, cfg, 1)
    recs = diagnostics.spans()
    frames = [r for r in recs if r.name == "grid.frame"]
    assert [r.frame for r in frames] == [0, 1, 2]
    for r in recs:
        top = r
        while top.parent >= 0:
            top = recs[top.parent]
        assert r.frame == top.frame


def test_span_closes_when_its_body_raises(traced):
    with pytest.raises(ValueError):
        with diagnostics.span("grid.frame"):
            with diagnostics.span("grid.solve", "dct"):
                raise ValueError("inside")
    frame, solve = diagnostics.spans()
    assert solve.parent == frame.index == 0 and solve.frame == 0
    assert frame.end_ns >= solve.end_ns >= solve.start_ns > 0
    diagnostics.clear_spans()                  # nothing is left open
    with diagnostics.span("grid.frame"):
        with pytest.raises(RuntimeError):
            diagnostics.clear_spans()


def test_profiler_sees_host_ranges_not_annotations(traced):
    cfg = stam.StamConfig(**SMOKE, projection="dct")
    s = seeded_state(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        stam.run3d_python(s, cfg, 1)
    events = prof.events()
    ours = [e for e in events if e.name.startswith("grid.")]
    assert sorted({e.name for e in ours}) == sorted(
        {r.label for r in diagnostics.spans()})
    assert len(ours) == len(diagnostics.spans())
    assert not any(e.is_user_annotation for e in ours)
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in ours)

    def ancestors(e):
        while e.cpu_parent is not None:
            e = e.cpu_parent
            yield e.name

    solved = {e.name for e in events if e.name.startswith("aten::")
              and "grid.solve:dct" in ancestors(e)}
    assert {"aten::tensordot", "aten::div", "aten::zeros_like"} <= solved
    # the transforms' products sit in the DCT's phases, inside the solve
    assert all("grid.dct:forward" in ancestors(e)
               or "grid.dct:inverse" in ancestors(e)
               for e in events if e.name == "aten::tensordot"
               and "grid.solve:dct" in ancestors(e))


def test_profile_region_is_a_span(traced):
    x = torch.arange(10.0)
    with diagnostics.profile("region", arrays=(x,)) as held:
        with diagnostics.span("grid.solve", "dct"):
            pass
    region, solve = diagnostics.spans()
    assert region.label == "region" and solve.parent == region.index
    assert held["name"] == "region"
    assert region.seconds >= held["seconds"] > 0


@pytest.mark.parametrize("built", [True, False], ids=["found", "built"])
def test_kernel_library_load_is_a_span(traced, monkeypatch, tmp_path,
                                       built):
    lib = tmp_path / "libtpufluids_torch_0.so"
    if built:
        lib.write_bytes(b"")
    loaded = object()
    monkeypatch.setattr(_build, "_library", lambda: lib)
    monkeypatch.setattr(_build, "build",
                        lambda: _build.Build(lib, 0.0, ""))
    monkeypatch.setattr(_build, "_load", lambda path: loaded)
    assert _build.load.__wrapped__() is loaded
    (rec,) = diagnostics.spans()
    assert rec.label == ("kernels.load" if built else "kernels.load:build")
