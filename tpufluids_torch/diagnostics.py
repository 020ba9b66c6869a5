"""Observability: ``tpufluids.diagnostics`` for the port.

* per-step metrics (``step.StepMetrics``) stream to JSONL, the same
  records as the JAX package's;
* a NaN/blow-up guard halts the run and can dump a checkpoint first
  (the analog of the reference's fail-fast CUDA_CHECK_RETURN,
  FluidGPU.cuh:34-41);
* ``profile`` times a region, fenced by ``torch.cuda.synchronize`` on
  the devices of the tensors it is given, and can record a
  ``torch.profiler`` trace;
* spans: ``span(name, detail)`` marks a region of the host's work (the
  grid step opens them at its layer boundaries: frame, step, stage,
  solve).  Off by default, when a span costs one flag test; after
  ``tracing(True)`` each span appends a ``SpanRecord`` to ``spans()``,
  and while ``torch.profiler`` records it is also a host range on the
  profiler's timeline, named ``name`` or ``name:detail``, that puts no
  event on the device's timeline.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class MetricsLogger:
    """Append per-step metrics dicts as JSON lines."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a", buffering=1)

    def log(self, step: int, metrics, wall_s: float | None = None):
        """``metrics`` is a StepMetrics of tensors on any device (stacked
        over a run) or a dict."""
        if hasattr(metrics, "_asdict"):
            metrics = metrics._asdict()
        rec = {"step": int(step)}
        if wall_s is not None:
            rec["wall_s"] = float(wall_s)
        for k, v in metrics.items():
            rec[k] = float(_host(v).reshape(-1)[-1])  # the last step
        self._f.write(json.dumps(rec) + "\n")
        return rec

    def close(self):
        self._f.close()


class BlowUpError(RuntimeError):
    pass


def check_state(state, cfg, max_speed: float = 1e3,
                dump_path: str | None = None) -> None:
    """Halt on NaN/Inf or runaway velocity; optionally dump a checkpoint
    first so the failure is inspectable/resumable."""
    pos = _host(state.pos)
    vel = _host(state.vel)
    bad = []
    if not np.isfinite(pos).all():
        bad.append("non-finite positions")
    if not np.isfinite(vel).all():
        bad.append("non-finite velocities")
    alive = _host(state.alive)
    speed = np.linalg.norm(vel, axis=-1)
    if np.any(alive & (speed > max_speed)):
        bad.append(f"speed exceeds {max_speed}")
    if bad:
        if dump_path is not None:
            from tpufluids_torch.io import checkpoint
            checkpoint.save(dump_path, state, cfg)
            bad.append(f"state dumped to {dump_path}")
        raise BlowUpError("; ".join(bad))


FRAME = "grid.frame"      # the span whose index the spans inside it share

_tracing = False
_records: list = []       # every SpanRecord since the last clear_spans()
_open: list = []          # the open spans' records, innermost last
_frames = 0               # FRAME spans opened since the last clear_spans()


class SpanRecord:
    """One span, and the context manager that records it.  ``index``:
    its place in ``spans()``; ``parent``: the index of the span open
    around it (-1: none); ``frame``: the index of the FRAME span it lies
    in, counted from the last ``clear_spans()`` (-1: none);
    ``start_ns``, ``end_ns``: ``time.perf_counter_ns()`` (end 0 while
    the span is open)."""

    __slots__ = ("name", "detail", "index", "parent", "frame", "start_ns",
                 "end_ns", "_range")

    def __init__(self, name: str, detail: str = ""):
        self.name, self.detail, self.end_ns = name, detail, 0

    @property
    def label(self) -> str:
        """The span's name on the profiler's timeline."""
        return f"{self.name}:{self.detail}" if self.detail else self.name

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self):
        global _frames
        if _open:
            top = _open[-1]
            self.parent, self.frame = top.index, top.frame
        else:
            self.parent = self.frame = -1
        if self.name == FRAME:
            self.frame, _frames = _frames, _frames + 1
        self.index = len(_records)
        _records.append(self)
        _open.append(self)
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = _RecordFunctionFast(self.label)
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()

    def __exit__(self, exc_type, exc, tb):
        self.end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        _open.pop()


class _NoSpan:
    """The span handed out while tracing is off: it does nothing."""

    __slots__ = ()

    def __enter__(self):
        pass

    def __exit__(self, exc_type, exc, tb):
        pass


_NO_SPAN = _NoSpan()


def span(name: str, detail: str = ""):
    """A context manager around one region of the host's work: the
    shared no-op while tracing is off, else a span recorded as a
    ``SpanRecord`` (closed even when its body raises).  Spans nest by
    the order they open in; open them from one thread."""
    if not _tracing:
        return _NO_SPAN
    return SpanRecord(name, detail)


def tracing(on: bool) -> bool:
    """Switch span recording on or off; returns the previous setting."""
    global _tracing
    was, _tracing = _tracing, bool(on)
    return was


def spans() -> list:
    """The SpanRecords since the last ``clear_spans()``, in the order
    they opened."""
    return list(_records)


def clear_spans():
    """Forget every record.  Raises while a span is open."""
    global _frames
    if _open:
        raise RuntimeError(f"{len(_open)} spans are open")
    _records.clear()
    _frames = 0


@contextlib.contextmanager
def profile(name: str, arrays=(), trace_dir: str | None = None):
    """Wall-time a region; the time ends after ``torch.cuda.synchronize``
    on the device of each CUDA tensor in ``arrays``.  Given
    ``trace_dir``, the region also runs under ``torch.profiler`` (the
    card's kernels too where there is one), and its trace goes to
    ``<trace_dir>/<name>.pt.trace.json`` (Chrome/Perfetto format).
    Yields a dict that gets "seconds" and "name" at the end."""
    with contextlib.ExitStack() as stack:
        prof = None
        if trace_dir:
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as torch_profile
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            prof = stack.enter_context(torch_profile(activities=activities))
        stack.enter_context(span(name))
        t0 = time.perf_counter()
        holder = {}
        yield holder
        for device in {a.device for a in arrays
                       if isinstance(a, torch.Tensor) and a.is_cuda}:
            torch.cuda.synchronize(device)
        holder["seconds"] = time.perf_counter() - t0
        holder["name"] = name
    if prof is not None:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir,
                                              f"{name}.pt.trace.json"))
