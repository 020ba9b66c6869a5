"""Observability: ``tpufluids.diagnostics`` for the port.

* per-step metrics (``step.StepMetrics``) stream to JSONL, the same
  records as the JAX package's;
* a NaN/blow-up guard halts the run and can dump a checkpoint first
  (the analog of the reference's fail-fast CUDA_CHECK_RETURN,
  FluidGPU.cuh:34-41);
* ``profile`` times a region, fenced by ``torch.cuda.synchronize`` on
  the devices of the tensors it is given, and can record a
  ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch


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
