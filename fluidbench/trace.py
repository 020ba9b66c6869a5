"""The traced slice: a fixed number of whole frames under torch.profiler,
reduced to what the per-layer metric readers and the breakdown read.

The harness marks each frame's enqueue and its read with
``record_function`` ranges (FRAME and READ).  The slice's window runs
from the first counted frame's enqueue to the last one's read; device
busy time is the union of the device's kernel, copy and set intervals
inside it, so busy time and wall time come from one window."""

from __future__ import annotations

import bisect
import dataclasses

FRAME = "fluidbench.enqueue"
READ = "fluidbench.read"
MARKS = (FRAME, READ)
TOP = 10
NAME = 160               # characters of a name kept in the breakdown


class IncompleteTrace(RuntimeError):
    """The slice shows fewer events of a kernel than the program's
    counters say it launched."""


@dataclasses.dataclass
class Slice:
    """One traced slice of ``frames`` whole frames (``steps`` steps).

    Times are in microseconds on the profiler's clock.  ``device``:
    (name, start, end) of each device operation inside the window;
    ``host``: (name, start, end) of each host event, sorted by start;
    ``counters``: the program's launch counts over the counted frames;
    ``spans``: the harness's host spans of every frame of the run's
    window, each (enqueue seconds, read seconds, steps, profiled);
    ``stam``: the cell's grid keywords."""
    frames: int
    steps: int
    start: float
    end: float
    device: list
    host: list
    counters: dict
    spans: list
    stam: dict

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def events(self, names) -> list:
        """The device operations whose name holds one of ``names``."""
        return [e for e in self.device if any(k in e[0] for k in names)]

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, sorted."""
        merged = []
        for _, s, e in sorted(self.device, key=lambda t: t[1]):
            s, e = max(s, self.start), min(e, self.end)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def gaps(self) -> list:
        """(start, end) of each stretch of the window with no device
        operation running."""
        out, t = [], self.start
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if t < self.end:
            out.append((t, self.end))
        return out

    def host_at(self, t: float, starts: list, marks: list) -> str:
        """What the host was doing at time t: the innermost host event
        that covers it (the latest started; "python" where none does),
        prefixed by the harness's mark that covers it.  ``starts``: the
        host events' start times; ``marks``: the marks as (start, end,
        name), sorted."""
        i = bisect.bisect_right(starts, t)
        op = next((name for name, s, e in reversed(self.host[max(0, i - 256):i])
                   if e >= t and name not in MARKS), "python")
        j = bisect.bisect_right(marks, (t, float("inf"))) - 1
        if j >= 0 and marks[j][1] >= t:
            return f"{marks[j][2].split('.')[-1]}:{op}"
        return op

    def breakdown(self) -> dict:
        """The device operations of most time and the idle time by what
        the host was doing, seconds over the slice, at most TOP each."""
        ops = {}
        for name, s, e in self.device:
            ops[name[:NAME]] = ops.get(name[:NAME], 0.0) + (e - s) / 1e6
        idle, starts = {}, [h[1] for h in self.host]
        marks = sorted((s, e, name) for name, s, e in self.host if name in MARKS)
        for s, e in self.gaps():
            label = self.host_at(0.5 * (s + e), starts, marks)[:NAME]
            idle[label] = idle.get(label, 0.0) + (e - s) / 1e6
        top = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}


def reduce(events, counted_frames: int, steps_per_frame: int, counters,
           spans, stam) -> Slice:
    """A Slice of the last ``counted_frames`` frames that the profiler
    recorded, from its events (``prof.events()``): device operations
    (the harness's marks, which the profiler also puts on the device's
    timeline, are left out) and host events."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in events:
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == cuda:
            if e.name not in MARKS:
                device.append(item)
        else:
            host.append(item)
    host.sort(key=lambda h: h[1])
    frames = sorted(h for h in host if h[0] == FRAME)
    reads = sorted((h for h in host if h[0] == READ), key=lambda h: h[1])
    if len(frames) < counted_frames or len(reads) < counted_frames:
        raise IncompleteTrace(f"{len(frames)} frames and {len(reads)} reads "
                              f"traced, {counted_frames} wanted")
    start, end = frames[-counted_frames][1], reads[-1][2]
    device = [d for d in device if d[2] > start and d[1] < end]
    host = [h for h in host if h[2] > start and h[1] < end]
    return Slice(counted_frames, counted_frames * steps_per_frame, start,
                 end, device, host, counters, spans, stam)


def kernel_share(tr: Slice, kernel) -> float | None:
    """A kernel's share of its roofline in per cent: the least time of
    the calls the program's counter ``kernel.COUNTER`` made in the slice,
    by ``kernel.work`` (which covers ``kernel.CALLS`` calls), over the
    device time of the events named
    ``kernel.NAMES``.  None where the counter made no call in the slice;
    raises IncompleteTrace where the slice holds fewer events of the
    first name than calls, none included (a kernel renamed, or its work
    moved into another kernel, fails the run rather than going quiet)."""
    from fluidbench.roofline import peaks
    calls = tr.counters.get(kernel.COUNTER, 0)
    if not calls:
        return None
    events = tr.events(kernel.NAMES)
    firsts = len(tr.events(kernel.NAMES[:1]))
    if firsts < calls:
        raise IncompleteTrace(f"{firsts} events of {kernel.NAMES[0]} for "
                              f"{calls} calls of {kernel.COUNTER}")
    least = calls / kernel.CALLS * sum(peaks.bound_s(*w)[0]
                                       for w in kernel.work(tr.stam))
    device_s = sum(e - s for _, s, e in events) / 1e6
    return 100.0 * least / device_s
