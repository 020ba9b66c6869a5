"""The program's spans (``tpufluids_torch.diagnostics``) in a cell: what
each layer of the grid step costs the host and the device, and what the
process spends in set-up.

    python3 fluidbench/spans.py --workload stam3d-256.dct --seed 7

The run makes the cell's simulation as run.py does, with spans on from
before the set-up through the warm-up (the set-up's split).  Then, with
the profiler off, it runs blocks of ``trace_frames`` frames with spans
off and on in turn (off, on, on, off, twice): the host's enqueue a
step each way, and the spans' stretch, the on blocks' records, which give each
span's host time.  Then it profiles a lead-in frame and
``trace_frames`` counted frames, marked as run.py marks them, once with
spans on and once with them off, and reduces each slice with
``trace.reduce``.  In the slice with spans on each device operation is
linked by correlation id to the host event that launched it (the
innermost profiler range open at the launch) and counted for every
program span around that event on its thread (``attribute``).  The run
prints the span table and the set-up split on standard error and, as
the last line of standard output, one JSON object: the per-layer
metrics that read the spans (metrics/<name>.py, on a ``TracedSlice``),
the slice's existing per-layer metrics with spans on and off, and the
checks that spans change nothing.  Nothing here runs in a ``run.py``
run."""

import argparse
import bisect
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# run.py's import starts the set-up's clock and fixes the caches' paths
from fluidbench import common, run, trace  # noqa: E402

PREFIXES = ("grid.", "kernels.")     # the program's span names
SOLVE = "grid.solve"
FRAME = "grid.frame"
# the per-layer metrics that read the spans (metrics/<name>.py)
NAMES = ("solve_device_ms_per_step", "solve_launches_per_step",
         "solve_enqueue_ms_per_step", "dct_solve_roofline",
         "setup_program_s")
SLICE_TRIES = 3


def is_program(name: str) -> bool:
    return name.startswith(PREFIXES)


def name_of(label: str) -> str:
    """A span's name: its profiler label without ``:detail``."""
    return label.split(":", 1)[0]


@dataclasses.dataclass
class Program:
    """What the spans say over a slice and a spans' stretch.

    ``steps``: the slice's steps; ``device_us``, ``ops``: per span name
    and per label, the device time and operations launched inside the
    span (inclusive: an operation counts for every span around its
    launch); ``events``: per label, the span's host events in the
    slice; ``stretch_steps``, ``host_ns``: the steps of the spans'
    stretch and the host time per name and label inside the spans
    there; ``setup_frame_s``: the host seconds of the warm-up's
    grid.frame span."""
    steps: int
    device_us: dict
    ops: dict
    events: dict
    stretch_steps: int = 0
    host_ns: dict = dataclasses.field(default_factory=dict)
    setup_frame_s: float | None = None


@dataclasses.dataclass
class TracedSlice(trace.Slice):
    """A trace.Slice with the program's spans (None: none recorded)."""
    program: Program | None = None


class Tree:
    """The program spans of one thread as nested intervals, each with
    the index of the span around it, for the innermost span that holds
    a time or an interval."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda h: (h[1], -h[2]))
        self.starts = [h[1] for h in self.spans]
        self.parent, stack = [], []
        for i, (_, s, e, *_rest) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][2] < e:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)
        self._chains = {}

    def innermost(self, start: float, end: float) -> int:
        """The index of the innermost span that holds [start, end]; -1
        where none does."""
        j = bisect.bisect_right(self.starts, start) - 1
        while j >= 0 and self.spans[j][2] < end:
            j = self.parent[j]
        return j

    def chain(self, j: int) -> list:
        """The labels of span j and of every span around it."""
        if j not in self._chains:
            out, k = [], j
            while k >= 0:
                out.append(self.spans[k][0])
                k = self.parent[k]
            self._chains[j] = out
        return self._chains[j]


def host_events(events) -> list:
    """(name, start, end, thread, launched) of each host event of
    ``prof.events()``; ``launched``: (name, device us) of each device
    operation that the profiler linked to it by correlation id (the
    innermost profiler range open at the launch).  A user annotation
    (``record_function``, the harness's marks) also puts an event of its
    name on the device's timeline; that is no device operation and is
    left out."""
    cpu = __import__("torch").autograd.DeviceType.CPU
    notes = {e.name for e in events if e.is_user_annotation}
    return [(e.name, float(e.time_range.start), float(e.time_range.end),
             e.thread, [(k.name, k.duration) for k in e.kernels
                        if k.name not in notes])
            for e in events if e.device_type == cpu]


def trees(host) -> dict:
    """{thread: the Tree of its program spans} of host events."""
    by_thread = {}
    for h in host:
        if is_program(h[0]):
            by_thread.setdefault(h[3], []).append(h)
    return {t: Tree(spans) for t, spans in by_thread.items()}


def attribute(host) -> tuple[dict, dict, int]:
    """Each device operation launched inside a host event (``host_events``)
    counted for every program span that holds that event on its thread.
    Returns ({label or name: device us}, {label or name: operations},
    operations inside no span)."""
    by_thread = trees(host)
    device_us, ops, alone = {}, {}, 0
    for _, start, end, thread, launched in host:
        if not launched:
            continue
        tree = by_thread.get(thread)
        j = tree.innermost(start, end) if tree else -1
        if j < 0:
            alone += len(launched)
            continue
        labels = tree.chain(j)
        us = sum(d for _, d in launched)
        for key in {*labels, *map(name_of, labels)}:
            device_us[key] = device_us.get(key, 0.0) + us
            ops[key] = ops.get(key, 0) + len(launched)
    return device_us, ops, alone


def stretch(records) -> dict:
    """{label or name: host ns} of recorder records, each span counted
    under its label and under its name."""
    host_ns = {}
    for r in records:
        for key in {r.label, r.name}:
            host_ns[key] = host_ns.get(key, 0) + r.end_ns - r.start_ns
    return host_ns


def program_of(tr: trace.Slice, events, records, counted_frames: int):
    """The Program of slice ``tr`` from the profiler's ``events``, held
    to the recorder's ``records`` of the same frames: raises
    IncompleteTrace where the slice's grid.solve events and the
    recorder's grid.solve spans of the counted frames differ."""
    host = [h for h in host_events(events) if tr.start <= h[1] <= tr.end]
    device_us, ops, _ = attribute(host)
    found = {}
    for name, *_ in host:
        if is_program(name):
            found[name] = found.get(name, 0) + 1
    last = max((r.frame for r in records), default=-1)
    want = sum(r.name == SOLVE and r.frame > last - counted_frames
               for r in records)
    got = sum(n for label, n in found.items() if name_of(label) == SOLVE)
    if got != want:
        raise trace.IncompleteTrace(f"{got} {SOLVE} events in the slice, "
                                    f"{want} spans recorded")
    return Program(tr.steps, device_us, ops, found)


def with_program(tr: trace.Slice, program: Program) -> TracedSlice:
    return TracedSlice(**{f.name: getattr(tr, f.name)
                          for f in dataclasses.fields(trace.Slice)},
                       program=program)


def suffix(man: dict, w: dict) -> str:
    """".host_paced" in a cell whose pace is the host's, else ""."""
    moves = {m["name"] for m in common.end_to_end(man, w)}
    return ".host_paced" if "updates_per_s.host_paced" in moves else ""


# ---------------------------------------------------------------------------
# the run


def frames(win, count: int, profiled: bool = False) -> list:
    """``count`` frames of run.py's Window, each marked as run.py marks
    it in a profiled slice; (enqueue s, read s, steps, profiled) each."""
    for _ in range(count):
        win.frame(profiled)
    return win.spans[-count:]


def blocks(win, diagnostics) -> tuple[list, list, list]:
    """Blocks of trace_frames frames with spans off, on, on, off, off,
    on, on, off; returns (the off frames, the on frames, the on blocks'
    records)."""
    off, on, records = [], [], []
    for spans_on in (False, True, True, False) * 2:
        diagnostics.tracing(spans_on)
        diagnostics.clear_spans()
        got = frames(win, win.sim.trace_frames)
        (on if spans_on else off).extend(got)
        records += diagnostics.spans() if spans_on else []
    diagnostics.tracing(False)
    return off, on, records


def profiled_slice(win, diagnostics, spans_on: bool, plain: list,
                   readers: dict):
    """A lead-in frame and trace_frames counted frames under the
    profiler, spans on or off; (slice, events, {name: what ``readers``
    read}), made again on an incomplete trace, at most SLICE_TRIES
    times.  ``plain``: the frames without the profiler that the slice's
    span readers (enqueue_ms_per_step, step_mfu) read."""
    from torch.profiler import ProfilerActivity, profile
    sim = win.sim
    k = sim.trace_frames
    for attempt in range(1, SLICE_TRIES + 1):
        diagnostics.tracing(spans_on)
        diagnostics.clear_spans()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            frames(win, 1, True)
            before = sim.counters()
            frames(win, k, True)
            after = sim.counters()
        diagnostics.tracing(False)
        counts = {n: after[n] - before[n] for n in after
                  if after[n] != before[n]}
        events = prof.events()
        try:
            tr = trace.reduce(events, k, sim.frame_steps, counts, plain,
                              sim.kw)
            if spans_on:
                tr = with_program(tr, program_of(tr, events,
                                                 diagnostics.spans(), k))
            return tr, events, {n: read(tr) for n, read in readers.items()}
        except trace.IncompleteTrace as e:
            common.say(f"slice {attempt} (spans {spans_on}): {e}")
    raise SystemExit(f"no complete slice in {SLICE_TRIES} tries")


def idle_in_spans(tr: TracedSlice, events) -> dict:
    """Idle seconds of the slice by the innermost program span open on
    the host at the gap's middle (any look-back), and the part of them
    that the breakdown (``Slice.host_at``, 256 host events back) labels
    "python", finding no host event open."""
    by_thread = trees(host_events(events))
    starts = [h[1] for h in tr.host]
    marks = sorted((s, e, n) for n, s, e in tr.host if n in trace.MARKS)
    by_span, missed = {}, 0.0
    for s, e in tr.gaps():
        t = 0.5 * (s + e)
        label = "none"
        for tree in by_thread.values():
            j = tree.innermost(t, t)
            if j >= 0:
                label = tree.spans[j][0]
        by_span[label] = by_span.get(label, 0.0) + (e - s) / 1e6
        if label != "none" and tr.host_at(t, starts, marks).endswith(
                "python"):
            missed += (e - s) / 1e6
    return {"by_span": by_span, "missed_by_host_at_s": missed}


def span_cost(diagnostics, n: int = 2000, loops: int = 100) -> dict:
    """The host's cost of one span with tracing off and on (no
    profiler), us: the median and the least of ``loops`` loops of ``n``
    spans (the records cleared after each, as a frame's few hundred
    are), each less an empty loop."""
    out = {}
    for on in (False, True):
        diagnostics.tracing(on)
        costs = []
        for _ in range(loops):
            diagnostics.clear_spans()
            t0 = time.perf_counter()
            for _ in range(n):
                with diagnostics.span(SOLVE, "dct"):
                    pass
            t1 = time.perf_counter()
            for _ in range(n):
                pass
            costs.append(1e6 * (2 * t1 - t0 - time.perf_counter()) / n)
        costs.sort()
        key = "on" if on else "off"
        out[f"{key}_us"], out[f"{key}_least_us"] = costs[loops // 2], costs[0]
    diagnostics.tracing(False)
    diagnostics.clear_spans()
    return out


def same_frame(sim, diagnostics, fields) -> bool:
    """A frame from the simulation's state gives the same ``fields`` and
    residual bit for bit with spans on and off."""
    import torch
    outs = []
    for on in (True, False):
        diagnostics.tracing(on)
        state = sim.stam_mod.GridState3D(**{
            f: getattr(sim.state, f).clone() for f in fields})
        outs.append(sim.stam_mod.run3d_python(state, sim.cfg,
                                              sim.frame_steps))
        diagnostics.tracing(False)
    (a, ra), (b, rb) = outs
    return bool(torch.equal(ra, rb)) and all(
        torch.equal(getattr(a, f), getattr(b, f)) for f in fields)


def table(tr: TracedSlice) -> list:
    """Per label: spans a step (slice), host ms a step (the spans'
    stretch), device ms and operations a step (slice)."""
    p = tr.program
    rows = []
    for label in sorted(p.events, key=lambda k: -p.device_us.get(k, 0.0)):
        host = p.host_ns.get(label)
        rows.append((label, p.events[label] / p.steps,
                     host / 1e6 / p.stretch_steps if host is not None
                     else None,
                     p.device_us.get(label, 0.0) / 1e3 / p.steps,
                     p.ops.get(label, 0) / p.steps))
    return rows


def measure(workload: str, seed: int, device="cuda", require=True) -> dict:
    import torch
    from tpufluids_torch import diagnostics
    torch.set_num_threads(1)
    man = common.manifest()
    w = common.workload(man, workload)
    config, traffic, limits = common.cell_files(w)
    if require:
        run.require_devices(w["chips"])
    cuda = device != "cpu"
    sync = torch.cuda.synchronize if cuda else lambda: None
    driver = common.module("drivers", config["driver"])

    diagnostics.tracing(True)
    diagnostics.clear_spans()
    sim = driver.setup(config, traffic, limits, seed, device)
    t_warm = time.perf_counter()
    sim.warmup()
    sync()
    t_ready = time.perf_counter()
    diagnostics.tracing(False)
    warm = diagnostics.spans()
    frame = next(r for r in warm if r.name == FRAME)
    loads = [r for r in warm if r.name == "kernels.load"]
    # perf_counter and the spans' perf_counter_ns share one clock
    setup = {
        "setup_s": run.BEFORE_T0 + t_ready - run.T0,
        "to_warmup_s": run.BEFORE_T0 + t_warm - run.T0,
        "warmup_frame_s": frame.seconds,
        "kernels_load": [[r.label, r.seconds] for r in loads],
        "read_s": t_ready - frame.end_ns / 1e9,
    }

    win = run.Window(sim, 0.0, True)
    off, on, records = blocks(win, diagnostics)
    readers = {m["name"]: common.reader(m["name"])
               for m in common.per_layer(man, w)}
    tr_on, events_on, now = profiled_slice(win, diagnostics, True, on,
                                           readers)
    tr_off, _, before = profiled_slice(win, diagnostics, False, off,
                                       readers)
    p = tr_on.program
    p.stretch_steps = sum(f[2] for f in on)
    p.host_ns = stretch(records)
    p.setup_frame_s = frame.seconds

    sfx = suffix(man, w)
    metrics = {}
    for name in NAMES:
        metrics[name + ("" if name == "setup_program_s" else sfx)] = (
            common.reader(name)(tr_on))
    existing = {name: [now[name], before[name]] for name in readers}
    labels = {r.label for r in records} | {r.label for r in warm}
    named = sorted({d[0] for d in tr_on.device} & labels)
    enqueue = {k: 1e3 * sum(f[0] for f in fs) / sum(f[2] for f in fs)
               for k, fs in (("off", off), ("on", on))}
    per_step = len(records) / p.stretch_steps
    out = {
        "workload": workload, "seed": seed, "metrics": metrics,
        "existing_on_off": existing,
        "device_events_named_after_spans": named,
        "device_ops_per_step_on_off": [len(tr_on.device) / tr_on.steps,
                                       len(tr_off.device) / tr_off.steps],
        "enqueue_ms_per_step": enqueue,
        "spans_per_step": per_step,
        "span_cost_us": span_cost(diagnostics),
        "same_frame_bit_for_bit": same_frame(sim, diagnostics, driver.FIELDS),
        "setup": setup,
        "idle": idle_in_spans(tr_on, events_on),
        "breakdown_spans_on": tr_on.breakdown(),
        "breakdown_spans_off": tr_off.breakdown(),
        "table": table(tr_on),
    }
    if cuda:
        facts = common.card_facts()
        out["device"] = {"kind": facts["kind"],
                         "power_limit": facts["power_limit"],
                         "state": facts["state"]}
    sim.release()
    return out


def report(out: dict):
    say = common.say
    say(f"{out['workload']} seed {out['seed']}: "
        f"{out['spans_per_step']:.2f} spans a step; enqueue ms/step spans "
        f"off {out['enqueue_ms_per_step']['off']:.4f}, on "
        f"{out['enqueue_ms_per_step']['on']:.4f}; a span costs "
        f"{out['span_cost_us']['off_us']:.3f} us off, "
        f"{out['span_cost_us']['on_us']:.3f} us on (medians)")
    say(f"{'span':28s} {'a step':>7s} {'host ms':>9s} {'device ms':>10s} "
        f"{'ops':>8s}")
    for label, n, host, dev, ops in out["table"]:
        say(f"{label:28s} {n:7.2f} "
            f"{'-' if host is None else f'{host:9.4f}':>9s} {dev:10.4f} "
            f"{ops:8.2f}")
    s = out["setup"]
    loads = ", ".join(f"{k} {v:.4f} s" for k, v in s["kernels_load"])
    say(f"set-up {s['setup_s']:.4f} s: to the warm-up "
        f"{s['to_warmup_s']:.4f} s, the warm-up's grid.frame "
        f"{s['warmup_frame_s']:.4f} s ({loads or 'no kernels.load'})")
    for name, value in out["metrics"].items():
        say(f"{name}: {value!r}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    out = measure(args.workload, args.seed)
    report(out)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
