"""The benchmark of tpufluids_torch on one NVIDIA H100: one run of one
cell of BENCHMARK.json.

    python3 fluidbench/run.py --workload stam3d-256.rbjacobi --seed 7 \
        --seconds 20 --trace 0

The run finds the cell in BENCHMARK.json, loads its configuration,
traffic and limits by name, makes the scene from the seed on the card,
warms up the cell's own shapes, and then runs frames back to back for
``--seconds``: the window is the frames that start inside it.  With
``--trace 0`` it reports the end-to-end metrics; with ``--trace 1`` the
profiler records a fixed slice of whole frames and the run reports the
per-layer metrics, each read by its own reader in metrics/.  After the
window it compares the checked frames with the plain reference and
prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics, device and, last, the numbers compared with
their limits, which also end standard error.  Without a CUDA device, or
with fewer than the cell asks for, it exits with code 2 and prints no
result.
"""

import os
import time

T0 = time.perf_counter()


def _since_process_start() -> float:
    """Seconds from the process's start to now, from /proc (0 elsewhere):
    the interpreter's own start-up belongs to the set-up too."""
    try:
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return max(0.0, up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


BEFORE_T0 = _since_process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
from contextlib import nullcontext  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every cache the program or torch may write stays at a fixed path in the
# checkout (the port's own kernels build into build/kernels/)
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[_var] = str(ROOT / "build" / _dir)

from fluidbench import common, trace  # noqa: E402

SLICE_TRIES = 3


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def require_devices(chips: int):
    """Exit with code 2, and no result, without ``chips`` CUDA devices."""
    import torch
    if not torch.cuda.is_available():
        common.say("no CUDA device: this benchmark measures the card and "
                   "does not fall back to the CPU")
        raise SystemExit(2)
    if torch.cuda.device_count() < chips:
        common.say(f"{torch.cuda.device_count()} CUDA devices, the cell "
                   f"asks for {chips}")
        raise SystemExit(2)


class Window:
    """The frames of one run and, with tracing, its profiled slice."""

    def __init__(self, sim, seconds: float, traced: bool):
        self.sim, self.seconds, self.traced = sim, seconds, traced
        self.spans = []           # (enqueue s, read s, steps, profiled)
        self.start = self.window_end = None
        self.window_frames = 0
        self.slice = None         # the trace.Slice that was complete
        self.per_layer = {}
        self.tries = 0

    def frame(self, profiled: bool):
        """One frame: enqueue, then the residual's read; in the traced
        slice each inside its record_function mark."""
        from torch.profiler import record_function
        mark = record_function if profiled else lambda name: nullcontext()
        sim = self.sim
        t0 = time.perf_counter()
        with mark(trace.FRAME):
            res = sim.enqueue()
        t1 = time.perf_counter()
        with mark(trace.READ):
            sim.read(res)
        t2 = time.perf_counter()
        self.spans.append((t1 - t0, t2 - t1, sim.frame_steps, profiled))
        if self.start is None:
            self.start = t0
        if not profiled:
            self.window_end = t2

    def run(self, readers: dict):
        """Frames until ``seconds`` have passed since the first began;
        then, with tracing, a slice of the traffic's trace_frames
        counted frames after one lead-in frame, made again (up to
        SLICE_TRIES times) if the profiler missed events.  The slice
        follows the window, so the window's frames run as in an
        untraced run and no profiler state lingers in them."""
        self.frame(False)
        while time.perf_counter() - self.start < self.seconds:
            self.frame(False)
        self.window_frames = len(self.spans)
        while self.traced and self.slice is None and self.tries < SLICE_TRIES:
            self.profile_slice(readers)

    def profile_slice(self, readers: dict):
        from torch.profiler import ProfilerActivity, profile
        sim, k = self.sim, self.sim.trace_frames
        self.tries += 1
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            self.frame(True)                       # lead-in, not counted
            before = sim.counters()
            for _ in range(k):
                self.frame(True)
            after = sim.counters()
        counts = {name: after[name] - before[name] for name in after
                  if after[name] != before[name]}
        t0 = time.perf_counter()
        try:
            tr = trace.reduce(prof.events(), k, sim.frame_steps, counts,
                              self.spans, sim.kw)
            values = {name: read(tr) for name, read in readers.items()}
        except trace.IncompleteTrace as e:
            common.say(f"traced slice {self.tries}: {e}")
            return
        common.say(f"traced slice: {len(tr.device)} device and "
                   f"{len(tr.host)} host events, read in "
                   f"{time.perf_counter() - t0:.3f} s")
        self.slice = tr
        self.per_layer = {name: v for name, v in values.items()
                          if v is not None}


def run(args, device="cuda", require=True, overrides=None) -> dict:
    """One run; returns the result object (``correct`` ... ``checks``).
    ``require`` False skips the look for a card (the harness's tests);
    ``overrides`` switches the program onto another path (a control's
    lower precision: calibrate.py)."""
    import torch
    torch.set_num_threads(1)
    man = common.manifest()
    w = common.workload(man, args.workload)
    config, traffic, limits = common.cell_files(w)
    if require:
        require_devices(w["chips"])
    driver = common.module("drivers", config["driver"])
    sim = driver.setup(config, traffic, limits, args.seed, device, overrides)
    sim.warmup()
    if device != "cpu":
        torch.cuda.synchronize()
    setup_s = BEFORE_T0 + time.perf_counter() - T0

    readers = {}
    if args.trace:
        readers = {m["name"]: common.reader(m["name"])
                   for m in common.per_layer(man, w)}
    win = Window(sim, args.seconds, bool(args.trace))
    win.run(readers)
    if args.trace and win.slice is None:
        raise SystemExit(f"no complete traced slice in {SLICE_TRIES} tries")

    cuda = device != "cpu"
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    sim.release()
    found = common.forbidden_modules(sys.modules)
    if found:
        common.say(f"modules of JAX or the JAX package loaded: {found}")
        raise SystemExit(3)

    frames = win.window_frames
    frame_s = [a + b for a, b, _, _ in win.spans[:frames]]
    window_s = win.window_end - win.start
    common.say(f"{args.workload}: {frames} frames of {sim.frame_steps} "
               f"steps in {window_s:.6f} s; set-up {setup_s:.6f} s")
    q = sorted(frame_s)
    common.say("frame ms: min {:.4f}, quartiles {:.4f} {:.4f} {:.4f}, "
               "p95 {:.4f}, max {:.4f}".format(
                   1e3 * q[0], *(1e3 * v for v in (
                       common.quartiles(q) if len(q) > 1 else (q[0],) * 3)),
                   1e3 * common.p95(q), 1e3 * q[-1]))
    longest = max(range(frames), key=frame_s.__getitem__)
    common.say(f"longest frame: #{longest} of {frames}, enqueue "
               f"{1e3 * win.spans[longest][0]:.4f} ms, read "
               f"{1e3 * win.spans[longest][1]:.4f} ms")
    if args.trace:
        metrics = {m["name"]: {"value": win.per_layer[m["name"]],
                               "unit": m["unit"]}
                   for m in common.per_layer(man, w)
                   if m["name"] in win.per_layer}
    else:
        values = {"updates_per_s": sim.updates_per_frame * frames / window_s,
                  "frame_ms_p95": 1e3 * common.p95(frame_s),
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[common.quantity(m["name"])],
                               "unit": m["unit"]}
                   for m in common.end_to_end(man, w)}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": "cpu",
           "count": w["chips"], "memory_peak_bytes": peak}
    if cuda:
        facts = common.card_facts()
        print(f"card: {facts['kind']}, {facts['count']} devices, power "
              f"limit {facts['power_limit']}; after the window: "
              f"{facts['state']}", flush=True)
        dev["kind"], dev["count"] = facts["kind"], facts["count"]
    if args.trace:
        dev["busy_s"] = win.slice.busy_s()
        dev["window_s"] = win.slice.window_s

    checks = sim.check()
    for line in sim.describe():
        common.say(line)
    correct = all(value <= limit for _, value, limit in checks)
    out = {"correct": correct, "attempted": len(win.spans),
           "failed": sim.failed_frames(), "metrics": metrics, "device": dev}
    if args.trace:
        out["breakdown"] = win.slice.breakdown()
    # a number that is not finite goes out as a string: JSON has no NaN
    out["checks"] = {name: {"value": value if math.isfinite(value)
                            else str(value), "limit": limit}
                     for name, value, limit in checks}
    return out


def main(argv=None):
    args = parse(argv)
    out = run(args)
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        common.say(f"check {name}: {c['value']!r} limit {c['limit']!r}")


if __name__ == "__main__":
    main()
