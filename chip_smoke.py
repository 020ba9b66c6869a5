"""Smoke run of the PyTorch/CUDA port (tpufluids_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the four CUDA kernels from tpufluids_torch/csrc and prints
   nvcc's register, spill and shared-memory lines.
2. Holds each kernel against its plain PyTorch version at 256^3, on
   seeded inputs with set_bnd-consistent ghosts, and times both with
   CUDA events.
3. Runs 4 steps of the bench.py scene at 16^3 on the card and on the
   CPU (plain versions) and compares them.
4. Drives the bench.py scene at 256^3 through
   tpufluids_torch.grid.stam.run3d_python: one step through the kernels
   against one step through the plain versions, then 3 warm-up and 30
   timed steps.  Checks shape, finiteness, the final Poisson residual
   and the kernel launches per step.

Prints the kernels' JSON line, the card's name and power limit, and as
its last line {"ok": true, "device": {...}}.  Exits non-zero, without
that line, when there is no CUDA device, when the package is missing,
or when any check fails.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

N_BIG = 256
SEED = 0
FIELDS = ("u", "v", "w", "dens", "temp")
WARMUP, TIMED = 3, 30
TIME_REPS = 20
MAX_RESIDUAL = 1e-8
STEP_TOL = 1e-5          # one or four steps, relative to max|field|
LAUNCHES_PER_STEP = {"advect3d_multi": 2, "forcing3d": 1, "div3d": 2,
                     "gradsub3d": 2}
# kernel name -> (source, Pallas kernel it replaces, tolerance relative
# to max|plain output|)
KERNELS = {
    "advect3d_multi": ("tpufluids_torch/csrc/advect.cu",
                       "tpufluids/grid/pallas_kernels.py:1523", 3e-6),
    "forcing3d": ("tpufluids_torch/csrc/forcing.cu",
                  "tpufluids/grid/pallas_kernels.py:836", 3e-6),
    "div3d": ("tpufluids_torch/csrc/divgrad.cu",
              "tpufluids/grid/pallas_kernels.py:971", 1e-6),
    "gradsub3d": ("tpufluids_torch/csrc/divgrad.cu",
                  "tpufluids/grid/pallas_kernels.py:1057", 1e-6),
}


class SmokeFailure(RuntimeError):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)


def log(*a):
    print(*a, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def bench_config(stam, n):
    """bench.py's headline configuration (bench.py:138-149)."""
    return stam.StamConfig(n=n, dt=0.5 / n, jacobi_iters=20, red_black=True,
                           vorticity_eps=2.0, buoyancy_beta=0.5,
                           buoyancy_alpha=0.05, advect_mode="stencil",
                           projection="dct", dct_precision_first="default")


def bench_state(stam, cfg, device):
    """bench.py's seeded() scene (bench.py:151-156)."""
    s = stam.make_grid3d(cfg, device)
    k = cfg.n // 8
    s.dens[3 * k:5 * k, 3 * k:5 * k, 1:k] = 1.0
    s.temp[3 * k:5 * k, 3 * k:5 * k, 1:k] = 3.0
    return s


def rel_err(got, want):
    """(max |got - want|, max of |got - want| / max|want| per pair) over
    paired tensors."""
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    rels = [e / max(float(w.abs().max()), 1e-30)
            for e, w in zip(errs, want)]
    return max(errs), max(rels)


def time_ms(fn):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIME_REPS):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / TIME_REPS


@contextlib.contextmanager
def plain_kernels(kernels):
    """Route the step's kernel calls to the plain versions."""
    saved = {name: getattr(kernels, name) for name in KERNELS}
    for name in KERNELS:
        setattr(kernels, name, getattr(kernels, name + "_plain"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)


def check_kernels(stam, kernels, dev):
    """Each kernel against its plain version at 256^3; returns per-kernel
    {"max_abs_err", "ms", "plain_ms"}."""
    n = N_BIG
    cfg = bench_config(stam, n)
    dt0 = cfg.dt * n
    rng = np.random.default_rng(SEED)

    def field(b, lo, hi):
        a = rng.uniform(lo, hi, (n + 2,) * 3).astype(np.float32)
        return stam.set_bnd3d(b, torch.from_numpy(a).to(dev))

    # velocities up to 1.2 cells per step: the one-cell clamp is exercised
    u, v, w = (field(b, -1.2 / dt0, 1.2 / dt0) for b in (1, 2, 3))
    dens, temp, p = (field(0, 0.0, 1.0) for _ in range(3))
    calls = {
        "advect3d_multi": [((u, v, w), (1, 2, 3), u, v, w, dt0),
                           ((dens, temp), (0, 0), u, v, w, dt0)],
        "forcing3d": [(u, v, w, dens, temp, cfg)],
        "div3d": [(u, v, w)],
        "gradsub3d": [(p, u, v, w)],
    }
    results = {}
    for name, arg_sets in calls.items():
        kern = getattr(kernels, name)
        plain = getattr(kernels, name + "_plain")
        err = rel = 0.0
        for args in arg_sets:
            got, want = kern(*args), plain(*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            check(all(g.shape == w_.shape for g, w_ in zip(got, want)),
                  f"{name}: output shapes")
            e, r = rel_err(got, want)
            err, rel = max(err, e), max(rel, r)
        tol = KERNELS[name][2]
        # per launch, averaged over the call shapes of the step
        ms = [time_ms(lambda a=a: kern(*a)) for a in arg_sets]
        plain_ms = [time_ms(lambda a=a: plain(*a)) for a in arg_sets]
        log(f"kernel {name} @ {n}^3: max_abs_err {err:.3e} "
            f"(relative {rel:.3e}, tolerance {tol:.0e}); "
            f"ms per call: kernel {ms}, plain {plain_ms}")
        ms, plain_ms = np.mean(ms), np.mean(plain_ms)
        check(rel <= tol, f"{name}: kernel disagrees with its plain version "
                          f"({rel:.3e} > {tol:.0e})")
        results[name] = {"max_abs_err": err, "ms": float(ms),
                         "plain_ms": float(plain_ms)}
    return results


def check_small_against_cpu(stam, dev):
    """4 bench steps at 16^3 on the card (kernels) against the CPU (plain
    versions).  The first solve runs at "highest" here: its TF32 tier on
    the card is the one intended difference from the CPU."""
    cfg = bench_config(stam, 16).replace(dct_precision_first="highest")
    gpu, gres = stam.run3d_python(bench_state(stam, cfg, dev), cfg, 4)
    cpu, cres = stam.run3d_python(bench_state(stam, cfg, "cpu"), cfg, 4)
    e, r = rel_err([getattr(gpu, f).cpu() for f in FIELDS],
                   [getattr(cpu, f) for f in FIELDS])
    log(f"16^3, 4 steps, card vs CPU: max_abs_err {e:.3e} (relative "
        f"{r:.3e}, tolerance {STEP_TOL:.0e}); residual card "
        f"{float(gres[0]):.3e}, CPU {float(cres[0]):.3e}")
    check(r <= STEP_TOL, "16^3 steps: card and CPU disagree")


def run_main_path(stam, kernels, dev):
    n = N_BIG
    cfg = bench_config(stam, n)
    state = bench_state(stam, cfg, dev)

    one = stam.step3d(state, cfg)
    with plain_kernels(kernels):
        ref = stam.step3d(state, cfg)
    torch.cuda.synchronize()
    e, r = rel_err([getattr(one, f) for f in FIELDS],
                   [getattr(ref, f) for f in FIELDS])
    log(f"{n}^3, one step, kernels vs plain versions: max_abs_err {e:.3e} "
        f"(relative {r:.3e}, tolerance {STEP_TOL:.0e})")
    check(r <= STEP_TOL, "one 256^3 step: kernels and plain versions "
                         "disagree")
    del one, ref

    state, res = stam.run3d_python(state, cfg, WARMUP)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, res = stam.run3d_python(state, cfg, TIMED)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()

    ms = seconds / TIMED * 1e3
    residual = float(res[0])
    finite = all(bool(torch.isfinite(getattr(state, f)).all())
                 for f in FIELDS)
    per_step = {k: c / TIMED for k, c in counts.items()}
    log(f"{n}^3 bench scene, {TIMED} timed steps after {WARMUP} warm-up: "
        f"{ms:.4f} ms/step, {n ** 3 / (ms / 1e3):.4e} cell-updates/s, "
        f"final residual {residual:.3e}, finite {finite}")
    log(f"launches per step: {per_step}")
    check(all(getattr(state, f).shape == (n + 2,) * 3 for f in FIELDS),
          "field shapes")
    check(finite, "fields not finite")
    check(residual <= MAX_RESIDUAL, f"final residual {residual:.3e} > "
                                    f"{MAX_RESIDUAL:.0e}")
    check(per_step == LAUNCHES_PER_STEP,
          f"launches per step {per_step} != {LAUNCHES_PER_STEP}")
    check(float(state.w.abs().max()) > 0.0, "the plume did not move")
    return counts


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port is only measured on "
              "the card", file=sys.stderr)
        return 2
    from tpufluids_torch import _build
    from tpufluids_torch.grid import kernels, stam

    dev = torch.device("cuda")
    log(f"card (name, power limit): {card_line()}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    log(f"torch {torch.__version__}, torch.version.cuda "
        f"{torch.version.cuda}, nvcc: {nvcc.strip().splitlines()[-1]}")
    build = _build.build()
    log(f"kernel build: {build.seconds:.1f} s -> {build.path.name}")
    for line in build.log.splitlines():
        if any(key in line for key in ("registers", "spill", "smem",
                                       "Compiling entry")):
            log("  ptxas: " + line.strip())

    checked = check_kernels(stam, kernels, dev)
    check_small_against_cpu(stam, dev)
    counts = run_main_path(stam, kernels, dev)

    rows = []
    for name, (source, replaces, _) in KERNELS.items():
        check(counts[name] > 0, f"{name} was not launched on the main path")
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": counts[name],
                     **checked[name]})
    log(card_line())
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
