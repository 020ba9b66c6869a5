"""Smoke run of the PyTorch/CUDA port (tpufluids_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from tpufluids_torch/csrc (one nvcc
   per source, in parallel) and prints nvcc's register, spill and
   shared-memory lines.
2. Holds each grid kernel against its plain PyTorch version, on seeded
   inputs with set_bnd-consistent ghosts, and times both with CUDA
   events at the main path's shapes: the stencil kernels and the
   streamed Jacobi and red-black pressure solves (a = 1, c = 6, b = 0)
   at 256^3, the whole tier (three-field diffusion, the fused projection
   and the whole step of config 4) at 64^3.  The solves are checked,
   untimed, at config 2's diffusion coefficients (b = 1) too, and the
   whole step of configs 2 and 4 must equal the separate kernels
   (stam.step3d_multi) bit for bit.
   The 2D kernels (csrc/grid2d.cu) at config 1's 130^2 fields: the
   solve (a = 1, c = 4, b = 0, and config 1's diffusion at b = 1) and
   the whole step (config 1, and config 1 with buoyancy and vorticity)
   must equal their plain versions bit for bit, and the whole step the
   multi-call step (stam.step2d_multi).
3. Runs 4 steps of the bench.py scene and of BASELINE configs 2 and 4
   at 16^3, and of BASELINE config 1 at 32^2, on the card and on the CPU
   (plain versions) and compares them.
4. Drives five 3D grid configurations through
   tpufluids_torch.grid.stam.run3d_python: the bench.py scene (DCT) and
   config 3 (red-black Jacobi, "jacobi continuity") at 256^3 for 3
   warm-up and 30 timed steps, config 3 with plain Jacobi for 3 and 10,
   configs 2 and 4 at 64^3 for 3 and 400, as bench.py times them, and
   the CLI's plume3d scene (gather advection, no whole step) at 64^3 for
   3 and 20.  Each first runs two steps through the kernels against two
   through the plain versions: one without the residual (at 64^3 the
   whole step, for stencil advection) and one with it.  Checks shape,
   finiteness, the final Poisson residual and the kernel launches of the
   timed run.  Then two 2D configurations through stam.run2d_python at
   128^2 with bench.py's sources: BASELINE config 1 (one whole-step
   launch a step) for 3 and 400 steps, and the CLI's smoke2d default
   (gather advection: five solve launches a step) for 3 and 100, with
   no host sync allowed; each first holds two steps through the kernels
   bitwise against two through the plain versions, and config 1's
   residual step against the plain one.  Every grid path then runs 10
   more steps under torch.profiler: device busy time, device ops a step,
   the device's idle share against the timed ms/step, the top kernels.
5. Holds the SPH force kernel (base_forces_rowblock) against its plain
   version at the base_dam scene and at a 262144-particle uniform fill,
   on seeded dens, press and vel, and times both with CUDA events.
6. Runs 10 base_dam steps on the card and on the CPU (plain version)
   and compares them by particle id; runs 10 steps of the fill twice
   on the card and requires bitwise-equal results.
7. Drives the SPH base step through tpufluids_torch.step.run_python:
   base_dam for 3 warm-up and 300 timed steps, the fill for 3 and 10,
   with no host sync allowed in the timed steps.  Checks finiteness,
   the alive count, the mass, the bin overflow, that the dam column
   falls, and one kernel launch per step.
8. Holds the unidyn force kernels (unidyn_forces_resident and
   unidyn_forces_rowblock, csrc/sph_unidyn.cu) against their plain
   versions on mixed-phase inputs: the reference's 14040-particle tank
   and a 46656-particle uniform fill at the tank's lattice density,
   with merging on at the fill.  Every output column must be nonzero.
   Times both with CUDA events.
9. Runs 10 steps of the tank cut to 2808 particles on the card and on
   the CPU, and 3 steps of a merging mixed-phase blob, and compares
   them by particle id.
10. Drives the unidyn step through run_python on the full tank: 3
    warm-up and 300 timed steps with no host sync allowed, one resident
    kernel call per step.  Checks the alive count, the mass, the bin
    overflow, finiteness, that the fluid stays inside the walls and
    falls.  Then 20 steps through the row-block kernel must equal 20
    resident steps bitwise, and two resident runs each other.
11. Holds the column force kernels against their plain versions and
    times both: base_forces_column (csrc/sph_forces.cu) fresh and stale
    (xy_cells) at a 524288-particle uniform fill at its suggest_col_cap
    (584) and at base_dam forced to cap 32, over which its columns run;
    unidyn_forces_column (csrc/sph_unidyn.cu) on the mixed tank at cap
    128, and on the mixed 46656 fill at cap 64.  Holds the row-block
    kernel's stale mode against its plain version at base_dam and the
    fill.  The overflow counts must be equal and the rows over the cap
    zero.  Then the identities, bit for bit: the column kernel equals
    the row-block kernel where no column overflows; with caps above every
    column its stale pass equals the row-block stale pass; on a
    just-sorted pool its stale pass equals its fresh one.
12. Drives four paths through run_python, each with no host sync
    allowed in its timed steps and a torch.profiler window: the 524288
    fill in "auto" (the column family) for 3 warm-up and 10 timed
    steps; the tank forced to the column family for 3 and 100; base_dam
    at sort_every 8 (the row-block kernel's stale mode) for 3 and 300;
    the fill at sort_every 8 (the column kernel's stale mode) for 3 and
    10.  Checks finiteness, the alive count, the mass, the bin overflow,
    one force launch a step and one sort step in 8.

Prints the kernels' JSON line, with each kernel's least time on the card
(its bound: the bytes it must move at 3.35 TB/s, or its float32
operations at 67 TFLOP/s, whichever is larger), the card's name and
power limit, and as its last line {"ok": true, "device": {...}}.
Exits non-zero, without that line, when there is no CUDA device, when
the package is missing, or when any check fails.
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
N_WHOLE = 64             # BASELINE configs 2 and 4: the whole tier
N_2D = 128               # BASELINE config 1
SEED = 0
FIELDS = ("u", "v", "w", "dens", "temp")
TIME_REPS = 20
PROFILE_STEPS = 10       # steps of each grid path under torch.profiler
# the DCT projection's limit; a Jacobi residual is held to the plain
# step's instead (twenty sweeps leave about 1e-5)
MAX_RESIDUAL = 1e-8
RESIDUAL_RTOL = 1e-3
STEP_TOL = 1e-5          # one or four steps, relative to max|field|
# the card's peaks (H100 SXM data sheet): bytes/s of device memory and
# float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
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
    "lin_solve3d": ("tpufluids_torch/csrc/jacobi.cu",
                    "tpufluids/grid/pallas_kernels.py:2455", 1e-6),
    "lin_solve3d_rb": ("tpufluids_torch/csrc/jacobi.cu",
                       "tpufluids/grid/pallas_kernels.py:2285", 1e-6),
    "diffuse3d_multi": ("tpufluids_torch/csrc/jacobi.cu",
                        "tpufluids/grid/pallas_kernels.py:247", 1e-6),
    "project3d_whole": ("tpufluids_torch/csrc/jacobi.cu",
                        "tpufluids/grid/pallas_kernels.py:1174", 1e-6),
    "step3d_whole": ("tpufluids_torch/csrc/step.cu",
                     "tpufluids/grid/pallas_kernels.py:1319", STEP_TOL),
    # bit for bit
    "lin_solve2d": ("tpufluids_torch/csrc/grid2d.cu",
                    "tpufluids/grid/pallas_kernels.py:1993", 0.0),
    "step2d_whole": ("tpufluids_torch/csrc/grid2d.cu",
                     "tpufluids/grid/pallas_kernels.py:2157", 0.0),
}
# float32 operations per interior cell of one call, counted from the
# kernels' sources (a min, max, sqrt or division counts as one): the
# backtrace weights (17 an axis) and per tap 2 weight products and a
# multiply-add per field; buoyancy 6 and vorticity confinement 70; the
# divergence 6; the gradient subtraction 5 a component; a Jacobi sweep
# 8 (5 adds, a multiply-add, a multiply); the whole step the sum of its
# phases.  In 2D: a Jacobi sweep 6; the divergence 4, the gradient
# subtraction 4 a component; the 9-tap advection of k fields 19 an axis
# for the weights and per tap a weight product and a multiply-add per
# field; buoyancy 6, vorticity confinement 27.  A solve's bound counts
# its sweeps' operations as if they could run at once: it ignores their
# serial dependence, which is what bounds the 2D kernels.


def step_ops(cfg):
    iters = cfg.jacobi_iters
    ops = 2 * (6 + 8 * iters + 15) + (51 + 27 * 8) + (51 + 27 * 6)
    ops += 6 if cfg.buoyancy_alpha or cfg.buoyancy_beta else 0
    ops += 70 if cfg.vorticity_eps else 0
    return ops + 8 * iters * (3 * bool(cfg.visc) + bool(cfg.diff)
                              + bool(cfg.temp_diff))


def step2d_ops(cfg):
    iters = cfg.jacobi_iters
    ops = 2 * (4 + 6 * iters + 8) + 2 * (38 + 9 * 5)
    ops += 6 if cfg.buoyancy_alpha or cfg.buoyancy_beta else 0
    ops += 27 if cfg.vorticity_eps else 0
    return ops + 6 * iters * (2 * bool(cfg.visc) + bool(cfg.diff)
                              + bool(cfg.temp_diff))


GRID_OPS = {
    "advect3d_multi": lambda a: 51 + 27 * (2 + 2 * len(a[0])),
    "forcing3d": lambda a: 76,
    "div3d": lambda a: 6,
    "gradsub3d": lambda a: 15,
    "lin_solve3d": lambda a: 8 * a[5],
    "lin_solve3d_rb": lambda a: 8 * a[5],
    "diffuse3d_multi": lambda a: 8 * a[2] * len(a[0]),
    "project3d_whole": lambda a: 6 + 8 * a[3] + 15,
    "step3d_whole": lambda a: step_ops(a[5]),
    "lin_solve2d": lambda a: 6 * a[5],
    "step2d_whole": lambda a: step2d_ops(a[4]),
}
# run3d_python's paths: name -> (configuration keywords, size, warm-up
# and timed steps)
BENCH_KW = dict(jacobi_iters=20, red_black=True, vorticity_eps=2.0,
                buoyancy_beta=0.5, buoyancy_alpha=0.05,
                advect_mode="stencil")                   # bench.py:138-140
CONFIG2_KW = dict(dt=0.05, diff=1e-5, visc=1e-5, jacobi_iters=20,
                  red_black=True, advect_mode="stencil")  # bench.py:327-329
PLUME_KW = dict(buoyancy_alpha=0.05, buoyancy_beta=1.0,
                vorticity_eps=2.0)                       # bench.py:324-326
GRID_PATHS = {
    "bench (DCT)": (dict(BENCH_KW, projection="dct",
                         dct_precision_first="default"), N_BIG, 3, 30),
    "config 3 (red-black Jacobi)": (dict(BENCH_KW, projection="jacobi"),
                                    N_BIG, 3, 30),
    "config 3, plain Jacobi": (dict(BENCH_KW, projection="jacobi",
                                    red_black=False), N_BIG, 3, 10),
    "config 2": (CONFIG2_KW, N_WHOLE, 3, 400),
    "config 4": ({**CONFIG2_KW, **PLUME_KW}, N_WHOLE, 3, 400),
    # the CLI's plume3d (cli.py:190-197, 250-255): its defaults, gather
    "plume3d (gather)": (dict(dt=0.05, diff=1e-5, visc=1e-5,
                              jacobi_iters=20, buoyancy_alpha=0.05,
                              buoyancy_beta=1.0, advect_mode="gather"),
                         N_WHOLE, 3, 20),
}
# run2d_python's paths, with bench.py's sources: name -> (configuration
# keywords, size, warm-up and timed steps)
CONFIG1_KW = dict(dt=0.1, diff=1e-5, visc=1e-5,
                  jacobi_iters=20)               # bench.py:305-306
GRID2D_PATHS = {
    "config 1": (dict(CONFIG1_KW, advect_mode="stencil"), N_2D, 3, 400),
    # python -m tpufluids.cli smoke2d: the StamConfig default advection
    "smoke2d (gather)": (CONFIG1_KW, N_2D, 3, 100),
}
FIELDS2D = ("u", "v", "dens", "temp")
# the SPH base step: 1e-5 * max|plain| for sum_w and each dpress column
SPH_KERNELS = {
    "base_forces_rowblock": ("tpufluids_torch/csrc/sph_forces.cu",
                             "tpufluids/sph_pallas.py:1438", 1e-5),
}
SPH_FILL = 262144             # step.ROWBLOCK_MAX_POOL
# (warm-up, timed) steps.  The random fill is not a stable scene: in
# both packages its close pairs drive the max speed up about tenfold
# every 3 steps from step ~12, to overflow by step ~25, so it is timed
# over its first 13 steps, where it is finite.
SPH_STEPS = {"base_dam": (3, 300), "fill": (3, 10)}
SPH_CHECK_STEPS = 10
# card against CPU, by particle id: tests/test_forces_vs_oracle.py's
# multi-step tolerances, with atol 1e-5 * max(1, max|CPU|)
SPH_TOLS = (("pos", 2e-4), ("vel", 2e-3), ("dens", 1e-4), ("press", 2e-3),
            ("acc", 2e-3))
# the unidyn step: 1e-5 * max|plain| for every output column
UNIDYN_KERNELS = {
    "unidyn_forces_resident": ("tpufluids_torch/csrc/sph_unidyn.cu",
                               "tpufluids/sph_pallas.py:1592", 1e-5),
    "unidyn_forces_rowblock": ("tpufluids_torch/csrc/sph_unidyn.cu",
                               "tpufluids/sph_pallas.py:1656", 1e-5),
}
UNIDYN_FIELDS = ("sum_w", "dpress", "diffusion", "vel_grad", "stress_accel",
                 "solid_drift", "fluid_drift", "mixture_accel", "delsolid",
                 "delfluid")
# a uniform fill of [-0.9, 0.9]^3 at the tank's lattice density, 8000 per
# unit volume
UNIDYN_FILL = 46656
UNIDYN_STEPS = (3, 300)
UNIDYN_BITWISE_STEPS = 20
# card against CPU: test_unidyn_step_matches_oracle's multi-step
# tolerances, with atol 1e-5 * max(1, max|CPU|)
UNIDYN_TOLS = (("pos", 2e-4), ("vel", 2e-3), ("dens", 1e-4),
               ("press", 2e-3), ("solid", 1e-3), ("fluid", 1e-3),
               ("stress", 2e-3))


# the column family (PERF.md rows 13 and 14): 1e-5 * max|plain| per output
# column, as the kernels they share their pair loops with
COLUMN_KERNELS = {
    "base_forces_column": ("tpufluids_torch/csrc/sph_forces.cu",
                           "tpufluids/sph_pallas.py:504", 1e-5),
    "unidyn_forces_column": ("tpufluids_torch/csrc/sph_unidyn.cu",
                             "tpufluids/sph_pallas.py:1105", 1e-5),
}
# the uniform fill of verify/bench_sph_scaling_ab.py:25-36 at 524288
# particles; "auto" sends it to the column family, at its suggest_col_cap
BIG_FILL = 524288
SORT_EVERY = 8
# the column and sort-cadence paths: name -> (scene, config changes,
# warm-up and timed steps).  The fill runs its first 13 steps, as the
# 262144 fill does (see SPH_STEPS).
COLUMN_PATHS = {
    "fill-524k, column": ("fill-524k", {}, 3, 10),
    "tank, column": ("tank", {"pallas_kernel": "column"}, 3, 100),
    "base_dam, sort_every 8": ("base_dam", {"sort_every": SORT_EVERY}, 3,
                               300),
    "fill-524k, sort_every 8": ("fill-524k", {"sort_every": SORT_EVERY}, 3,
                                10),
}
FILL_SPEED_STEPS = 20     # steps of the 524288 fill whose max speed is logged
# (calls, warm-up calls) timed of the column family's plain versions, whose
# stale passes gather whole columns: up to about a second a call
PLAIN_REPS = (3, 1)


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


def grid_config(stam, path, n=None):
    """The configuration of a GRID_PATHS entry at size n (its own by
    default); dt = 0.5 / n unless the entry sets it."""
    kw, size, _, _ = GRID_PATHS[path]
    n = n or size
    return stam.StamConfig(n=n, **{"dt": 0.5 / n, **kw})


def grid2d_config(stam, path, n=None):
    kw, size, _, _ = GRID2D_PATHS[path]
    return stam.StamConfig(n=n or size, **kw)


def grid2d_sources(n, device):
    """bench.py:308-311's sources at size n (cli.py:202-205): dens 5 and
    fv 2 in [n/2-4:n/2+4, 4:8]."""
    src = torch.zeros((n + 2, n + 2), dtype=torch.float32, device=device)
    fv = torch.zeros_like(src)
    src[n // 2 - 4:n // 2 + 4, 4:8] = 5.0
    fv[n // 2 - 4:n // 2 + 4, 4:8] = 2.0
    return {"dens": src, "fv": fv}


def grid_state(stam, path, cfg, device):
    """bench.py's seeding: dens 1 and temp 3 in [3k:5k, 3k:5k, 1:k],
    k = n/8 (bench.py:151-156), and in [24:40, 24:40, 1:9] at 64^3 for
    configs 2 and 4 (bench.py:330-333) and plume3d (cli.py:258-261), i.e.
    one z plane more."""
    s = stam.make_grid3d(cfg, device)
    k = cfg.n // 8
    top = k if path.startswith(("bench", "config 3")) else k + 1
    s.dens[3 * k:5 * k, 3 * k:5 * k, 1:top] = 1.0
    s.temp[3 * k:5 * k, 3 * k:5 * k, 1:top] = 3.0
    return s


def bound(nbytes, ops):
    """(ms, what bounds it): the least time for ``nbytes`` of device
    memory traffic and ``ops`` float32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return float(t_bytes), "bytes"
    return float(t_ops), "operations"


def tensors_in(args):
    """The distinct tensors among ``args`` (nested tuples included)."""
    found = {}
    for a in args:
        for t in (a if isinstance(a, tuple) else (a,)):
            if isinstance(t, torch.Tensor):
                found[t.data_ptr()] = t
    return list(found.values())


def grid_work(name, args, outs):
    """(bytes, operations) of one grid kernel call: each input field read
    once, each output written once, GRID_OPS per interior cell."""
    n = outs[0].shape[0] - 2
    nbytes = sum(t.nbytes for t in tensors_in(args) + list(outs))
    return nbytes, GRID_OPS[name](args) * n ** outs[0].dim()


def rel_err(got, want):
    """(max |got - want|, max of |got - want| / max|want| per pair) over
    paired tensors."""
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    rels = [e / max(float(w.abs().max()), 1e-30)
            for e, w in zip(errs, want)]
    return max(errs), max(rels)


def time_ms(fn, reps=TIME_REPS, warm=3):
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_profile(run, steps):
    """(wall ms/step, device busy ms/step, device ops a step, the four
    kernels of most device time as (ms/step, calls a step, name)) of
    ``run(steps)`` under torch.profiler: the card's kernel and copy
    times, and the host clock."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in events) / 1e3 / steps
    by_name = {}
    for e in events:
        t = by_name.setdefault(e.name[:48], [0.0, 0])
        t[0] += e.device_time / 1e3 / steps
        t[1] += 1
    top = sorted(((t, c / steps, name) for name, (t, c) in by_name.items()),
                 reverse=True)[:4]
    return wall, busy, len(events) / steps, top


def log_profile(path, run, ms):
    """The device's busy time and ops a step of ``run``, and its idle
    share against the timed run's ``ms`` a step: the profiler's own host
    cost slows the steps it records."""
    wall, busy, ops, top = device_profile(run, PROFILE_STEPS)
    log(f"{path}: {PROFILE_STEPS} steps under torch.profiler ({wall:.4f} "
        f"ms/step there): device busy {busy:.4f} ms/step, {ops:.1f} device "
        f"ops a step; device idle share {1.0 - busy / ms:.3f} of the timed "
        f"{ms:.4f} ms/step")
    for t, calls, name in top:
        log(f"    {t:.4f} ms/step in {calls:.1f} calls a step: {name}")


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
    """Each grid kernel against its plain version: the stencil kernels
    and the streamed solves at 256^3, the whole tier at 64^3, the 2D
    kernels at 128^2; returns
    per-kernel {"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
    "library_ms"}, the times and bounds those of the main path's call
    shapes (averaged over the two advections of a step)."""
    rng = np.random.default_rng(SEED)

    def field(n, b, lo, hi):
        a = rng.uniform(lo, hi, (n + 2,) * 3).astype(np.float32)
        return stam.set_bnd3d(b, torch.from_numpy(a).to(dev))

    n = N_BIG
    cfg = grid_config(stam, "bench (DCT)", n)
    dt0 = cfg.dt * n
    # velocities up to 1.2 cells per step: the one-cell clamp is exercised
    u, v, w = (field(n, b, -1.2 / dt0, 1.2 / dt0) for b in (1, 2, 3))
    dens, temp, p = (field(n, 0, 0.0, 1.0) for _ in range(3))
    # config 2's diffusion (a, c), as stam.diffuse3d computes them at 64^3
    c2, c4 = grid_config(stam, "config 2"), grid_config(stam, "config 4")
    a2 = c2.dt * c2.visc * c2.n ** 2
    u64, v64, w64 = (field(N_WHOLE, b, -1.0, 1.0) for b in (1, 2, 3))
    d64, t64 = (field(N_WHOLE, 0, 0.0, 1.0) for _ in range(2))

    def field2d(b, lo, hi):
        a = rng.uniform(lo, hi, (N_2D + 2,) * 2).astype(np.float32)
        return stam.set_bnd2d(b, torch.from_numpy(a).to(dev))

    c1 = grid2d_config(stam, "config 1")
    c1_forced = c1.replace(buoyancy_alpha=0.04, buoyancy_beta=0.9,
                           vorticity_eps=1.5)
    a1 = c1.dt * c1.visc * N_2D ** 2
    u2, v2 = (field2d(b, -1.2 / (c1.dt * N_2D), 1.2 / (c1.dt * N_2D))
              for b in (1, 2))
    d2, t2, p2 = (field2d(0, 0.0, 1.0) for _ in range(3))
    # the main path's call shapes, timed
    calls = {
        "advect3d_multi": [((u, v, w), (1, 2, 3), u, v, w, dt0),
                           ((dens, temp), (0, 0), u, v, w, dt0)],
        "forcing3d": [(u, v, w, dens, temp, cfg)],
        "div3d": [(u, v, w)],
        "gradsub3d": [(p, u, v, w)],
        # the pressure solve from a zero guess
        "lin_solve3d": [(0, None, p, 1.0, 6.0, 20)],
        "lin_solve3d_rb": [(0, None, p, 1.0, 6.0, 20)],
        "diffuse3d_multi": [((u64, v64, w64),
                             tuple((b, a2, 1 + 6 * a2) for b in (1, 2, 3)),
                             20)],
        "project3d_whole": [(u64, v64, w64, 20, True)],
        "step3d_whole": [(u64, v64, w64, d64, t64, c4)],
        # the smoke2d default's projection and velocity diffusion solves
        "lin_solve2d": [(0, None, p2, 1.0, 4.0, 20),
                        (1, u2, u2, a1, 1 + 4 * a1, 20)],
        "step2d_whole": [(u2, v2, d2, t2, c1)],
    }
    # checked only: the solves at diffusion coefficients, at b = 1; the
    # whole step of config 2, and of config 4 with plain Jacobi; the 2D
    # whole step with buoyancy and vorticity
    checked_only = {
        "lin_solve3d": [(1, u, u, a2, 1 + 6 * a2, 20)],
        "lin_solve3d_rb": [(1, u, u, a2, 1 + 6 * a2, 20)],
        "step3d_whole": [(u64, v64, w64, d64, t64, c2),
                         (u64, v64, w64, d64, t64,
                          c4.replace(red_black=False))],
        "step2d_whole": [(u2, v2, d2, t2, c1_forced)],
    }
    results = {}
    for name, arg_sets in calls.items():
        kern = getattr(kernels, name)
        plain = getattr(kernels, name + "_plain")
        err = rel = 0.0
        work = []
        for i, args in enumerate(arg_sets + checked_only.get(name, [])):
            got, want = kern(*args), plain(*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            check(all(g.shape == w_.shape for g, w_ in zip(got, want)),
                  f"{name}: output shapes")
            e, r = rel_err(got, want)
            err, rel = max(err, e), max(rel, r)
            if i < len(arg_sets):
                work.append(grid_work(name, args, got))
            if name == "step3d_whole":
                # the one launch equals the separate kernels bit for bit
                sep = stam.step3d_multi(stam.GridState3D(*args[:5]), args[5])
                same = all(torch.equal(g, getattr(sep, f))
                           for g, f in zip(got, FIELDS))
                log(f"step3d_whole @ {N_WHOLE}^3, red_black "
                    f"{args[5].red_black}, forcing "
                    f"{bool(args[5].vorticity_eps)}: bitwise equal to "
                    f"stam.step3d_multi: {same}")
                check(same, "step3d_whole differs from stam.step3d_multi")
            if name == "step2d_whole":
                sep = stam.step2d_multi(stam.GridState2D(*args[:4]), args[4])
                same = all(torch.equal(g, getattr(sep, f))
                           for g, f in zip(got, FIELDS2D))
                log(f"step2d_whole @ {N_2D}^2, forcing "
                    f"{bool(args[4].vorticity_eps)}: bitwise equal to "
                    f"stam.step2d_multi: {same}")
                check(same, "step2d_whole differs from stam.step2d_multi")
        tol = KERNELS[name][2]
        # per call, averaged over the call shapes of the step
        ms = [time_ms(lambda a=a: kern(*a)) for a in arg_sets]
        plain_ms = [time_ms(lambda a=a: plain(*a)) for a in arg_sets]
        bound_ms, bound_by = bound(*np.mean(work, axis=0))
        log(f"kernel {name} @ {got[0].shape[0] - 2}^{got[0].dim()}: "
            f"max_abs_err "
            f"{err:.3e} (relative {rel:.3e}, tolerance {tol:.0e}); ms per "
            f"call: kernel {ms}, plain {plain_ms}; bound {bound_ms:.4f} ms "
            f"({bound_by}; bytes, operations per call: {work})")
        check(rel <= tol, f"{name}: kernel disagrees with its plain version "
                          f"({rel:.3e} > {tol:.0e})")
        # no single PyTorch call computes any of these functions
        results[name] = {"max_abs_err": err, "ms": float(np.mean(ms)),
                         "plain_ms": float(np.mean(plain_ms)),
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": None}
    return results


def check_small_against_cpu(stam, dev):
    """4 steps at 16^3 on the card (kernels) against the CPU (plain
    versions): the bench scene, and configs 2 and 4 (the whole tier,
    then the streamed residual step).  The bench's first solve runs at
    "highest" here: its TF32 tier on the card is the one intended
    difference from the CPU."""
    for path in ("bench (DCT)", "config 2", "config 4"):
        cfg = grid_config(stam, path, 16)
        if path == "bench (DCT)":
            cfg = cfg.replace(dct_precision_first="highest")
        gpu, gres = stam.run3d_python(grid_state(stam, path, cfg, dev), cfg,
                                      4)
        cpu, cres = stam.run3d_python(grid_state(stam, path, cfg, "cpu"),
                                      cfg, 4)
        e, r = rel_err([getattr(gpu, f).cpu() for f in FIELDS],
                       [getattr(cpu, f) for f in FIELDS])
        g, c = float(gres[0]), float(cres[0])
        log(f"{path}, 16^3, 4 steps, card vs CPU: max_abs_err {e:.3e} "
            f"(relative {r:.3e}, tolerance {STEP_TOL:.0e}); residual card "
            f"{g:.6e}, CPU {c:.6e}")
        check(r <= STEP_TOL, f"{path} at 16^3: card and CPU disagree")
        if path != "bench (DCT)":
            check(abs(g - c) <= RESIDUAL_RTOL * c,
                  f"{path} at 16^3: residuals differ")
    cfg = grid2d_config(stam, "config 1", 32)
    gpu, cpu = (stam.run2d_python(stam.make_grid2d(cfg, d), cfg, 4,
                                  sources=grid2d_sources(32, d))
                for d in (dev, "cpu"))
    e, r = rel_err([getattr(gpu, f).cpu() for f in FIELDS2D],
                   [getattr(cpu, f) for f in FIELDS2D])
    log(f"config 1, 32^2, 4 steps, card vs CPU: max_abs_err {e:.3e} "
        f"(relative {r:.3e}, tolerance {STEP_TOL:.0e})")
    check(r <= STEP_TOL, "config 1 at 32^2: card and CPU disagree")


def expected_launches(kernels, cfg, steps, state):
    """Launches of a ``steps``-step run3d_python run.  A stencil Jacobi
    run at the whole step's size launches step3d_whole once a step but
    the last; the last step reports the residual, so it runs the
    separate kernels (as every step of the other runs does): two stencil
    advections (none for gather advection, which is torch ops) and a
    forcing (if any), and per projection div, solve and gradsub, or at
    the whole tier one fused call and the diffusions.  The last step's
    final projection always streams."""
    jacobi = cfg.projection == "jacobi"
    stencil = cfg.advect_mode == "stencil"
    whole = jacobi and kernels.whole_ok(state.u)
    fused = jacobi and stencil and kernels.step_whole_ok(state.u)
    separate = 1 if fused else steps
    want = dict.fromkeys(KERNELS, 0)
    want["step3d_whole"] = steps - separate
    want["advect3d_multi"] = 2 * separate if stencil else 0
    if cfg.buoyancy_alpha or cfg.buoyancy_beta or cfg.vorticity_eps:
        want["forcing3d"] = separate
    streamed = 1 if whole else 2 * separate
    if whole:
        want["project3d_whole"] = 2 * separate - 1
        want["diffuse3d_multi"] = separate * (
            bool(cfg.visc) + bool(cfg.diff or cfg.temp_diff))
    want["div3d"] = want["gradsub3d"] = streamed
    if jacobi:
        want["lin_solve3d_rb" if cfg.red_black else "lin_solve3d"] = streamed
    return want


def run_grid_path(stam, kernels, dev, path):
    """Two steps through the kernels against two through the plain
    versions (one without the residual, one with it); then the warm-up
    and the timed run, whose launch counts are returned."""
    _, n, warm, timed = GRID_PATHS[path]
    cfg = grid_config(stam, path)
    state = grid_state(stam, path, cfg, dev)

    one, res = stam.run3d_python(state, cfg, 2)
    with plain_kernels(kernels):
        ref, ref_res = stam.run3d_python(state, cfg, 2)
    torch.cuda.synchronize()
    e, r = rel_err([getattr(one, f) for f in FIELDS],
                   [getattr(ref, f) for f in FIELDS])
    res, ref_res = float(res[0]), float(ref_res[0])
    log(f"{path} @ {n}^3, two steps, kernels vs plain versions: "
        f"max_abs_err {e:.3e} (relative {r:.3e}, tolerance "
        f"{STEP_TOL:.0e}); residual {res:.6e}, plain {ref_res:.6e}")
    check(r <= STEP_TOL, f"{path}: two steps through the kernels and two "
                         f"through the plain versions disagree")
    if cfg.projection == "jacobi":
        check(abs(res - ref_res) <= RESIDUAL_RTOL * ref_res,
              f"{path}: residual {res:.6e} against the plain step's "
              f"{ref_res:.6e}")
    del one, ref

    state, res = stam.run3d_python(state, cfg, warm)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, res = stam.run3d_python(state, cfg, timed)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()

    ms = seconds / timed * 1e3
    residual = float(res[0])
    finite = all(bool(torch.isfinite(getattr(state, f)).all())
                 for f in FIELDS)
    log(f"{path} @ {n}^3, {timed} timed steps after {warm} warm-up: "
        f"{ms:.4f} ms/step, {n ** 3 / (ms / 1e3):.4e} cell-updates/s, "
        f"final residual {residual:.6e}, finite {finite}")
    log(f"launches: {counts}")
    check(all(getattr(state, f).shape == (n + 2,) * 3 for f in FIELDS),
          f"{path}: field shapes")
    check(finite, f"{path}: fields not finite")
    if cfg.projection == "dct":
        check(residual <= MAX_RESIDUAL, f"{path}: final residual "
                                        f"{residual:.3e} > {MAX_RESIDUAL:.0e}")
    else:
        # twenty sweeps: held to the plain step above, here only sane
        check(residual < 1e-2, f"{path}: final residual {residual:.3e}")
    want = expected_launches(kernels, cfg, timed, state)
    check(counts == want, f"{path}: launches {counts} != {want}")
    log_profile(path, lambda k: stam.run3d_python(state, cfg, k), ms)
    if path == "config 2":
        # no forcing from a still start: the scalars only diffuse
        check(float(state.w.abs().max()) == 0.0, f"{path}: the flow moved")
        check(float(state.dens.max()) < 1.0, f"{path}: dens did not diffuse")
    else:
        check(float(state.w.abs().max()) > 0.0,
              f"{path}: the plume did not move")
    return counts


def run_grid2d_path(stam, kernels, dev, path):
    """Two steps through the kernels against two through the plain
    versions, bit for bit; then the warm-up and the timed run (no host
    sync allowed), whose launch counts are returned; then one residual
    step against the plain one."""
    _, n, warm, timed = GRID2D_PATHS[path]
    cfg = grid2d_config(stam, path)
    sources = grid2d_sources(n, dev)
    state = stam.make_grid2d(cfg, dev)

    one = stam.run2d_python(state, cfg, 2, sources=sources)
    with plain_kernels(kernels):
        ref = stam.run2d_python(state, cfg, 2, sources=sources)
    torch.cuda.synchronize()
    e, r = rel_err([getattr(one, f) for f in FIELDS2D],
                   [getattr(ref, f) for f in FIELDS2D])
    log(f"{path} @ {n}^2, two steps, kernels vs plain versions: max_abs_err "
        f"{e:.3e} (relative {r:.3e}, bit for bit required)")
    check(e == 0.0, f"{path}: two steps through the kernels and two "
                    f"through the plain versions differ")

    state = stam.run2d_python(state, cfg, warm, sources=sources)
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        state = stam.run2d_python(state, cfg, timed, sources=sources)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    ms = seconds / timed * 1e3
    finite = all(bool(torch.isfinite(getattr(state, f)).all())
                 for f in FIELDS2D)
    total = float(state.dens.sum())
    log(f"{path} @ {n}^2, {timed} timed steps after {warm} warm-up: "
        f"{ms:.4f} ms/step, {n ** 2 / (ms / 1e3):.4e} cell-updates/s, dens "
        f"total {total:.6e}, max |v| {float(state.v.abs().max()):.4e}, "
        f"finite {finite}")
    log(f"launches: {counts}")
    check(all(getattr(state, f).shape == (n + 2,) * 2 for f in FIELDS2D),
          f"{path}: field shapes")
    check(finite and total > 0.0, f"{path}: fields not finite, or no dens")
    want = dict.fromkeys(KERNELS, 0)
    if cfg.advect_mode == "stencil":
        want["step2d_whole"] = timed
    else:
        # two velocity diffusions, two projections, the dens diffusion
        want["lin_solve2d"] = 5 * timed
    check(counts == want, f"{path}: launches {counts} != {want}")
    log_profile(path, lambda k: stam.run2d_python(state, cfg, k,
                                                  sources=sources), ms)

    _, res = stam.step2d(state, cfg, sources, with_residual=True)
    with plain_kernels(kernels):
        _, ref_res = stam.step2d(state, cfg, sources, with_residual=True)
    res, ref_res = float(res), float(ref_res)
    log(f"{path} @ {n}^2: residual step {res:.6e}, plain {ref_res:.6e}")
    check(0.0 < res < 1e-2 and abs(res - ref_res) <= RESIDUAL_RTOL * ref_res,
          f"{path}: residual {res:.6e} against the plain step's "
          f"{ref_res:.6e}")
    return counts


def sph_scene(sph, name, device):
    """base_dam (8000 particles), or the 262144- or 524288-particle
    uniform fill of verify/bench_sph_scaling_ab.py, under BASE_CONFIG."""
    if name == "base_dam":
        return sph.scenes.base_dam(sph.cfg, device=device)
    n = BIG_FILL if name == "fill-524k" else SPH_FILL
    pos = np.random.default_rng(SEED).uniform(-0.9, 0.9, (n, 3))
    return sph.state.make_state(pos.astype(np.float32), cfg=sph.cfg,
                                device=device)


def randomised(st, seed):
    """dens, press and vel drawn from ``seed``: at a scene's first step
    press = 0 and vel = 0, so dpress would be 0."""
    rng = np.random.default_rng(seed)
    n = st.capacity

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(st.pos.device)

    return st.replace(dens=t(rng.uniform(9300.0, 9900.0, n)),
                      press=t(rng.normal(0.0, 3e4, n)),
                      vel=t(rng.normal(0.0, 0.5, (n, 3))))


# float32 operations per pair within 2h, counted from the pair bodies of
# csrc/sph_forces.cu (distance 9, smoothing kernels 13, viscosity 23, the
# sums 19) and csrc/sph_unidyn.cu (pass A without the drift terms, which
# only mixed pairs run: 125; pass B: 127); a division or sqrt counts as one
BASE_PAIR_OPS = 64
UNIDYN_PAIR_OPS = 125 + 127
BASE_IN = ("pos", "vel", "dens", "press", "boundary", "alive")
UNIDYN_IN = BASE_IN + ("mass", "solid", "fluid", "diffusion", "delpress",
                       "stress")


def pair_count(sph, st, bt, cfg, threshold=None, caps=None, stale=False):
    """Pairs (home, candidate) that the force pass sums over: alive
    candidates of the 27-cell stencil (less the sub-bin octant rule when
    ``threshold`` is set; capped by the column caps ``caps``; from whole
    columns masked by current cells when ``stale``) within 2h of the home
    row, self excluded; the candidate table of the plain version, counted
    in chunks."""
    f = sph.forces
    n = st.capacity
    rows = f.pack_rows(st, bt.order, bt.in_dom)
    run_start, run_len = sph.binning.run_table(bt, cfg, caps, whole=stale)
    cells = sph.binning.cell_trunc(rows[:, 0:3], cfg)
    k = int(run_len.max())
    slot = torch.arange(k, device=rows.device)
    step = max(1, f.CHUNK_SLOTS // (9 * k))
    total = 0
    for a in range(0, n, step):
        b = min(n, a + step)
        idx = run_start[a:b, :, None] + slot
        valid = slot < run_len[a:b, :, None]
        if threshold is not None:
            valid = valid & f._subbin_ok(bt, cfg, a, b, idx, threshold)
        idx = torch.clamp(idx, 0, n - 1).reshape(b - a, -1)
        valid = valid.reshape(b - a, -1)
        if stale:
            valid = valid & f.near_cells(cells[a:b], cells[idx])
        cand = rows[idx]
        r = rows[a:b, None, 0:3] - cand[..., 0:3]
        ds = torch.sqrt(torch.sum(r * r, dim=-1))
        total += int((valid & (cand[..., f._ALIVE] > 0.5)
                      & (ds > 0) & (ds <= 2 * cfg.cutoff)).sum())
    return total


def sph_work(st, bt, order, fields, outs, pairs, pair_ops):
    """(bytes, operations) of one force call: the state fields it reads,
    the bin table and the order once, its outputs once, and the pairs'
    operations."""
    ins = [getattr(st, f) for f in fields] + [bt.cid, bt.in_dom,
                                              bt.cell_start, order]
    nbytes = sum(t.nbytes for t in ins + list(outs))
    return nbytes, pairs * pair_ops


def check_sph_kernel(sph, dev):
    """The force kernel against its plain version at both scenes; returns
    {"max_abs_err", "ms", "plain_ms"}, the times at the fill."""
    kern = sph.sph_kernels.base_forces_rowblock
    plain = sph.sph_kernels.base_forces_rowblock_plain
    tol = SPH_KERNELS["base_forces_rowblock"][2]
    worst = 0.0
    for name in SPH_STEPS:
        st = randomised(sph_scene(sph, name, dev), SEED + 1)
        order, bt = sph.binning.sort_tables(st, sph.cfg)
        got = kern(st, bt, sph.cfg, order)
        want = plain(st, bt, sph.cfg, order)
        torch.cuda.synchronize()
        check(got[0].shape == want[0].shape and
              got[1].shape == want[1].shape, "base_forces_rowblock shapes")
        e, r = rel_err([got[0], *got[1].unbind(1)],
                       [want[0], *want[1].unbind(1)])
        check(float(want[1].abs().max()) > 0.0, "dpress is 0: no check")
        ms = time_ms(lambda: kern(st, bt, sph.cfg, order))
        plain_ms = time_ms(lambda: plain(st, bt, sph.cfg, order))
        pack_ms = time_ms(lambda: sph.forces.pack_rows(st, order,
                                                       bt.in_dom))
        log(f"kernel base_forces_rowblock @ {name} ({st.capacity} "
            f"particles): max_abs_err {e:.3e} (relative {r:.3e}, tolerance "
            f"{tol:.0e}); ms per call: kernel {ms:.4f} (of which the row "
            f"pack {pack_ms:.4f}), plain {plain_ms:.4f}")
        check(r <= tol, f"base_forces_rowblock disagrees with its plain "
                        f"version at {name} ({r:.3e} > {tol:.0e})")
        worst = max(worst, e)
        pairs = pair_count(sph, st, bt, sph.cfg)
        bound_ms, bound_by = bound(*sph_work(st, bt, order, BASE_IN, got[:2],
                                             pairs, BASE_PAIR_OPS))
        log(f"  {pairs} pairs within 2h: bound {bound_ms:.4f} ms "
            f"({bound_by})")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def state_by_pid(sph, st):
    d = sph.convert.state_to_numpy(st)
    rows = np.argsort(d["pid"])
    return {k: v[rows] for k, v in d.items()}


def check_sph_against_cpu(sph, dev):
    """10 base_dam steps on the card (kernel) against the CPU (plain
    version), by particle id."""
    gpu, gm = sph.step.run_python(sph_scene(sph, "base_dam", dev), sph.cfg,
                                  SPH_CHECK_STEPS)
    cpu, cm = sph.step.run_python(sph_scene(sph, "base_dam", "cpu"),
                                  sph.cfg, SPH_CHECK_STEPS)
    g, c = state_by_pid(sph, gpu), state_by_pid(sph, cpu)
    check(np.array_equal(g["pid"], c["pid"]), "base_dam particle ids")
    for key, rtol in SPH_TOLS:
        a, b = g[key].astype(np.float64), c[key].astype(np.float64)
        atol = 1e-5 * max(1.0, float(np.abs(b).max()))
        excess = float((np.abs(a - b) - rtol * np.abs(b) - atol).max())
        log(f"base_dam, {SPH_CHECK_STEPS} steps, card vs CPU, {key}: "
            f"max_abs_err {float(np.abs(a - b).max()):.3e} (rtol {rtol:.0e},"
            f" atol {atol:.1e}); finite {bool(np.isfinite(a).all())}")
        check(np.isfinite(a).all() and excess <= 0.0,
              f"base_dam {key}: card and CPU disagree")
    check(int(gm.n_alive) == int(cm.n_alive) == 8000, "base_dam n_alive")
    check(float(gm.total_mass) == float(cm.total_mass), "base_dam mass")


def check_sph_determinism(sph, dev):
    """Two 10-step card runs of the fill must be bitwise equal."""
    runs = [sph.step.run_python(sph_scene(sph, "fill", dev), sph.cfg,
                                SPH_CHECK_STEPS)[0] for _ in range(2)]
    same = all(torch.equal(getattr(runs[0], f), getattr(runs[1], f))
               for f in sph.state.FIELDS)
    log(f"fill, {SPH_CHECK_STEPS} steps, two card runs bitwise equal: "
        f"{same}")
    check(same, "two card runs of the fill differ")


def run_sph_main_path(sph, dev):
    """Drive run_python on base_dam and on the fill; the counts are
    reset before and read after each timed run.  Returns the summed
    launch counts."""
    total = {}
    for name, (warm, timed) in SPH_STEPS.items():
        st = sph_scene(sph, name, dev)
        n0, mass0 = int(st.alive.sum()), float(st.mass.sum())
        zmin0 = float(st.pos[:, 2].min())
        st, _ = sph.step.run_python(st, sph.cfg, warm)
        torch.cuda.synchronize()
        sph.sph_kernels.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            st, m = sph.step.run_python(st, sph.cfg, timed)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = sph.sph_kernels.launch_counts()
        ms = seconds / timed * 1e3
        finite = all(bool(torch.isfinite(getattr(st, f)).all())
                     for f in ("pos", "vel", "acc", "dens", "press",
                               "delpress"))
        zmin = float(st.pos[:, 2].min())
        log(f"SPH {name} ({n0} particles), {timed} timed steps after "
            f"{warm} warm-up: {ms:.4f} ms/step, "
            f"{n0 * timed / seconds:.4e} particle-steps/s; n_alive "
            f"{int(m.n_alive)}, total_mass {float(m.total_mass)}, "
            f"bin_overflow {int(m.bin_overflow)}, max_speed "
            f"{float(m.max_speed):.4e}, dens_residual "
            f"{float(m.dens_residual):.4e}, min z {zmin0:.4f} -> "
            f"{zmin:.4f}, finite {finite}; launches {counts}")
        check(finite, f"SPH {name}: state not finite")
        check(int(m.n_alive) == n0, f"SPH {name}: n_alive changed")
        check(float(m.total_mass) == mass0, f"SPH {name}: mass changed")
        check(int(m.bin_overflow) == 0, f"SPH {name}: bin overflow")
        check(sph.sph_kernels.launch_counts("base_forces_rowblock")
              == {"base_forces_rowblock": timed},
              f"SPH {name}: launches {counts} != one per step")
        if name == "base_dam":
            check(zmin < zmin0, "base_dam: the column did not fall")
        for k, c in counts.items():
            total[k] = total.get(k, 0) + c
    return total


def unidyn_scene(sph, name, device, cfg=None):
    """The reference's tank (14040 particles, or cut to 2808), the
    46656-particle fill, or a 150-particle mixed-phase blob (the pure
    tank's drift, velocity gradient, stress acceleration and mixture
    terms are exactly 0, so the kernel checks mix its phases)."""
    cfg = cfg or sph.ucfg
    if name == "tank":
        return sph.scenes.unidyn_tank(cfg, device=device)
    if name == "small_tank":
        return sph.scenes.unidyn_tank(cfg, nf=2000, nb=808, device=device)
    if name == "fill":
        pos = np.random.default_rng(SEED).uniform(-0.9, 0.9,
                                                  (UNIDYN_FILL, 3))
        return sph.state.make_state(pos.astype(np.float32), cfg=cfg,
                                    device=device)
    st = sph.scenes.random_blob(150, seed=7, cfg=cfg, span=0.15,
                                boundary_frac=0.15, device=device)
    return sph.scenes.mixed_phase(st, SEED + 3)


def check_unidyn_kernels(sph, dev):
    """Both unidyn wrappers against their plain versions on the mixed
    tank (the preset: sub-binning, no merging) and the mixed fill (with
    merging); returns per-kernel {"max_abs_err", "ms", "plain_ms"}, the
    times at the tank."""
    results = {}
    for scene, merge in (("tank", -10.0), ("fill", 0.03)):
        cfg = sph.ucfg.replace(merge_dist=merge)
        st = sph.scenes.mixed_phase(unidyn_scene(sph, scene, dev, cfg),
                                    SEED + 2)
        order, bt = sph.binning.sort_tables(st, cfg)
        for name, (_, _, tol) in UNIDYN_KERNELS.items():
            kern = getattr(sph.sph_kernels, name)
            plain = getattr(sph.sph_kernels, name + "_plain")

            def call(fn):
                return fn(st, bt, cfg, order,
                          subbin_threshold=cfg.subbin_threshold)

            got, want = call(kern), call(plain)
            torch.cuda.synchronize()
            worst = err = 0.0
            for k in UNIDYN_FIELDS:
                g = got[k].reshape(st.capacity, -1)
                w = want[k].reshape(st.capacity, -1)
                check(g.shape == w.shape, f"{name} {k}: shapes")
                for c in range(w.shape[1]):
                    scale = float(w[:, c].abs().max())
                    e = float((g[:, c] - w[:, c]).abs().max())
                    check(scale > 0.0, f"{name} {k}[{c}] is 0 at {scene}: "
                                       f"no check")
                    worst, err = max(worst, e / scale), max(err, e)
            same = (torch.equal(got["has_pair"], want["has_pair"])
                    and torch.equal(got["merge_partner"],
                                    want["merge_partner"]))
            partners = int((got["merge_partner"] >= 0).sum())
            ms = time_ms(lambda: call(kern))
            plain_ms = time_ms(lambda: call(plain))
            log(f"kernel {name} @ {scene} ({st.capacity} particles, mixed "
                f"phases, merge_dist {merge}): max_abs_err {err:.3e} "
                f"(worst column relative {worst:.3e}, tolerance {tol:.0e}); "
                f"pair counts and merge partners equal: {same} "
                f"({partners} partners); ms per call: kernel {ms:.4f}, "
                f"plain {plain_ms:.4f}")
            check(worst <= tol, f"{name} disagrees with its plain version "
                                f"at {scene} ({worst:.3e} > {tol:.0e})")
            check(same, f"{name}: pair counts or merge partners differ")
            check((partners > 0) == (merge > 0), f"{name}: merge partners")
            if scene == "tank":
                pairs = pair_count(sph, st, bt, cfg, cfg.subbin_threshold)
                outs = [t for t in got.values() if isinstance(t, torch.Tensor)]
                bound_ms, bound_by = bound(*sph_work(
                    st, bt, order, UNIDYN_IN, outs, pairs, UNIDYN_PAIR_OPS))
                log(f"  {pairs} pairs within 2h: bound {bound_ms:.4f} ms "
                    f"({bound_by})")
                results[name] = {"max_abs_err": err, "ms": ms,
                                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                                 "bound_by": bound_by, "library_ms": None}
            else:
                results[name]["max_abs_err"] = max(
                    results[name]["max_abs_err"], err)
    return results


def compare_by_pid(sph, gpu, cpu, tols, what):
    """Alive rows of the card's and the CPU's states, by particle id."""
    g, c = state_by_pid(sph, gpu), state_by_pid(sph, cpu)
    g = {k: v[g["alive"]] for k, v in g.items()}
    c = {k: v[c["alive"]] for k, v in c.items()}
    check(np.array_equal(g["pid"], c["pid"]), f"{what}: particle ids")
    for key, rtol in tols:
        a, b = g[key].astype(np.float64), c[key].astype(np.float64)
        atol = 1e-5 * max(1.0, float(np.abs(b).max()))
        excess = float((np.abs(a - b) - rtol * np.abs(b) - atol).max())
        log(f"{what}, card vs CPU, {key}: max_abs_err "
            f"{float(np.abs(a - b).max()):.3e} (rtol {rtol:.0e}, atol "
            f"{atol:.1e}); finite {bool(np.isfinite(a).all())}")
        check(np.isfinite(a).all() and excess <= 0.0,
              f"{what} {key}: card and CPU disagree")
    check(np.array_equal(g["mass"], c["mass"]), f"{what}: masses differ")


def check_unidyn_against_cpu(sph, dev):
    """10 steps of the cut tank, and 3 steps of the merging blob, on the
    card (kernels) against the CPU (plain versions)."""
    cfg = sph.ucfg
    gpu, gm = sph.step.run_python(unidyn_scene(sph, "small_tank", dev),
                                  cfg, SPH_CHECK_STEPS)
    cpu, cm = sph.step.run_python(unidyn_scene(sph, "small_tank", "cpu"),
                                  cfg, SPH_CHECK_STEPS)
    compare_by_pid(sph, gpu, cpu, UNIDYN_TOLS,
                   f"unidyn tank (2808), {SPH_CHECK_STEPS} steps")
    check(int(gm.n_alive) == int(cm.n_alive) == 2808, "tank n_alive")
    check(int(gm.bin_overflow) == 0, "tank bin overflow")

    cfg = cfg.replace(merge_dist=0.03)
    gpu, cpu = (unidyn_scene(sph, "blob", d, cfg) for d in (dev, "cpu"))
    alive = [150]
    for _ in range(3):
        gpu, gm = sph.step.run_python(gpu, cfg, 1)
        cpu, cm = sph.step.run_python(cpu, cfg, 1)
        check(int(gm.n_alive) == int(cm.n_alive), "merging blob: n_alive")
        alive.append(int(gm.n_alive))
    log(f"merging blob (merge_dist 0.03), alive per step: {alive}")
    check(alive[1] < alive[0] and alive[3] <= alive[1],
          "merging blob: nothing merged")
    compare_by_pid(sph, gpu, cpu, UNIDYN_TOLS, "merging blob, 3 steps")


def run_unidyn_main_path(sph, dev):
    """Drive run_python on the full tank (the resident kernel), then the
    row-block kernel for the bitwise comparison; each kernel's count is
    reset before and read after its own run.  Returns the counts."""
    cfg = sph.ucfg
    warm, timed = UNIDYN_STEPS
    st = unidyn_scene(sph, "tank", dev)
    n0, mass0 = int(st.alive.sum()), float(st.mass.sum())
    fluid = ~st.boundary
    z0 = float(st.pos[fluid, 2].mean())
    st, _ = sph.step.run_python(st, cfg, warm)
    torch.cuda.synchronize()
    sph.sph_kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        st, m = sph.step.run_python(st, cfg, timed)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = sph.sph_kernels.launch_counts(*UNIDYN_KERNELS)
    ms = seconds / timed * 1e3
    finite = all(bool(torch.isfinite(getattr(st, f)).all())
                 for f in sph.state.FIELDS if f != "pid")
    inside = float(st.pos[fluid].abs().max())
    z1 = float(st.pos[fluid, 2].mean())
    log(f"unidyn tank ({n0} particles), {timed} timed steps after {warm} "
        f"warm-up: {ms:.4f} ms/step, {n0 * timed / seconds:.4e} "
        f"particle-steps/s; n_alive {int(m.n_alive)}, total_mass "
        f"{float(m.total_mass)}, bin_overflow {int(m.bin_overflow)}, "
        f"max_speed {float(m.max_speed):.4e}, dens_residual "
        f"{float(m.dens_residual):.4e}, fluid mean z {z0:.4f} -> {z1:.4f}, "
        f"fluid max |coordinate| {inside:.4f}, finite {finite}; launches "
        f"{counts}")
    check(finite, "unidyn tank: state not finite")
    check(int(m.n_alive) == n0 == 14040, "unidyn tank: n_alive changed")
    check(float(m.total_mass) == mass0, "unidyn tank: mass changed")
    check(int(m.bin_overflow) == 0, "unidyn tank: bin overflow")
    check(inside < 1.0, "unidyn tank: fluid left the tank")
    check(z1 < z0, "unidyn tank: the fluid did not fall")
    check(counts == {"unidyn_forces_resident": timed,
                     "unidyn_forces_rowblock": 0},
          f"unidyn tank: launches {counts} != one resident call per step")

    runs = {}
    for kernel in ("resident", "rowblock", "resident again"):
        sph.sph_kernels.reset_launches()
        runs[kernel], _ = sph.step.run_python(
            unidyn_scene(sph, "tank", dev),
            cfg.replace(pallas_kernel=kernel.split()[0]),
            UNIDYN_BITWISE_STEPS)
        torch.cuda.synchronize()
        if kernel == "rowblock":
            counts.update(sph.sph_kernels.launch_counts(
                "unidyn_forces_rowblock"))
    for other in ("rowblock", "resident again"):
        same = all(torch.equal(getattr(runs["resident"], f),
                               getattr(runs[other], f))
                   for f in sph.state.FIELDS)
        log(f"unidyn tank, {UNIDYN_BITWISE_STEPS} steps, {other} bitwise "
            f"equal to resident: {same}")
        check(same, f"unidyn tank: {other} differs from resident")
    check(counts["unidyn_forces_rowblock"] == UNIDYN_BITWISE_STEPS,
          "unidyn tank: the row-block run did not launch its kernel")
    return counts


def registers(build_log, *keys):
    """{kernel entry: registers} from nvcc's -Xptxas -v output, for the
    entries whose mangled names hold every one of ``keys``."""
    found, entry = {}, None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and "registers" in line:
            found[entry] = int(line.split("Used ")[1].split()[0])
            entry = None
    return {k: v for k, v in found.items() if all(x in k for x in keys)}


def capped_rows(sph, st, bt, cfg, b):
    """Pool rows of the (in-domain) rows at rank b or more in their
    column: the column family gives them zeros."""
    g = cfg.grid_size
    cs = sph.binning.column_start(bt, cfg)
    cid = bt.cid.long()
    rank = torch.arange(st.capacity, device=cid.device) - cs[
        torch.clamp(cid // g, max=g * g - 1)]
    return bt.order[(cid < cfg.num_cells) & (rank >= b)]


def sorted_and_moved(sph, st, cfg, seed):
    """(the pool sorted into cell order, its tables, the pool moved by up
    to 0.4 of a cell since): a stale step's inputs."""
    st, bt = sph.binning.sort_by_cell(st, cfg)
    rng = np.random.default_rng(seed)
    shift = torch.from_numpy(rng.uniform(-0.02, 0.02, (st.capacity, 3))
                             .astype(np.float32)).to(st.pos.device)
    return st, bt, st.replace(pos=st.pos + shift)


def fill_cfg(sph, st):
    """BASE_CONFIG at the scene's suggest_col_cap (the JAX CLI's choice
    for a dam of other than 8000 particles, cli.py:115-128)."""
    return sph.cfg.replace(pallas_col_cap=sph.binning.suggest_col_cap(
        st, sph.cfg))


def check_base_column(sph, dev, build_log):
    """base_forces_column against its plain version, fresh and stale, at
    the 524288 fill (its suggest_col_cap) and at base_dam forced to cap
    32; the row-block kernel's stale mode at base_dam and the fill.
    Returns the column kernel's JSON entry (times and bound at the fill,
    fresh: the main path's call) and the stale row-block times."""
    col = sph.sph_kernels.base_forces_column
    col_plain = sph.sph_kernels.base_forces_column_plain
    tol = COLUMN_KERNELS["base_forces_column"][2]
    regs = {"fresh": registers(build_log, "base_forces_kernelILb1ELb0E"),
            "xy_cells": registers(build_log, "base_forces_kernelILb1ELb1E")}
    log(f"registers, base_forces_column: {regs}")
    entry, worst = None, 0.0
    for scene, cap in (("fill-524k", None), ("base_dam", 32)):
        st = randomised(sph_scene(sph, scene, dev), SEED + 4)
        cfg = (fill_cfg(sph, st) if cap is None
               else sph.cfg.replace(pallas_col_cap=cap))
        b, w_cap = sph.config.column_caps(cfg)
        sorted_st, sbt, moved = sorted_and_moved(sph, st, cfg, SEED + 5)
        for stale in (False, True):
            if stale:
                pool, bt = moved, sbt
            else:
                pool = st
                _, bt = sph.binning.sort_tables(st, cfg)

            def call(fn, pool=pool, bt=bt, stale=stale):
                return fn(pool, bt, cfg, bt.order, stale)

            got, want = call(col), call(col_plain)
            torch.cuda.synchronize()
            e, r = rel_err([got[0], *got[1].unbind(1)],
                           [want[0], *want[1].unbind(1)])
            capped = capped_rows(sph, pool, bt, cfg, b)
            zeros = not (got[0][capped].any() or got[1][capped].any())
            ovf, ovf_plain = int(got[2]), int(want[2])
            ms = time_ms(lambda: call(col))
            plain_ms = time_ms(lambda: call(col_plain), *PLAIN_REPS)
            pairs = pair_count(sph, pool, bt, cfg, caps=(b, w_cap),
                               stale=stale)
            bound_ms, bound_by = bound(*sph_work(pool, bt, bt.order, BASE_IN,
                                                 got[:2], pairs,
                                                 BASE_PAIR_OPS))
            mode = "xy_cells" if stale else "fresh"
            log(f"kernel base_forces_column, {mode}, @ {scene} "
                f"({st.capacity} particles, pallas_col_cap "
                f"{cfg.pallas_col_cap}: b {b}, w_cap {w_cap}): max_abs_err "
                f"{e:.3e} (relative {r:.3e}, tolerance {tol:.0e}); overflow "
                f"{ovf} (plain {ovf_plain}), {capped.numel()} rows over the "
                f"cap, zero: {zeros}; ms per call: kernel {ms:.4f}, plain "
                f"{plain_ms:.4f}; {pairs} pairs: bound {bound_ms:.4f} ms "
                f"({bound_by})")
            check(r <= tol, f"base_forces_column ({mode}) disagrees with its "
                            f"plain version at {scene}")
            check(float(want[1].abs().max()) > 0.0, "dpress is 0: no check")
            check(ovf == ovf_plain and zeros, f"base_forces_column ({mode}) "
                  f"at {scene}: overflow or capped rows")
            check((ovf > 0) == (cap is not None),
                  f"base_forces_column at {scene}: overflow {ovf}")
            worst = max(worst, e)
            if scene == "fill-524k" and not stale:
                entry = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": None}
    entry["max_abs_err"] = worst

    row = sph.sph_kernels.base_forces_rowblock
    row_plain = sph.sph_kernels.base_forces_rowblock_plain
    tol = SPH_KERNELS["base_forces_rowblock"][2]
    log(f"registers, base_forces_rowblock stale: "
        f"{registers(build_log, 'base_forces_kernelILb0ELb1E')}")
    for scene in SPH_STEPS:
        st = randomised(sph_scene(sph, scene, dev), SEED + 6)
        _, bt, moved = sorted_and_moved(sph, st, sph.cfg, SEED + 7)

        def call(fn, moved=moved, bt=bt):
            return fn(moved, bt, sph.cfg, bt.order, True)

        got, want = call(row), call(row_plain)
        torch.cuda.synchronize()
        e, r = rel_err([got[0], *got[1].unbind(1)],
                       [want[0], *want[1].unbind(1)])
        ms = time_ms(lambda: call(row))
        plain_ms = time_ms(lambda: call(row_plain), *PLAIN_REPS)
        pairs = pair_count(sph, moved, bt, sph.cfg, stale=True)
        bound_ms, bound_by = bound(*sph_work(moved, bt, bt.order, BASE_IN,
                                             got[:2], pairs, BASE_PAIR_OPS))
        log(f"kernel base_forces_rowblock, stale, @ {scene} ({st.capacity} "
            f"particles): max_abs_err {e:.3e} (relative {r:.3e}, tolerance "
            f"{tol:.0e}); ms per call: kernel {ms:.4f}, plain "
            f"{plain_ms:.4f}; {pairs} pairs: bound {bound_ms:.4f} ms "
            f"({bound_by})")
        check(r <= tol, f"base_forces_rowblock (stale) disagrees with its "
                        f"plain version at {scene}")
    return entry


def check_unidyn_column(sph, dev, build_log):
    """unidyn_forces_column against its plain version on the mixed tank
    at cap 128 (the main path's call, timed) and on the mixed 46656 fill
    at cap 64 with merging (overflowing)."""
    kern = sph.sph_kernels.unidyn_forces_column
    plain = sph.sph_kernels.unidyn_forces_column_plain
    tol = COLUMN_KERNELS["unidyn_forces_column"][2]
    log(f"registers, unidyn_forces_column: "
        f"{registers(build_log, 'unidyn_pass_', 'ILb1EE')}")
    entry = None
    for scene, cap, merge in (("tank", 128, -10.0), ("fill", 64, 0.03)):
        cfg = sph.ucfg.replace(pallas_col_cap=cap, merge_dist=merge)
        st = sph.scenes.mixed_phase(unidyn_scene(sph, scene, dev, cfg),
                                    SEED + 2)
        order, bt = sph.binning.sort_tables(st, cfg)

        def call(fn, st=st, bt=bt, order=order, cfg=cfg):
            return fn(st, bt, cfg, order,
                      subbin_threshold=cfg.subbin_threshold)

        got, want = call(kern), call(plain)
        torch.cuda.synchronize()
        worst = err = 0.0
        for k in UNIDYN_FIELDS:
            g = got[k].reshape(st.capacity, -1)
            w = want[k].reshape(st.capacity, -1)
            for c in range(w.shape[1]):
                scale = float(w[:, c].abs().max())
                e = float((g[:, c] - w[:, c]).abs().max())
                check(scale > 0.0, f"unidyn_forces_column {k}[{c}] is 0 at "
                                   f"{scene}: no check")
                worst, err = max(worst, e / scale), max(err, e)
        same = (torch.equal(got["has_pair"], want["has_pair"])
                and torch.equal(got["merge_partner"], want["merge_partner"]))
        capped = capped_rows(sph, st, bt, cfg, cap)
        zeros = not any(bool(got[k][capped].any()) for k in UNIDYN_FIELDS)
        ovf = int(got["overflow"])
        ms = time_ms(lambda: call(kern))
        plain_ms = time_ms(lambda: call(plain), *PLAIN_REPS)
        log(f"kernel unidyn_forces_column @ {scene} ({st.capacity} "
            f"particles, mixed phases, cap {cap}, merge_dist {merge}): "
            f"max_abs_err {err:.3e} (worst column relative {worst:.3e}, "
            f"tolerance {tol:.0e}); pair counts and merge partners equal: "
            f"{same}; overflow {ovf} (plain {int(want['overflow'])}), "
            f"{capped.numel()} rows over the cap, zero: {zeros}; ms per "
            f"call: kernel {ms:.4f}, plain {plain_ms:.4f}")
        check(worst <= tol and same, f"unidyn_forces_column disagrees with "
                                     f"its plain version at {scene}")
        check(ovf == int(want["overflow"]) and zeros and (ovf > 0) == (
            scene == "fill"), f"unidyn_forces_column at {scene}: overflow")
        if scene == "tank":
            pairs = pair_count(sph, st, bt, cfg, cfg.subbin_threshold,
                               caps=sph.config.column_caps(cfg))
            outs = [t for t in got.values() if isinstance(t, torch.Tensor)]
            bound_ms, bound_by = bound(*sph_work(st, bt, order, UNIDYN_IN,
                                                 outs, pairs,
                                                 UNIDYN_PAIR_OPS))
            log(f"  {pairs} pairs within 2h: bound {bound_ms:.4f} ms "
                f"({bound_by})")
            entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None}
        else:
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
    return entry


def check_column_identities(sph, dev):
    """Bit for bit, at the 524288 fill at its suggest_col_cap (no column
    over it): the column kernel equals the row-block kernel fresh; with
    caps above every column its stale pass equals the row-block stale
    pass; on a just-sorted pool its stale pass equals its fresh one."""
    k = sph.sph_kernels
    st = randomised(sph_scene(sph, "fill-524k", dev), SEED + 8)
    cfg = fill_cfg(sph, st)
    order, bt = sph.binning.sort_tables(st, cfg)
    sorted_st, sbt, moved = sorted_and_moved(sph, st, cfg, SEED + 9)
    big = cfg.replace(pallas_col_cap=st.capacity)
    col, row = k.base_forces_column, k.base_forces_rowblock
    for what, (a, b) in {
            "column fresh = row-block (no overflow)":
                (col(st, bt, cfg, order), row(st, bt, cfg, order)),
            "column xy_cells, caps above every column = row-block stale":
                (col(moved, sbt, big, sbt.order, True),
                 row(moved, sbt, cfg, sbt.order, True)),
            "column xy_cells = column fresh on a just-sorted pool":
                (col(sorted_st, sbt, cfg, sbt.order, True),
                 col(sorted_st, sbt, cfg, sbt.order))}.items():
        same = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        log(f"identity at the 524288 fill, {what}: bitwise {same}")
        check(same and int(a[2]) == 0, f"identity failed: {what}")


def fill_speeds(sph, dev):
    """Max speed after each of the 524288 fill's first FILL_SPEED_STEPS
    steps (column family): where the random fill starts to blow up."""
    st = sph_scene(sph, "fill-524k", dev)
    cfg = fill_cfg(sph, st)
    speeds = []
    for _ in range(FILL_SPEED_STEPS):
        st, m = sph.step.run_python(st, cfg, 1)
        speeds.append(m.max_speed)
    speeds = [float(v) for v in speeds]
    log(f"524288 fill, max speed after steps 1..{FILL_SPEED_STEPS}: "
        + ", ".join(f"{v:.3e}" for v in speeds))
    return speeds


def column_path_state(sph, path, dev):
    """(fresh scene, config) of a COLUMN_PATHS entry."""
    scene, kw, _, _ = COLUMN_PATHS[path]
    if scene == "tank":
        return unidyn_scene(sph, "tank", dev), sph.ucfg.replace(**kw)
    st = sph_scene(sph, scene, dev)
    cfg = fill_cfg(sph, st) if scene == "fill-524k" else sph.cfg
    return st, cfg.replace(**kw)


def run_column_path(sph, dev, path):
    """Warm-up, then the timed steps (counts reset before, read after, no
    host sync allowed), then a profile window on a fresh scene after its
    warm-up.  Returns the launch counts of the timed run."""
    _, _, warm, timed = COLUMN_PATHS[path]
    st, cfg = column_path_state(sph, path, dev)
    cap = st.capacity
    if cfg.variant == "base":
        kernel = ("base_forces_rowblock" if sph.step.resolve_kernel_family(
            cfg, cap) == "rowblock" else "base_forces_column")
    else:
        kernel = f"unidyn_forces_{sph.step.resolve_unidyn_kernel(cfg, cap)}"
    n0, mass0 = int(st.alive.sum()), float(st.mass.sum())
    st, _ = sph.step.run_python(st, cfg, warm)
    torch.cuda.synchronize()
    sph.sph_kernels.reset_launches()
    sph.step.sph_sort_step.calls = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        st, m = sph.step.run_python(st, cfg, timed)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = sph.sph_kernels.launch_counts()
    sorts = sph.step.sph_sort_step.calls
    ms = seconds / timed * 1e3
    finite = all(bool(torch.isfinite(getattr(st, f)).all())
                 for f in sph.state.FIELDS if f != "pid")
    log(f"{path} ({n0} particles, pallas_col_cap {cfg.pallas_col_cap}, "
        f"{kernel}), {timed} timed steps after {warm} warm-up: {ms:.4f} "
        f"ms/step, {n0 * timed / seconds:.4e} particle-steps/s; n_alive "
        f"{int(m.n_alive)}, total_mass {float(m.total_mass)}, bin_overflow "
        f"{int(m.bin_overflow)}, max_speed {float(m.max_speed):.4e}, "
        f"finite {finite}; launches {counts}, sort steps {sorts}")
    check(finite, f"{path}: state not finite")
    check(int(m.n_alive) == n0, f"{path}: n_alive changed")
    check(float(m.total_mass) == mass0, f"{path}: mass changed")
    check(int(m.bin_overflow) == 0, f"{path}: bin overflow")
    want = dict.fromkeys(counts, 0)
    want[kernel] = timed
    check(counts == want, f"{path}: launches {counts} != {want}")
    every = cfg.sort_every if cfg.sort_every > 1 else 0
    check(sorts == (-(-timed // every) if every else 0),
          f"{path}: {sorts} sort steps in {timed}")
    pst, _ = column_path_state(sph, path, dev)
    pst, _ = sph.step.run_python(pst, cfg, warm)
    log_profile(path, lambda k: sph.step.run_python(pst, cfg, k), ms)
    return counts


def add_counts(total, counts):
    for name, c in counts.items():
        total[name] = total.get(name, 0) + c


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port is only measured on "
              "the card", file=sys.stderr)
        return 2
    import types

    from tpufluids_torch import (_build, binning, config, convert, forces,
                                 scenes, sph_kernels, state, step)
    from tpufluids_torch.config import BASE_CONFIG, UNIDYN_CONFIG
    from tpufluids_torch.grid import kernels, stam

    sph = types.SimpleNamespace(binning=binning, config=config,
                                convert=convert, forces=forces,
                                scenes=scenes, sph_kernels=sph_kernels,
                                state=state, step=step, cfg=BASE_CONFIG,
                                ucfg=UNIDYN_CONFIG)

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
    counts = {}
    for path in GRID_PATHS:
        for name, c in run_grid_path(stam, kernels, dev, path).items():
            counts[name] = counts.get(name, 0) + c
    for path in GRID2D_PATHS:
        for name, c in run_grid2d_path(stam, kernels, dev, path).items():
            counts[name] = counts.get(name, 0) + c

    checked["base_forces_rowblock"] = check_sph_kernel(sph, dev)
    check_sph_against_cpu(sph, dev)
    check_sph_determinism(sph, dev)
    counts.update(run_sph_main_path(sph, dev))

    checked.update(check_unidyn_kernels(sph, dev))
    check_unidyn_against_cpu(sph, dev)
    counts.update(run_unidyn_main_path(sph, dev))

    checked["base_forces_column"] = check_base_column(sph, dev, build.log)
    checked["unidyn_forces_column"] = check_unidyn_column(sph, dev,
                                                          build.log)
    check_column_identities(sph, dev)
    fill_speeds(sph, dev)
    for path in COLUMN_PATHS:
        add_counts(counts, run_column_path(sph, dev, path))

    rows = []
    for name, (source, replaces, _) in {**KERNELS, **SPH_KERNELS,
                                        **UNIDYN_KERNELS,
                                        **COLUMN_KERNELS}.items():
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
