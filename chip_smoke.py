"""Smoke run of the PyTorch/CUDA port (tpufluids_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from tpufluids_torch/csrc (one nvcc
   per source, in parallel) and prints nvcc's register, spill and
   shared-memory lines.
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


def sph_scene(sph, name, device):
    """base_dam (8000 particles), or the 262144-particle uniform fill of
    verify/bench_sph_scaling_ab.py, under BASE_CONFIG."""
    if name == "base_dam":
        return sph.scenes.base_dam(sph.cfg, device=device)
    pos = np.random.default_rng(SEED).uniform(-0.9, 0.9, (SPH_FILL, 3))
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
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


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
                results[name] = {"max_abs_err": err, "ms": ms,
                                 "plain_ms": plain_ms}
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port is only measured on "
              "the card", file=sys.stderr)
        return 2
    import types

    from tpufluids_torch import (_build, binning, convert, forces, scenes,
                                 sph_kernels, state, step)
    from tpufluids_torch.config import BASE_CONFIG, UNIDYN_CONFIG
    from tpufluids_torch.grid import kernels, stam

    sph = types.SimpleNamespace(binning=binning, convert=convert,
                                forces=forces, scenes=scenes,
                                sph_kernels=sph_kernels, state=state,
                                step=step, cfg=BASE_CONFIG,
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
    counts = run_main_path(stam, kernels, dev)

    checked["base_forces_rowblock"] = check_sph_kernel(sph, dev)
    check_sph_against_cpu(sph, dev)
    check_sph_determinism(sph, dev)
    counts.update(run_sph_main_path(sph, dev))

    checked.update(check_unidyn_kernels(sph, dev))
    check_unidyn_against_cpu(sph, dev)
    counts.update(run_unidyn_main_path(sph, dev))

    rows = []
    for name, (source, replaces, _) in {**KERNELS, **SPH_KERNELS,
                                        **UNIDYN_KERNELS}.items():
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
