"""Smoke run of the PyTorch/CUDA port (tpufluids_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from tpufluids_torch/csrc (one nvcc
   per source, in parallel) and prints nvcc's register, spill and
   shared-memory lines.
2. Holds each grid kernel against its plain PyTorch version, on seeded
   inputs with set_bnd-consistent ghosts, and times both with CUDA
   events at the main path's shapes: the stencil kernels and the
   streamed Jacobi and red-black pressure solves (a = 1, c = 6, b = 0)
   at 256^3, their bfloat16 versions at 512^3, the whole tier (the
   whole solve in float32 and bfloat16, Jacobi and red-black, the
   three-field diffusion, the fused projection and the whole step of
   config 4) at 64^3.  The solves are checked, untimed, at config 2's
   diffusion coefficients (b = 1) too; the red-black solve, the bfloat16
   solves and the whole solve must equal their plain versions bit for
   bit, the whole solve
   the streamed solve of its type, and the bfloat16 solve must differ
   from the float32 one; the whole step of configs 2 and 4, and of
   config 4 at 78^3 (the gate's edge), must equal the separate kernels
   (stam.step3d_multi) bit for bit.  Then the whole step's kernel
   itself (csrc/step.cu): ptxas's registers, stack frame and spills (a
   stack frame or a spill fails), what an empty grid-wide barrier costs
   on its grid and others and in thread block clusters, its time at
   config 4 without diffusion, at 1 and 10 iterations and at other
   levels a pass, its tiles, k and F, its grid-wide barriers a step for
   configs 2 and 4, its barrier floor (barriers x the cost of one, in
   its row of the kernels line), and stam.step3d_multi's device-busy
   time at config 4 as a yardstick.
   The 2D kernels at config 1's 130^2 fields: the solve
   (csrc/grid2d.cu; a = 1, c = 4, b = 0, and config 1's diffusion at
   b = 1) and the whole step (csrc/step2d.cu; config 1, config 1 with
   buoyancy and vorticity, and config 1 at 1119^2, the gate's edge,
   where a block takes several diffusing (field, tile) pairs) must equal their plain versions bit for bit, and the
   whole step the multi-call step (stam.step2d_multi).  Then the whole
   2D step's kernel itself: ptxas's registers, stack frame and spills (a
   stack frame or a spill fails), its blocks x threads, its plan and
   grid-wide barriers a step for config 1 and the forcing case, its
   barrier floor (barriers x an empty barrier on its own grid) and its
   device time alone (torch.profiler) in its row of the kernels line,
   and its time without diffusion and at 1 and 10 iterations.  The
   blocked solves' floors are printed beside their bounds: one
   device-memory pass a (half-)sweep, and the blocked kernels' passes
   (csrc/rb_blocked.cu in float32 and bfloat16, csrc/jacobi_blocked.cu),
   at the bytes of their storage type.  Then the blocked kernels themselves: ptxas's registers, stack
   frame and spills of the red-black kernel in float32 and in bfloat16
   and of the bfloat16 Jacobi kernel (a stack frame or a spill fails),
   their shared memory a block and resident blocks, and their pass
   times by levels a pass: the float32 red-black pass at 256^3 by
   half-sweeps, the bfloat16 passes at 512^3 by half-sweeps and by
   sweeps.
3. Runs 4 steps of the bench.py scene and of BASELINE configs 2 and 4
   at 16^3, and of BASELINE config 1 at 32^2, on the card and on the CPU
   (plain versions) and compares them.
4. Drives eleven 3D grid configurations through
   tpufluids_torch.grid.stam.run3d_python: the bench.py scene (DCT) and
   config 3 (red-black Jacobi, "jacobi continuity") at 256^3 for 3
   warm-up and 30 timed steps, config 3 with plain Jacobi for 3 and 10,
   configs 2 and 4 at 64^3 for 3 and 400, as bench.py times them, the
   CLI's plume3d scene (gather advection, no whole step) at 64^3 for 3
   and 20; config 3 at 512^3 in float32 and then with the bfloat16
   solver (verify/bench_bf16_512.py) for 3 and 10 each, and their
   ms/step ratio; config 4 with the bfloat16 solver at 64^3 for 3 and
   100; config 3 with plain Jacobi and the bfloat16 solver, and with
   the multigrid projection (two V-cycles), at 256^3 for 3 and 10.
   Each first runs two steps through the kernels against two through
   the plain versions: one without the residual (at 64^3 the whole
   step, for stencil advection in float32) and one with it.  Checks
   shape, finiteness, the final Poisson residual and the kernel
   launches of the timed run.  Then the CLI's plume3d --mac scene
   through tpufluids_torch.grid.mac.run3d_python at 64^3, with the
   Jacobi projection (the whole solve) and with multigrid, for 3 and 20
   steps each, the same way, with no host sync allowed; multigrid must
   leave less divergence.  Then two 2D configurations through stam.run2d_python at
   128^2 with bench.py's sources: BASELINE config 1 (one whole-step
   launch a step) for 3 and 400 steps, and the CLI's smoke2d default
   (gather advection: five solve launches a step) for 3 and 100, with
   no host sync allowed; each first holds two steps through the kernels
   bitwise against two through the plain versions, and config 1's
   residual step against the plain one.  Every grid path then runs 10
   more steps under torch.profiler: device busy time, device ops a step,
   the device's idle share against the timed ms/step, the top kernels.
5. The base force kernels (csrc/sph_forces.cu): ptxas's registers,
   stack frame and spills of the four instances (row-block and column,
   fresh and stale) and of the pack kernel (a stack frame or a spill
   fails), and their launch shape.  Holds the SPH force kernel
   (base_forces_rowblock) against its plain version and against
   forces.base_lane_pass, the emulation of its lane schedule run on the
   card (1e-6 of max, the pair count exact), at the base_dam scene and
   at a 262144-particle uniform fill, on seeded dens, press and vel, and
   its pack kernel against the plain pack bit for bit, and times them
   with CUDA events.  The
   SPH force wrappers (here and in steps 8 and 11) also print the device
   time of their kernels alone (torch.profiler kernel events of
   csrc/sph_forces.cu's and csrc/sph_unidyn.cu's kernels over the timed
   calls), "kernel_ms" in their rows of the kernels line.
6. Runs 10 base_dam steps on the card and on the CPU (plain version)
   and compares them by particle id; runs 10 steps of the fill twice
   on the card and requires bitwise-equal results.
7. Drives the SPH base step through tpufluids_torch.step.run_python:
   base_dam for 3 warm-up and 300 timed steps, the fill for 3 and 10,
   with no host sync allowed in the timed steps.  Checks finiteness,
   the alive count, the mass, the bin overflow, that the dam column
   falls, and one kernel launch per step.
8. The unidyn force kernels (csrc/sph_unidyn.cu): ptxas's registers,
   stack frame and spills of pass A and pass B, uncapped and capped (a
   stack frame or a spill fails), and their launch shape (lanes a home
   row, blocks x threads, resident blocks).  Holds the wrappers
   (unidyn_forces_resident and unidyn_forces_rowblock) against their
   plain versions on mixed-phase inputs: the reference's
   14040-particle tank and a 46656-particle uniform fill at the tank's
   lattice density, with merging on at the fill.  Every output column
   must be nonzero.  Holds them against forces.unidyn_lane_pass, the
   emulation of their lane schedule, run on the card (1e-6 of max,
   pair counts and partners exact).  Times both with CUDA events, and
   pass A and pass B alone.
9. Runs 10 steps of the tank cut to 2808 particles on the card and on
   the CPU, and 3 steps of a merging mixed-phase blob, and compares
   them by particle id.
10. Drives the unidyn step through run_python on the full tank: 3
    warm-up and 300 timed steps with no host sync allowed, one resident
    kernel call per step.  Checks the alive count, the mass, the bin
    overflow, finiteness, that the fluid stays inside the walls and
    falls.  Then 20 steps through the row-block kernel must equal 20
    resident steps bitwise, and two resident runs each other.  The
    tank's step gets a torch.profiler window (device busy, ops a step,
    idle share).
11. Holds the column force kernels against their plain versions and
    times both: base_forces_column (csrc/sph_forces.cu) fresh and stale
    (xy_cells) at a 524288-particle uniform fill at its suggest_col_cap
    (584) and at base_dam forced to cap 32, over which its columns run;
    unidyn_forces_column (csrc/sph_unidyn.cu) on the mixed tank at cap
    128, and on the mixed 46656 fill at cap 64; each also against its
    lane emulation.  Holds the row-block
    kernel's stale mode against its plain version and its emulation at
    base_dam and the fill.  The overflow counts and the emulated stale
    window's pair counts (against the whole columns') must be equal and
    the rows over the cap zero; the stale window must walk fewer slots
    than the whole columns, and the pack kernel's column shifts equal
    forces.column_shift.  Then the identities, bit for bit: the column kernel equals
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
13. The sharded grid step (tpufluids_torch.shard, BASELINE config 5).
    Holds lin_solve3d_rb_shard (csrc/rb_blocked.cu) against its plain
    version bit for bit: one pass on face and inner x-slabs (gx0 > 0) of
    47^3 and 48^3 grids for fuse 1, 2 and 4, b 0 to 3, from a guess and
    from zeros, each also equal to the dense solve's rows; and the main
    path's call, config 5's pressure solve at 512^3 on a world of 1,
    timed against its plain version.  Holds the slab modes of the four
    stencil kernels against their plain versions bit for bit on the
    kernel step's padded slabs at 256^3.  Drives config 5 on a world of
    1: config 3's configuration at 512^3 through make_sharded_step, two
    steps bit for bit against two dense steps, then 2 warm-up and 10
    timed steps of the bench scene beside the unsharded config 3 of
    step 4, with its launches and a profile window; the kernel builds
    before the ranks start, and each rank loads it.  Then spawns worlds
    of 2 (256^3, and a DCT leg at 128^3) and 4 (128^3) processes that
    share the card over gloo, their halos staged through host memory
    (the Jacobi legs from seeded velocities, the DCT leg from the bench
    scene): 1 warm-up and 3 timed steps each, collected on rank 0 and held
    against the dense steps on the card, bit for bit (the DCT leg within
    1e-5 of max|field|, residual <= 1e-8); ms/step and staged bytes a
    step, correctness runs on one shared card, not scaling.

Prints the kernels' JSON line, with each kernel's least time on the card
(its bound: the bytes it must move at 3.35 TB/s, or its float32
operations at 67 TFLOP/s, whichever is larger), the card's name and
power limit, and as its last line {"ok": true, "device": {...}}.
Exits non-zero, without that line, when there is no CUDA device, when
the package is missing, or when any check fails.
"""

from __future__ import annotations

import contextlib
import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

N_BIG = 256
N_512 = 512              # verify/bench_bf16_512.py: the bfloat16 solver
N_WHOLE = 64             # BASELINE configs 2 and 4: the whole tier
N_STEP_EDGE = 78         # the largest n the whole step's gate admits
N_2D = 128               # BASELINE config 1
N_2D_BIG = 1119          # the whole 2D step's gate's edge: past the
                         # one-block design's gate (168), more diffusing
                         # (field, tile) pairs than blocks
SEED = 0
FIELDS = ("u", "v", "w", "dens", "temp")
TIME_REPS = 20
PROFILE_STEPS = 10       # steps of each grid path under torch.profiler
# the DCT projection's limit; a Jacobi residual is held to the plain
# step's instead (twenty sweeps leave about 1e-5)
MAX_RESIDUAL = 1e-8
RESIDUAL_RTOL = 1e-3
STEP_TOL = 1e-5          # one or four steps, relative to max|field|
# the card's peaks (H100 SXM data sheet and whitepaper): bytes/s of
# device memory, and float32 and bfloat16 operations/s outside the tensor
# cores (bfloat16 runs two to an instruction, at twice the float32 rate)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 133.8e12
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
    # bit for bit: the red-black solves, dense and sharded (config 5's
    # pressure solve), both through the temporally blocked kernel
    "lin_solve3d_rb": ("tpufluids_torch/csrc/rb_blocked.cu",
                       "tpufluids/grid/pallas_kernels.py:2285", 0.0),
    "lin_solve3d_rb_shard": ("tpufluids_torch/csrc/rb_blocked.cu",
                             "tpufluids/grid/pallas_kernels.py:2678", 0.0),
    # bit for bit: lin_solve3d_pallas(dtype=bfloat16) and its whole mode
    "lin_solve3d_bf16": ("tpufluids_torch/csrc/jacobi_blocked.cu",
                         "tpufluids/grid/pallas_kernels.py:2455", 0.0),
    "lin_solve3d_rb_bf16": ("tpufluids_torch/csrc/rb_blocked.cu",
                            "tpufluids/grid/pallas_kernels.py:2455", 0.0),
    "lin_solve3d_whole": ("tpufluids_torch/csrc/jacobi.cu",
                          "tpufluids/grid/pallas_kernels.py:136", 0.0),
    "diffuse3d_multi": ("tpufluids_torch/csrc/jacobi.cu",
                        "tpufluids/grid/pallas_kernels.py:247", 1e-6),
    "project3d_whole": ("tpufluids_torch/csrc/jacobi.cu",
                        "tpufluids/grid/pallas_kernels.py:1174", 1e-6),
    "step3d_whole": ("tpufluids_torch/csrc/step.cu",
                     "tpufluids/grid/pallas_kernels.py:1319", STEP_TOL),
    # bit for bit
    "lin_solve2d": ("tpufluids_torch/csrc/grid2d.cu",
                    "tpufluids/grid/pallas_kernels.py:1993", 0.0),
    "step2d_whole": ("tpufluids_torch/csrc/step2d.cu",
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
    "lin_solve3d_bf16": lambda a: 8 * a[5],
    "lin_solve3d_rb_bf16": lambda a: 8 * a[5],
    "lin_solve3d_whole": lambda a: 8 * a[5],
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
PLUME3D_KW = dict(dt=0.05, diff=1e-5, visc=1e-5, jacobi_iters=20,
                  buoyancy_alpha=0.05, buoyancy_beta=1.0)  # cli.py:190-197
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
    "plume3d (gather)": (dict(PLUME3D_KW, advect_mode="gather"), N_WHOLE,
                         3, 20),
    # config 3 at 512^3 in float32 and with the bfloat16 solver, one after
    # the other, as verify/bench_bf16_512.py compares them
    "config 3, float32": (dict(BENCH_KW, projection="jacobi"), N_512, 3, 10),
    "config 3, bf16 solver": (dict(BENCH_KW, projection="jacobi",
                                   solver_dtype="bfloat16"), N_512, 3, 10),
    # bf16 diffusion and projection: no whole step
    "config 4, bf16 solver": ({**CONFIG2_KW, **PLUME_KW,
                               "solver_dtype": "bfloat16"}, N_WHOLE, 3, 100),
    "config 3, plain Jacobi, bf16 solver": (
        dict(BENCH_KW, projection="jacobi", red_black=False,
             solver_dtype="bfloat16"), N_BIG, 3, 10),
    # the multigrid projection (cli.py:72-84; BASELINE.md:90)
    "config 3, multigrid": (dict(BENCH_KW, projection="multigrid",
                                 mg_cycles=2), N_BIG, 3, 10),
}
# mac.run3d_python's paths: the CLI's plume3d --mac (cli.py:87-90,
# 234-246), its defaults: name -> (configuration keywords, size, warm-up
# and timed steps)
MAC_PATHS = {
    "plume3d --mac": (PLUME3D_KW, N_WHOLE, 3, 20),
    "plume3d --mac, multigrid": (dict(PLUME3D_KW, projection="multigrid"),
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
# BASELINE config 5 (512^3 sharded, the Jacobi sweeps exchanged between
# slabs): config 3's configuration through the sharded step, on a world of
# 1 at 512^3 (warm-up and timed steps), and on worlds of 2 and 4 processes
# sharing the one card over gloo: name -> (n, configuration keywords,
# scene).  The Jacobi legs start from seeded velocities (seeded_grid); the
# DCT leg, held to MAX_RESIDUAL, from the bench scene that limit is set
# for, and runs every solve in full float32 (no TF32 first solve).
CONFIG5_STEPS = (2, 10)
SHARD_STEPS = (1, 3)
SHARD_KW = dict(BENCH_KW, projection="jacobi")
SHARD_WORLDS = {
    2: (("config 3, sharded", N_BIG, SHARD_KW, "seeded"),
        ("DCT, sharded", 128, dict(BENCH_KW, projection="dct"), "bench")),
    4: (("config 3, sharded", 128, SHARD_KW, "seeded"),),
}
DCT_SHARD_TOL = STEP_TOL     # relative to max|field|, against the dense step
# the SPH base step: 1e-5 * max|plain| for sum_w and each dpress column
SPH_KERNELS = {
    "base_forces_rowblock": ("tpufluids_torch/csrc/sph_forces.cu",
                             "tpufluids/sph_pallas.py:1438", 1e-5),
}
SPH_FILL = 262144             # step.ROWBLOCK_MAX_POOL
# the four instances of the base force kernel and its pack kernel in
# ptxas's output (mangled names)
BASE_ENTRIES = {f"{'column' if c else 'rowblock'}, "
                f"{'stale' if s else 'fresh'}":
                f"base_forces_kernelILb{int(c)}ELb{int(s)}E"
                for c in (False, True) for s in (False, True)}
BASE_ENTRIES["pack"] = "base_pack_kernel"
# the base force kernels alone before the lane schedule and the stale
# window (PERF.md rows 13 and 15), device-ms, and #15's wrapper and its
# row pack (torch ops then) at the 262144 fill, ms
BASE_BEFORE_MS = {"base_forces_rowblock, fresh, fill": 0.3956,
                  "base_forces_column, fresh, fill-524k": 1.278,
                  "base_forces_column, stale, fill-524k": 8.236,
                  "base_forces_rowblock wrapper, fill": 0.627,
                  "row pack, fill": 0.226}
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
# the unidyn kernels against forces.unidyn_lane_pass, the emulation of their
# lane schedule, run on the card: the same pairs summed in the same order,
# so only the per-pair arithmetic of torch and of the kernels rounds apart;
# 1e-6 * max|emulation| per output column
UNIDYN_LANE_TOL = 1e-6
# the base kernels against forces.base_lane_pass, likewise: 1e-6 * max
BASE_LANE_TOL = 1e-6
# the four instances of the unidyn passes in ptxas's output (mangled names)
UNIDYN_ENTRIES = {f"pass {p.upper()}, {'capped' if c else 'uncapped'}":
                  f"unidyn_pass_{p}_kernelILb{int(c)}E"
                  for p in "ab" for c in (False, True)}
# the two force kernels alone on the mixed tank before the lane schedule
# (PERF.md rows 14, 16 and 17), device-ms
UNIDYN_BEFORE_MS = {"unidyn_forces_resident": 1.108,
                    "unidyn_forces_rowblock": 1.106,
                    "unidyn_forces_column": 1.109}
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


def bound(nbytes, ops, ops_per_s=FP32_OPS_PER_S):
    """(ms, what bounds it): the least time for ``nbytes`` of device
    memory traffic and ``ops`` operations at ``ops_per_s`` (float32 by
    default)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
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


def bf16_storage(name, args):
    """True for a solve whose kernel stores its fields as bfloat16."""
    return name.endswith("_bf16") or (name == "lin_solve3d_whole"
                                      and args[7] == torch.bfloat16)


def grid_work(name, args, outs):
    """(bytes, operations, peak operations/s) of one grid kernel call:
    each input field read once, each output written once, GRID_OPS per
    interior cell; a bfloat16 solve moves 2 B a cell (its float32 casts
    are torch ops around it) and does bfloat16 operations."""
    n = outs[0].shape[0] - 2
    nbytes = sum(t.nbytes for t in tensors_in(args) + list(outs))
    ops = GRID_OPS[name](args) * n ** outs[0].dim()
    if bf16_storage(name, args):
        return nbytes // 2, ops, BF16_OPS_PER_S
    return nbytes, ops, FP32_OPS_PER_S


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


# the force kernels of csrc/sph_forces.cu and csrc/sph_unidyn.cu, by the
# names torch.profiler gives their launches
SPH_KERNEL_NAMES = ("base_forces_kernel", "unidyn_pass_a_kernel",
                    "unidyn_pass_b_kernel")


def kernel_alone_ms(fn, names=SPH_KERNEL_NAMES, reps=TIME_REPS, warm=3,
                    tries=3):
    """The device time a call of ``fn`` spends in the kernels whose names
    hold one of ``names`` (by default the SPH force kernels) alone,
    without the wrapper's torch ops or host work around them:
    torch.profiler's kernel events over ``reps`` calls after ``warm``, in
    ms a call.  The profiler may miss the first kernels it traces, so the
    warm-up calls run under it too and a spin kernel
    (torch.cuda._sleep) on the stream marks where the timed calls
    start; a run with fewer events than calls is made again, up to
    ``tries`` runs."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(warm):
                fn()
            torch.cuda._sleep(1000)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        stream = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(stream) if "spin_kernel" in e.name]
        timed = stream[marks[-1] + 1:] if marks else []
        events = [e for e in timed if any(k in e.name for k in names)]
        if len(events) >= reps:
            break
        log(f"kernel_alone_ms: {len(events)} events of {names} in {reps} "
            f"calls (spin kernel traced: {bool(marks)}); profiling again")
    check(len(events) >= reps, f"{len(events)} events of {names} in {reps} "
                               f"calls")
    return sum(e.device_time for e in events) / 1e3 / reps


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


def blocked_pass_bytes(x0, tile, chunks, halo_z, passes, written):
    """Device-memory bytes of blocked passes over field x0, at its element
    size a cell, as the kernels stream them: per pass each block reads x
    (unless the pass starts from a zero guess: ``passes`` holds (levels,
    reads x)) and x0 over its planes (rows lo .. hi of its chunk and the
    two it fetches past them), tile and halo (k deep in y, ``halo_z`` in
    z; the cells inside the array), and the pass writes ``written``
    cells."""
    rows, n = x0.shape[0], x0.shape[1] - 2

    def spans(size, halo):
        return sum(min(t0 + size + halo, n + 2) - max(t0 - halo, 0)
                   for t0 in range(1, n + 1, size))

    area = spans(tile.ty, tile.k) * spans(tile.tz, halo_z)
    total = 0
    for levels, reads_x in passes:
        planes = 0
        for i in range(chunks.count):
            _, _, lo, hi = chunks.rows(i, levels)
            planes += min(hi + 2, rows - 1) - lo + 1
        total += x0.element_size() * ((1 + reads_x) * planes * area
                                      + written)
    return total


def log_blocked_floors(name, x0, tile, chunks, halo_z, passes, written,
                       extra_bytes, sweeps, bound_ms):
    """Prints row ``name``'s floors: one device-memory pass (x, x0 in, x
    out) per (half-)sweep, the design the blocked kernels replaced, and
    the blocked passes (halo included), plus ``extra_bytes`` (the ghost
    or finish pass); returns the latter in ms."""
    one_ms = 3 * x0.nbytes * sweeps / HBM_BYTES_PER_S * 1e3
    nbytes = blocked_pass_bytes(x0, tile, chunks, halo_z, passes,
                                written) + extra_bytes
    k_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"{name} floors ({sweeps} (half-)sweeps, {x0.element_size()} B a "
        f"cell): bound {bound_ms:.4f} ms; blocked passes (k {tile.k}, "
        f"{len(passes)} launches, tile {tile.ty}x{tile.tz}, {nbytes} B) "
        f"{k_ms:.4f} ms; one pass a (half-)sweep {one_ms:.4f} ms")
    return k_ms


def log_solve_floors(kernels, name, x0, iters, bound_ms):
    """The floors of a dense blocked solve from a zero guess at x0's
    shape, in its kernel's storage type: the red-black passes and their
    ghost pass, or the bfloat16 Jacobi passes, which write every cell."""
    dtype = torch.bfloat16 if name.endswith("_bf16") else torch.float32
    x0 = torch.empty(x0.shape, dtype=dtype, device="meta")
    n = x0.shape[0] - 2
    if name == "lin_solve3d_bf16":
        tile = kernels.JACOBI_TILE
        passes = [(h, i > 0) for i, h in
                  enumerate(kernels.jacobi_passes(iters, tile.k))]
        return log_blocked_floors(name, x0, tile,
                                  kernels._jacobi_chunks_on(x0), tile.k + 1,
                                  passes, x0.numel(), 0, iters, bound_ms)
    tile = kernels.rb_tile(dtype)
    passes = [(p.half_sweeps, not p.first)
              for p in kernels.rb_passes(2 * iters, tile.k)]
    ghosts = x0.numel() - n ** 3
    return log_blocked_floors(name, x0, tile, kernels._rb_chunks_on(x0, 0),
                              tile.k, passes, n ** 3,
                              2 * x0.element_size() * ghosts, 2 * iters,
                              bound_ms)


# the blocked kernels' instantiations in ptxas's output: name -> (the
# mangled entry holds each of these, and not these)
BLOCKED_ENTRIES = {
    "rb_blocked float32": (("rb_blocked_kernel",), ("__nv_bfloat16",)),
    "rb_blocked bfloat16": (("rb_blocked_kernel", "__nv_bfloat16"), ()),
    "jacobi_blocked bfloat16": (("jacobi_blocked_kernel",), ()),
}


def check_blocked(stam, kernels, dev, build_log):
    """The blocked kernels' builds (ptxas: registers, stack frame, spills
    of the red-black kernel in float32 and bfloat16 and of the bfloat16
    Jacobi kernel; a stack frame or a spill fails) and shared memory per
    block, then their pass times by levels a pass: the float32 red-black
    pass at the main path's 256^3 by half-sweeps, and the bfloat16 passes
    at 512^3 (config 3 with the bf16 solver) by half-sweeps and sweeps:
    what one level costs.  (The solves themselves are held bit for bit
    against the plain ones and timed in check_kernels.)"""
    entry = None
    found = {}
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            entry = entry if "blocked_kernel" in entry else None
        elif entry and "stack frame" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            found.setdefault(entry, {})["stack_spill"] = nums
        elif entry and "registers" in line:
            found.setdefault(entry, {})["registers"] = int(
                line.split("Used ")[1].split()[0])
    check(len(found) == len(BLOCKED_ENTRIES),
          f"ptxas lines of {len(found)} blocked kernels, expected "
          f"{len(BLOCKED_ENTRIES)}")
    jt = kernels.JACOBI_TILE
    cur = torch.cuda.current_device()
    infos = {"rb_blocked float32": (kernels.RB_TILE,
                                    kernels.rb_tile_info(cur)),
             "rb_blocked bfloat16": (kernels.RB_TILE_BF16, kernels.rb_tile_info(
                 cur, torch.bfloat16)),
             "jacobi_blocked bfloat16": (jt, kernels.jacobi_tile_info(cur))}
    for kind, (has, lacks) in BLOCKED_ENTRIES.items():
        names = [e for e in found if all(k in e for k in has)
                 and not any(k in e for k in lacks)]
        check(len(names) == 1, f"{kind}: ptxas entries {names}")
        info = found[names[0]]
        tile, (slots, smem) = infos[kind]
        check(f"ILi{tile.k}ELi{tile.ty}ELi{tile.tz}E" in names[0],
              f"the compiled {kind} kernel {names[0]} is not {tile}")
        log(f"{kind} (k {tile.k}, {tile.ty}x{tile.tz}): "
            f"{info['registers']} registers, stack frame, spill stores, "
            f"spill loads {info['stack_spill']} B; {smem} B shared memory a "
            f"block, {slots} resident blocks")
        check(not any(info["stack_spill"]),
              f"{kind}: stack frame or spill {info['stack_spill']}")
    rng = np.random.default_rng(SEED + 10)
    for n, dtype in ((N_BIG, torch.float32), (N_512, torch.bfloat16)):
        p = stam.set_bnd3d(0, torch.from_numpy(rng.uniform(
            0.0, 1.0, (n + 2,) * 3).astype(np.float32)).to(dev)).to(dtype)
        out = torch.empty_like(p)
        chunks = kernels._rb_chunks_on(p, 0)
        for h in range(1, kernels.rb_tile(dtype).k + 1):
            ms = time_ms(lambda h=h: kernels._rb_pass(
                p, p, out, 0, chunks, kernels.RbPass(h, 0, False), 0, 1.0,
                1 / 6))
            log(f"rb_blocked {str(dtype).removeprefix('torch.')} pass @ "
                f"{n}^3, {h} half-sweeps: {ms:.4f} ms ({ms / h:.4f} ms a "
                f"half-sweep)")
        if dtype == torch.bfloat16:
            chunks = kernels._jacobi_chunks_on(p)
            for h in range(1, jt.k + 1):
                ms = time_ms(lambda h=h: kernels._jacobi_pass(
                    p, p, out, chunks, h, 0, 1.0, 1 / 6))
                log(f"jacobi_blocked bfloat16 pass @ {n}^3, {h} sweeps: "
                    f"{ms:.4f} ms ({ms / h:.4f} ms a sweep)")
        del out, p
        torch.cuda.empty_cache()


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
    # the whole step's gate's edge (kernels.step_whole_ok)
    u78, v78, w78 = (field(N_STEP_EDGE, b, -1.0, 1.0) for b in (1, 2, 3))
    d78, t78 = (field(N_STEP_EDGE, 0, 0.0, 1.0) for _ in range(2))

    def field2d(b, lo, hi, n=N_2D):
        a = rng.uniform(lo, hi, (n + 2,) * 2).astype(np.float32)
        return stam.set_bnd2d(b, torch.from_numpy(a).to(dev))

    c1 = grid2d_config(stam, "config 1")
    c1_forced = c1.replace(buoyancy_alpha=0.04, buoyancy_beta=0.9,
                           vorticity_eps=1.5)
    a1 = c1.dt * c1.visc * N_2D ** 2
    u2, v2 = (field2d(b, -1.2 / (c1.dt * N_2D), 1.2 / (c1.dt * N_2D))
              for b in (1, 2))
    d2, t2, p2 = (field2d(0, 0.0, 1.0) for _ in range(3))
    # the whole 2D step past the one-block design's gate
    c1_big = grid2d_config(stam, "config 1", N_2D_BIG)
    u2b, v2b = (field2d(b, -1.2 / (c1.dt * N_2D_BIG),
                        1.2 / (c1.dt * N_2D_BIG), N_2D_BIG) for b in (1, 2))
    d2b, t2b = (field2d(0, 0.0, 1.0, N_2D_BIG) for _ in range(2))
    # the bfloat16 solves' pressure right-hand sides: 512^3 (config 3 with
    # the bf16 solver) and 64^3
    p512 = field(N_512, 0, 0.0, 1.0)
    p64 = field(N_WHOLE, 0, 0.0, 1.0)
    f32, bf16 = torch.float32, torch.bfloat16
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
        "lin_solve3d_bf16": [(0, None, p512, 1.0, 6.0, 20)],
        "lin_solve3d_rb_bf16": [(0, None, p512, 1.0, 6.0, 20)],
        # the 64^3 pressure solves: plume3d --mac's (float32 Jacobi) and
        # config 4's with the bf16 solver (red-black)
        "lin_solve3d_whole": [(0, None, p64, 1.0, 6.0, 20, rb, dt)
                              for dt in (f32, bf16) for rb in (False, True)],
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
    # whole step with buoyancy and vorticity, and past 168
    checked_only = {
        "lin_solve3d": [(1, u, u, a2, 1 + 6 * a2, 20)],
        "lin_solve3d_rb": [(1, u, u, a2, 1 + 6 * a2, 20)],
        "lin_solve3d_bf16": [(1, u64, u64, a2, 1 + 6 * a2, 20)],
        "lin_solve3d_rb_bf16": [(1, u64, u64, a2, 1 + 6 * a2, 20)],
        "lin_solve3d_whole": [(1, u64, u64, a2, 1 + 6 * a2, 20, rb, dt)
                              for dt in (f32, bf16) for rb in (False, True)],
        "step3d_whole": [(u64, v64, w64, d64, t64, c2),
                         (u64, v64, w64, d64, t64,
                          c4.replace(red_black=False)),
                         (u78, v78, w78, d78, t78,
                          grid_config(stam, "config 4", N_STEP_EDGE))],
        "step2d_whole": [(u2, v2, d2, t2, c1_forced),
                         (u2b, v2b, d2b, t2b, c1_big)],
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
                log(f"step3d_whole @ {args[0].shape[0] - 2}^3, red_black "
                    f"{args[5].red_black}, forcing "
                    f"{bool(args[5].vorticity_eps)}: bitwise equal to "
                    f"stam.step3d_multi: {same}")
                check(same, "step3d_whole differs from stam.step3d_multi")
            if name == "lin_solve3d_whole":
                check_whole_solve(kernels, args, got[0])
            if name == "step2d_whole":
                sep = stam.step2d_multi(stam.GridState2D(*args[:4]), args[4])
                same = all(torch.equal(g, getattr(sep, f))
                           for g, f in zip(got, FIELDS2D))
                n2 = args[0].shape[0] - 2
                blocks, _, smem = kernels.step2d_info(
                    torch.cuda.current_device())
                plan = kernels.step2d_plan(n2, args[4], blocks, smem)
                pairs = (kernels.step2d_fields(args[4])
                         * plan.diffuse.count(n2))
                log(f"step2d_whole @ {n2}^2, forcing "
                    f"{bool(args[4].vorticity_eps)}: {pairs} diffusing "
                    f"(field, tile) pairs and {plan.project.count(n2)} "
                    f"pressure tiles on {blocks} blocks; bitwise equal to "
                    f"the plain step and stam.step2d_multi: "
                    f"{same and e == 0.0}")
                if n2 == N_2D_BIG:
                    check(pairs > blocks, f"step2d_whole @ {n2}^2: the "
                          f"diffusion's pairs are no more than the blocks")
                check(same, "step2d_whole differs from stam.step2d_multi")
        tol = KERNELS[name][2]
        # per call, averaged over the call shapes of the step
        ms = [time_ms(lambda a=a: kern(*a)) for a in arg_sets]
        plain_ms = [time_ms(lambda a=a: plain(*a)) for a in arg_sets]
        # each call's bound at the peak of its own type, then averaged as
        # the times are
        bounds = [bound(*w) for w in work]
        bound_ms = float(np.mean([t for t, _ in bounds]))
        by_bytes = sum(t for t, by in bounds if by == "bytes")
        bound_by = "bytes" if 2 * by_bytes >= len(bounds) * bound_ms \
            else "operations"
        timed = tensors_in(arg_sets[0])[0]
        log(f"kernel {name} timed @ {timed.shape[0] - 2}^{timed.dim()}: "
            f"max_abs_err "
            f"{err:.3e} (relative {rel:.3e}, tolerance {tol:.0e}); ms per "
            f"call: kernel {ms}, plain {plain_ms}; bound {bound_ms:.4f} ms "
            f"({bound_by}; per call {bounds}; bytes, operations, peak "
            f"operations/s per call: {work})")
        check(rel <= tol, f"{name}: kernel disagrees with its plain version "
                          f"({rel:.3e} > {tol:.0e})")
        if name == "lin_solve3d_rb_bf16":
            # the bf16 route ran: its result is not the float32 solve's
            bf16_out = kern(*arg_sets[0])
            f32_out = kernels.lin_solve3d_rb(*arg_sets[0])
            diff = float((bf16_out - f32_out).abs().max()
                         / f32_out.abs().max())
            log(f"lin_solve3d_rb_bf16 @ {N_512}^3 against the float32 "
                f"lin_solve3d_rb: {diff:.3e} of max|p|")
            check(diff > 1e-4, "the bfloat16 solve equals the float32 one")
            del bf16_out, f32_out
        # no single PyTorch call computes any of these functions
        results[name] = {"max_abs_err": err, "ms": float(np.mean(ms)),
                         "plain_ms": float(np.mean(plain_ms)),
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": None}
        if name in ("lin_solve3d_rb", "lin_solve3d_rb_bf16",
                    "lin_solve3d_bf16"):
            _, _, x0, _, _, iters = arg_sets[0]
            log_solve_floors(kernels, name, x0, iters, bound_ms)
        if len(arg_sets) > 1:
            # the averaged call shapes one by one
            results[name]["calls"] = [
                {"call": call_label(name, i, a), "ms": m, "plain_ms": pm,
                 "bound_ms": b[0], "bound_by": b[1]}
                for i, (a, m, pm, b) in enumerate(zip(arg_sets, ms, plain_ms,
                                                      bounds))]
    return results


def call_label(name, i, args):
    """A short name for the i-th timed call shape of a grid kernel."""
    if name == "lin_solve3d_whole":
        return (f"{str(args[7]).removeprefix('torch.')}, "
                f"{'red-black' if args[6] else 'Jacobi'}")
    return f"call {i}"


def check_whole_solve(kernels, args, got):
    """The whole solve equals the streamed kernel of its type and
    red-black mode, bit for bit."""
    b, x, x0, a, c, iters, red_black, dtype = args
    streamed = {(torch.float32, False): kernels.lin_solve3d,
                (torch.float32, True): kernels.lin_solve3d_rb,
                (torch.bfloat16, False): kernels.lin_solve3d_bf16,
                (torch.bfloat16, True): kernels.lin_solve3d_rb_bf16}
    same = torch.equal(got, streamed[dtype, red_black](b, x, x0, a, c,
                                                       iters))
    log(f"lin_solve3d_whole @ {x0.shape[0] - 2}^3, {dtype}, red_black "
        f"{red_black}, b {b}: bitwise equal to the streamed solve: {same}")
    check(same, "lin_solve3d_whole differs from the streamed solve")


# kernel #7's time at config 4, 64^3, before its redesign (PERF.md row 7)
STEP_WHOLE_BEFORE_MS = 0.548
# kernel #9's time at config 1, 128^2, before its redesign (PERF.md row 9)
STEP2D_WHOLE_BEFORE_MS = 0.584


def ptxas_entry(build_log, key):
    """{"registers", "stack_spill": [stack frame, spill stores, spill
    loads] in bytes} from nvcc's -Xptxas -v lines of the one kernel entry
    whose mangled name holds ``key``."""
    entry, info = None, {}
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            entry = entry if key in entry else None
        elif entry and "stack frame" in line:
            info["stack_spill"] = [int(w) for w in line.replace(
                ",", " ").split() if w.isdigit()]
        elif entry and "registers" in line:
            info["registers"] = int(line.split("Used ")[1].split()[0])
    check(set(info) == {"stack_spill", "registers"},
          f"ptxas lines of {key}: {info}")
    return info


def barrier_us(grid, threads):
    """us a barrier of empty grid-wide barriers in one cooperative launch
    of ``grid`` blocks of ``threads``: a launch of 1000 less one of 0,
    over 1000."""
    from tpufluids_torch import _build
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream

    def run(count):
        rc = lib.tf_barrier_probe(grid, threads, count, stream)
        check(rc == 0, f"barrier probe {grid} x {threads}: "
                       f"{lib.tf_error_string(rc).decode()}")

    return time_ms(lambda: run(1000)) - time_ms(lambda: run(0))


def check_step_whole(stam, kernels, dev, build_log, checked):
    """The whole step's kernel (csrc/step.cu): ptxas's registers, stack
    frame and spills (a stack frame or a spill fails); what an empty
    grid-wide barrier costs on its grid and on the grid of the design it
    replaced; its time at config 4 with the diffusion off and at 1 and 10
    iterations; its plan (tiles, k and F, shared memory) and grid-wide
    barriers a step for configs 2 and 4; its barrier floor (barriers a
    step x the cost of one) beside its bound, added to its row of the
    kernels line; and stam.step3d_multi's device-busy time at config 4,
    64^3, the separate kernels, as a yardstick beside it."""
    info = ptxas_entry(build_log, "step_whole_kernel")
    blocks, threads, smem = kernels.step_info(torch.cuda.current_device())
    log(f"step_whole_kernel: {info['registers']} registers, stack frame, "
        f"spill stores, spill loads {info['stack_spill']} B; {blocks} "
        f"blocks of {threads} threads (one a multiprocessor), up to {smem} B "
        f"of shared memory a block; no thread block clusters")
    check(not any(info["stack_spill"]),
          f"step_whole_kernel: stack frame or spill {info['stack_spill']}")
    per_ms = barrier_us(blocks, threads) / 1e3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # the grid of the design this replaces: 528 blocks of 256 threads, 4 a
    # multiprocessor at its 56 registers
    log(f"empty grid-wide barriers, one cooperative launch of 1000 less one "
        f"of 0: {per_ms * 1e3:.4f} us a barrier on the step's grid ({blocks} "
        f"x {threads}), {barrier_us(4 * sms, 256):.4f} us on the replaced "
        f"design's ({4 * sms} x 256)")
    # where the blocked passes' time goes: the step at config 4 with the
    # diffusion off and at other iteration counts
    c4 = grid_config(stam, "config 4")
    state = grid_state(stam, "config 4", c4, dev)
    fields = tuple(getattr(state, f) for f in FIELDS)
    for label, cfg in (("shipped", c4),
                       ("no diffusion", c4.replace(visc=0.0, diff=0.0)),
                       ("1 iteration", c4.replace(jacobi_iters=1)),
                       ("10 iterations", c4.replace(jacobi_iters=10))):
        plan = kernels.step_plan(N_WHOLE, cfg, blocks, smem)
        ms = time_ms(lambda: kernels.step3d_whole(*fields, cfg))
        log(f"  step3d_whole @ {N_WHOLE}^3, config 4, {label}: {ms:.4f} ms, "
            f"{kernels.step_barriers(cfg, plan)} barriers, passes "
            f"(diffusion, each projection) {kernels.step_passes(cfg, plan)}")
    for path in ("config 2", "config 4"):
        cfg = grid_config(stam, path)
        plan = kernels.step_plan(cfg.n, cfg, blocks, smem)
        count = kernels.step_barriers(cfg, plan)
        p, d = plan.project, plan.diffuse
        log(f"{path} @ {cfg.n}^3: {count} grid-wide barriers a step (before "
            f"the redesign about 130); pressure passes of k = "
            f"{plan.rb_levels} half-sweeps on {p.count(cfg.n)} tiles of "
            f"{p.tx}x{p.ty}x{p.tz} (halo {p.halo}), diffusion passes of F = "
            f"{plan.jacobi_levels} sweeps on {d.count(cfg.n)} tiles of "
            f"{d.tx}x{d.ty}x{d.tz} (halo {d.halo}) for "
            f"{kernels.step_fields(cfg)} fields; {plan.smem} B of shared "
            f"memory a block; barrier floor {count * per_ms:.4f} ms")
    row = checked["step3d_whole"]
    row["barriers"] = count
    row["barrier_floor_ms"] = count * per_ms
    log(f"step3d_whole @ {N_WHOLE}^3, config 4: {row['ms']:.4f} ms (before "
        f"the redesign {STEP_WHOLE_BEFORE_MS} ms), bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}), barrier floor "
        f"{row['barrier_floor_ms']:.4f} ms ({count} barriers x "
        f"{per_ms * 1e3:.4f} us)")
    wall, busy, ops, _ = device_profile(
        lambda k: [stam.step3d_multi(state, cfg) for _ in range(k)],
        PROFILE_STEPS)
    log(f"stam.step3d_multi @ {N_WHOLE}^3, config 4 (the separate kernels): "
        f"device busy {busy:.4f} ms a step in {ops:.1f} device ops "
        f"({wall:.4f} ms a step on the host clock under torch.profiler), "
        f"against step3d_whole's {row['ms']:.4f} ms")


def check_step2d_whole(stam, kernels, dev, build_log, checked):
    """The whole 2D step's kernel (csrc/step2d.cu): ptxas's registers,
    stack frame and spills (a stack frame or a spill fails); its blocks x
    threads; its plan and grid-wide barriers a step for config 1 and the
    forcing case; its barrier floor (barriers a step x an empty grid-wide
    barrier on its own grid) beside its bound, added to its row of the
    kernels line with its device time alone; that time at config 1
    without diffusion and at 1 and 10 iterations."""
    info = ptxas_entry(build_log, "step2d_whole_kernel")
    blocks, threads, smem = kernels.step2d_info(torch.cuda.current_device())
    log(f"step2d_whole_kernel: {info['registers']} registers, stack frame, "
        f"spill stores, spill loads {info['stack_spill']} B; {blocks} blocks "
        f"x {threads} threads, up to {smem} B of shared memory a block")
    check(not any(info["stack_spill"]),
          f"step2d_whole_kernel: stack frame or spill {info['stack_spill']}")
    check(blocks > 1, f"step2d_whole runs on {blocks} block")
    per_ms = barrier_us(blocks, threads) / 1e3
    c1 = grid2d_config(stam, "config 1")
    forced = c1.replace(buoyancy_alpha=0.04, buoyancy_beta=0.9,
                        vorticity_eps=1.5)
    counts = {}
    for label, cfg in (("config 1", c1), ("forcing", forced)):
        plan = kernels.step2d_plan(N_2D, cfg, blocks, smem)
        counts[label] = kernels.step2d_barriers(cfg, plan)
        p, d = plan.project, plan.diffuse
        log(f"step2d_whole @ {N_2D}^2, {label}: {counts[label]} grid-wide "
            f"barriers a step (before the redesign about 105 block "
            f"barriers); passes of F = {plan.levels} sweeps, the pressure's "
            f"on {p.count(N_2D)} tiles of {p.tx}x{p.ty} (halo {p.halo}), the "
            f"diffusions' on {d.count(N_2D)} tiles of {d.tx}x{d.ty} (halo "
            f"{d.halo}) for {kernels.step2d_fields(cfg)} fields; "
            f"{plan.smem} B of shared memory a block; barrier floor "
            f"{counts[label] * per_ms:.4f} ms ({per_ms * 1e3:.4f} us an "
            f"empty barrier on {blocks} x {threads})")
    rng = np.random.default_rng(SEED + 11)
    u, v = (stam.set_bnd2d(b, torch.from_numpy(rng.uniform(
        -1.2 / (c1.dt * N_2D), 1.2 / (c1.dt * N_2D),
        (N_2D + 2,) * 2).astype(np.float32)).to(dev)) for b in (1, 2))
    d, t = (stam.set_bnd2d(0, torch.from_numpy(rng.uniform(
        0.0, 1.0, (N_2D + 2,) * 2).astype(np.float32)).to(dev))
        for _ in range(2))
    for label, cfg in (("no diffusion", c1.replace(visc=0.0, diff=0.0)),
                       ("1 iteration", c1.replace(jacobi_iters=1)),
                       ("10 iterations", c1.replace(jacobi_iters=10))):
        plan = kernels.step2d_plan(N_2D, cfg, blocks, smem)
        ms = kernel_alone_ms(lambda: kernels.step2d_whole(u, v, d, t, cfg),
                             ("step2d_whole_kernel",))
        log(f"  step2d_whole @ {N_2D}^2, config 1, {label}: the kernel "
            f"alone {ms:.4f} device-ms, "
            f"{kernels.step2d_barriers(cfg, plan)} barriers, passes "
            f"(diffusion, each projection) "
            f"{kernels.step2d_passes(cfg, plan)}")
    row = checked["step2d_whole"]
    row["barriers"] = counts["config 1"]
    row["barrier_floor_ms"] = counts["config 1"] * per_ms
    row["kernel_ms"] = kernel_alone_ms(
        lambda: kernels.step2d_whole(u, v, d, t, c1), ("step2d_whole_kernel",))
    log(f"step2d_whole @ {N_2D}^2, config 1: {row['ms']:.4f} ms a wrapper "
        f"call, the kernel alone {row['kernel_ms']:.4f} device-ms (before "
        f"the redesign {STEP2D_WHOLE_BEFORE_MS} ms), bound "
        f"{row['bound_ms']:.5f} "
        f"ms ({row['bound_by']}), barrier floor "
        f"{row['barrier_floor_ms']:.4f} ms ({row['barriers']} barriers x "
        f"{per_ms * 1e3:.4f} us)")


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


def solve_kernel(kernels, n, red_black, dtype):
    """The kernel of one stam._lin_solve3d call at size n: float32
    red-black streams (lin_solve3d_rb); the rest take the whole solve
    inside its gate, counted in the bytes of their storage type, and
    stream otherwise."""
    from tpufluids_torch.grid.stam import solver_dtype
    dt = solver_dtype(dtype)
    if dt == torch.float32 and red_black:
        return "lin_solve3d_rb"
    if kernels.solve_whole_ok(torch.empty((n + 2,) * 3, device="meta"), dt):
        return "lin_solve3d_whole"
    if dt == torch.float32:
        return "lin_solve3d"
    return "lin_solve3d_rb_bf16" if red_black else "lin_solve3d_bf16"


def add_solves(want, kernels, cfg, n, count):
    """Add the launches of ``count`` pressure solves at size n: one
    Jacobi solve each, or mg_cycles V-cycles, each two red-black
    smoothings a level and one on the coarsest (n <= 8 or odd), in
    cfg.solver_dtype from 48^3 up and in float32 below."""
    if cfg.projection == "dct":
        return
    if cfg.projection != "multigrid":
        name = solve_kernel(kernels, n, cfg.red_black, cfg.solver_dtype)
        want[name] += count
        return
    m = n
    while True:
        dtype = cfg.solver_dtype if m >= 48 else "float32"
        name = solve_kernel(kernels, m, True, dtype)
        coarsest = m <= 8 or m % 2
        want[name] += count * cfg.mg_cycles * (1 if coarsest else 2)
        if coarsest:
            return
        m //= 2


def expected_launches(kernels, cfg, steps, state):
    """Launches of a ``steps``-step run3d_python run.  A float32 stencil
    Jacobi run at the whole step's size launches step3d_whole once a
    step but the last; the last step reports the residual, so it runs
    the separate kernels (as every step of the other runs does): two
    stencil advections (none for gather advection, which is torch ops)
    and a forcing (if any), and per projection div, the solves and
    gradsub, or for float32 Jacobi at the whole tier one fused call; the
    diffusions in one whole-tier call (float32 at the whole tier) or a
    solve a field.  The last step's final projection always streams."""
    n = state.u.shape[0] - 2
    f32 = cfg.solver_dtype == "float32"
    jacobi = cfg.projection == "jacobi"
    stencil = cfg.advect_mode == "stencil"
    whole = f32 and kernels.solve_whole_ok(state.u, torch.float32)
    fused = jacobi and stencil and whole and kernels.step_whole_ok(state.u)
    separate = 1 if fused else steps
    want = dict.fromkeys(KERNELS, 0)
    want["step3d_whole"] = steps - separate
    want["advect3d_multi"] = 2 * separate if stencil else 0
    if cfg.buoyancy_alpha or cfg.buoyancy_beta or cfg.vorticity_eps:
        want["forcing3d"] = separate
    streamed = 1 if jacobi and whole else 2 * separate
    if jacobi and whole:
        want["project3d_whole"] = 2 * separate - 1
    want["div3d"] = want["gradsub3d"] = streamed
    add_solves(want, kernels, cfg, n, streamed)
    if whole:
        want["diffuse3d_multi"] = separate * (
            bool(cfg.visc) + bool(cfg.diff or cfg.temp_diff))
    else:
        fields = 3 * bool(cfg.visc) + bool(cfg.diff) + bool(cfg.temp_diff)
        want[solve_kernel(kernels, n, False, cfg.solver_dtype)] += (
            separate * fields)
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
    if cfg.projection != "dct":
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
        # twenty sweeps or two V-cycles: held to the plain step above,
        # here only sane
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
    return counts, ms


def mac_state(mac, cfg, device):
    """The CLI's plume3d --mac seeding (cli.py:236-241): dens 1 and temp
    3 in [3k:5k, 3k:5k, 0:k], k = n/8."""
    s = mac.make_mac3d(cfg, device)
    k = cfg.n // 8
    s.dens[3 * k:5 * k, 3 * k:5 * k, 0:k] = 1.0
    s.temp[3 * k:5 * k, 3 * k:5 * k, 0:k] = 3.0
    return s


def run_mac_path(stam, mac, kernels, dev, path):
    """Two MAC steps through the kernels against two through the plain
    versions; then the warm-up and the timed run (no host sync allowed),
    whose launch counts and ms/step are returned: the face-space stages
    are torch ops, each projection's solve a kernel call (a multigrid
    projection its V-cycles' smoothings)."""
    kw, n, warm, timed = MAC_PATHS[path]
    cfg = stam.StamConfig(n=n, **kw)
    state = mac_state(mac, cfg, dev)

    one, res = mac.run3d_python(state, cfg, 2)
    with plain_kernels(kernels):
        ref, ref_res = mac.run3d_python(state, cfg, 2)
    torch.cuda.synchronize()
    e, r = rel_err([getattr(one, f) for f in FIELDS],
                   [getattr(ref, f) for f in FIELDS])
    res, ref_res = float(res[0]), float(ref_res[0])
    log(f"{path} @ {n}^3, two steps, kernels vs plain versions: "
        f"max_abs_err {e:.3e} (relative {r:.3e}, tolerance "
        f"{STEP_TOL:.0e}); max |div u| {res:.6e}, plain {ref_res:.6e}")
    check(r <= STEP_TOL, f"{path}: two steps through the kernels and two "
                         f"through the plain versions disagree")
    check(abs(res - ref_res) <= RESIDUAL_RTOL * ref_res,
          f"{path}: max |div u| {res:.6e} against the plain step's "
          f"{ref_res:.6e}")
    del one, ref

    state, res = mac.run3d_python(state, cfg, warm)
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        state, res = mac.run3d_python(state, cfg, timed)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    ms = seconds / timed * 1e3
    residual = float(res[0])
    finite = all(bool(torch.isfinite(getattr(state, f)).all())
                 for f in FIELDS)
    log(f"{path} @ {n}^3, {timed} timed steps after {warm} warm-up: "
        f"{ms:.4f} ms/step, {n ** 3 / (ms / 1e3):.4e} cell-updates/s, "
        f"final max |div u| {residual:.6e}, finite {finite}")
    log(f"launches: {counts}")
    shapes = {"u": (n + 1, n, n), "v": (n, n + 1, n), "w": (n, n, n + 1),
              "dens": (n,) * 3, "temp": (n,) * 3}
    check(all(getattr(state, f).shape == shapes[f] for f in FIELDS),
          f"{path}: field shapes")
    check(finite and 0.0 < residual, f"{path}: fields not finite, or no "
                                     f"divergence left")
    check(float(state.w.abs().max()) > 0.0, f"{path}: the plume did not "
                                            f"move")
    want = dict.fromkeys(KERNELS, 0)
    add_solves(want, kernels, cfg, n, 2 * timed)
    check(counts == want, f"{path}: launches {counts} != {want}")
    log_profile(path, lambda k: mac.run3d_python(state, cfg, k), ms)
    return counts, ms, residual


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


def check_base_build(sph, build_log):
    """The base force kernels' builds (ptxas: registers, stack frame and
    spills of the four instances and the pack kernel; a stack frame or a
    spill fails) and their launch shape: lanes a home row, blocks x
    threads at each scene, blocks a multiprocessor keeps resident."""
    for what, key in BASE_ENTRIES.items():
        info = ptxas_entry(build_log, key)
        log(f"base {what}: {info['registers']} registers, stack frame, "
            f"spill stores, spill loads {info['stack_spill']} B")
        check(not any(info["stack_spill"]),
              f"base {what}: stack frame or spill {info['stack_spill']}")
    shape = sph.sph_kernels.base_info(torch.cuda.current_device())
    lanes, threads = shape["lanes"], shape["threads"]
    check(lanes == sph.sph_kernels.BASE_LANES,
          f"the base kernels take {lanes} lanes a row, "
          f"sph_kernels.BASE_LANES is {sph.sph_kernels.BASE_LANES}")
    for n in (8000, SPH_FILL, BIG_FILL):
        log(f"base force kernels at {n} rows: {lanes} lanes a home row, "
            f"{-(-n * lanes // threads)} blocks x {threads} threads; "
            f"resident blocks a multiprocessor: {shape['resident']}")


def check_base_lanes(sph, got, st, bt, cfg, caps, stale, pairs, what):
    """A base wrapper's result ``got`` against forces.base_lane_pass on
    the same inputs (the kernels' lane schedule and stale window emulated
    in torch): each output column within BASE_LANE_TOL of max|emulation|,
    and the emulation's pair count equal to ``pairs``, pair_count's (the
    whole columns', stale)."""
    lanes = sph.sph_kernels.BASE_LANES
    want = sph.forces.base_lane_pass(st, bt, cfg, lanes, caps, stale)
    worst, err, same = 0.0, 0.0, 0
    for g, w in zip([got[0], *got[1].unbind(1)],
                    [want[0], *want[1].unbind(1)]):
        scale = float(w.abs().max())
        e = float((g - w).abs().max())
        check(scale > 0.0, f"{what}: a lane emulation column is 0")
        worst, err = max(worst, e / scale), max(err, e)
        same += int(torch.equal(g, w))
    walked = int(want[2])
    log(f"  {what} against the lane emulation ({lanes} lanes): max_abs_err "
        f"{err:.3e} (worst column relative {worst:.3e}, tolerance "
        f"{BASE_LANE_TOL:.0e}), {same} of 4 columns bit for bit; pairs "
        f"{walked} (whole-column count {pairs})")
    check(worst <= BASE_LANE_TOL, f"{what} disagrees with the lane emulation")
    check(walked == pairs, f"{what}: the emulated walk sums {walked} pairs, "
                           f"the whole columns hold {pairs}")


def bits(t):
    """A float tensor's bit patterns: NaN rows compare equal."""
    return t.view(torch.int32)


def check_base_pack(sph, st, bt, cfg, stale, what):
    """The pack kernel against forces.pack_rows (and, stale, cell_trunc
    and forces.column_shift), bit for bit; returns (the wrapper's ms a
    call, the kernel alone in device-ms)."""
    rows, cells, shift = sph.sph_kernels.base_pack(st, bt, cfg, bt.order,
                                                   stale)
    want = sph.forces.pack_rows(st, bt.order, bt.in_dom)
    torch.cuda.synchronize()
    same = torch.equal(bits(rows), bits(want))
    if stale:
        now = sph.binning.cell_trunc(want[:, 0:3], cfg)
        same = (same and torch.equal(bits(cells[:, 0:3]), bits(now))
                and not cells[:, 3].any()
                and torch.equal(shift, sph.forces.column_shift(want, bt,
                                                                cfg)))
    else:
        same = same and cells is None and shift is None
    call = functools.partial(sph.sph_kernels.base_pack, st, bt, cfg,
                             bt.order, stale)
    ms = time_ms(call)
    alone = kernel_alone_ms(call, names=("base_pack_kernel",))
    log(f"  pack kernel @ {what}: bit for bit with pack_rows"
        f"{', cell_trunc and column_shift' if stale else ''}: {same}; "
        f"{ms:.4f} ms a call, the kernel alone {alone:.4f} device-ms")
    check(same, f"the pack kernel differs from the plain pack at {what}")
    return ms, alone


def check_sph_kernel(sph, dev):
    """The force kernel against its plain version and its lane emulation
    at both scenes, and its pack kernel; returns {"max_abs_err", "ms",
    "plain_ms"}, the times at the fill."""
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
        pack_ms, pack_alone = check_base_pack(sph, st, bt, sph.cfg, False,
                                              name)
        kernel_ms = kernel_alone_ms(lambda: kern(st, bt, sph.cfg, order))
        log(f"kernel base_forces_rowblock @ {name} ({st.capacity} "
            f"particles): max_abs_err {e:.3e} (relative {r:.3e}, tolerance "
            f"{tol:.0e}); ms per call: kernel {ms:.4f} (of which the row "
            f"pack {pack_ms:.4f}, its kernel alone {pack_alone:.4f}; the "
            f"force kernel alone {kernel_ms:.4f} device-ms), plain "
            f"{plain_ms:.4f}")
        if name == "fill":
            log(f"  before the lane schedule: the force kernel alone "
                f"{BASE_BEFORE_MS['base_forces_rowblock, fresh, fill']}, "
                f"the wrapper "
                f"{BASE_BEFORE_MS['base_forces_rowblock wrapper, fill']} "
                f"(its row pack {BASE_BEFORE_MS['row pack, fill']})")
        check(r <= tol, f"base_forces_rowblock disagrees with its plain "
                        f"version at {name} ({r:.3e} > {tol:.0e})")
        worst = max(worst, e)
        pairs = pair_count(sph, st, bt, sph.cfg)
        check_base_lanes(sph, got, st, bt, sph.cfg, None, False, pairs,
                         f"base_forces_rowblock at {name}")
        bound_ms, bound_by = bound(*sph_work(st, bt, order, BASE_IN, got[:2],
                                             pairs, BASE_PAIR_OPS))
        log(f"  {pairs} pairs within 2h: bound {bound_ms:.4f} ms "
            f"({bound_by})")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "kernel_ms": kernel_ms}


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


def unidyn_errors(got, want, n, what):
    """(worst column error over max|want|, max abs error, columns equal
    bit for bit, columns) over the unidyn output columns; a column of
    ``want`` that is 0 fails (it would check nothing)."""
    worst = err = 0.0
    same = cols = 0
    for k in UNIDYN_FIELDS:
        g = got[k].reshape(n, -1)
        w = want[k].reshape(n, -1)
        check(g.shape == w.shape, f"{what} {k}: shapes")
        for c in range(w.shape[1]):
            scale = float(w[:, c].abs().max())
            e = float((g[:, c] - w[:, c]).abs().max())
            check(scale > 0.0, f"{what} {k}[{c}] is 0: no check")
            worst, err = max(worst, e / scale), max(err, e)
            same += int(torch.equal(g[:, c], w[:, c]))
            cols += 1
    return worst, err, same, cols


def check_against_lanes(sph, got, st, bt, cfg, caps, what):
    """A unidyn wrapper's result ``got`` against forces.unidyn_lane_pass
    on the same inputs (the kernels' lane schedule emulated in torch):
    every column within UNIDYN_LANE_TOL of max|emulation|, pair counts
    and merge partners equal."""
    lanes = sph.sph_kernels.unidyn_info(torch.cuda.current_device())["lanes"]
    want = sph.forces.unidyn_lane_pass(st, bt, cfg, lanes,
                                       cfg.subbin_threshold, caps=caps)
    worst, err, same, cols = unidyn_errors(got, want, st.capacity, what)
    exact = (torch.equal(got["has_pair"], want["has_pair"])
             and torch.equal(got["merge_partner"], want["merge_partner"]))
    log(f"  {what} against the lane emulation ({lanes} lanes): max_abs_err "
        f"{err:.3e} (worst column relative {worst:.3e}, tolerance "
        f"{UNIDYN_LANE_TOL:.0e}), {same} of {cols} columns bit for bit; "
        f"pair counts and merge partners equal: {exact}")
    check(worst <= UNIDYN_LANE_TOL and exact,
          f"{what} disagrees with the lane emulation")


def pass_times(call):
    """(pass A, pass B) device-ms a call of ``call`` alone."""
    return (kernel_alone_ms(call, names=("unidyn_pass_a_kernel",)),
            kernel_alone_ms(call, names=("unidyn_pass_b_kernel",)))


def check_unidyn_build(sph, build_log):
    """The unidyn passes' builds (ptxas: registers, stack frame and spills
    of pass A and pass B, uncapped and capped; a stack frame or a spill
    fails) and their launch shape: lanes a home row, blocks x threads on
    the tank, blocks a multiprocessor keeps resident."""
    for what, key in UNIDYN_ENTRIES.items():
        info = ptxas_entry(build_log, key)
        log(f"unidyn {what}: {info['registers']} registers, stack frame, "
            f"spill stores, spill loads {info['stack_spill']} B")
        check(not any(info["stack_spill"]),
              f"unidyn {what}: stack frame or spill {info['stack_spill']}")
    shape = sph.sph_kernels.unidyn_info(torch.cuda.current_device())
    lanes, threads = shape["lanes"], shape["threads"]
    check(lanes == sph.sph_kernels.UNIDYN_LANES,
          f"the kernels take {lanes} lanes a row, sph_kernels.UNIDYN_LANES "
          f"is {sph.sph_kernels.UNIDYN_LANES}")
    for n in (14040, UNIDYN_FILL):
        log(f"unidyn passes at {n} rows: {lanes} lanes a home row, "
            f"{-(-n * lanes // threads)} blocks x {threads} threads; "
            f"resident blocks a multiprocessor: pass A "
            f"{shape['resident_a']}, pass B {shape['resident_b']}")


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
            worst, err, _, _ = unidyn_errors(got, want, st.capacity,
                                             f"{name} at {scene}")
            same = (torch.equal(got["has_pair"], want["has_pair"])
                    and torch.equal(got["merge_partner"],
                                    want["merge_partner"]))
            partners = int((got["merge_partner"] >= 0).sum())
            ms = time_ms(lambda: call(kern))
            plain_ms = time_ms(lambda: call(plain))
            kernel_ms = kernel_alone_ms(lambda: call(kern))
            a_ms, b_ms = pass_times(lambda: call(kern))
            log(f"kernel {name} @ {scene} ({st.capacity} particles, mixed "
                f"phases, merge_dist {merge}): max_abs_err {err:.3e} "
                f"(worst column relative {worst:.3e}, tolerance {tol:.0e}); "
                f"pair counts and merge partners equal: {same} "
                f"({partners} partners); ms per call: kernel {ms:.4f} (the "
                f"two force kernels alone {kernel_ms:.4f} device-ms: pass A "
                f"{a_ms:.4f}, pass B {b_ms:.4f}; before the lane schedule "
                f"{UNIDYN_BEFORE_MS[name]} at the tank), plain "
                f"{plain_ms:.4f}")
            check(worst <= tol, f"{name} disagrees with its plain version "
                                f"at {scene} ({worst:.3e} > {tol:.0e})")
            check(same, f"{name}: pair counts or merge partners differ")
            check((partners > 0) == (merge > 0), f"{name}: merge partners")
            check_against_lanes(sph, got, st, bt, cfg, None,
                                f"{name} at {scene}")
            if scene == "tank":
                pairs = pair_count(sph, st, bt, cfg, cfg.subbin_threshold)
                outs = [t for t in got.values() if isinstance(t, torch.Tensor)]
                bound_ms, bound_by = bound(*sph_work(
                    st, bt, order, UNIDYN_IN, outs, pairs, UNIDYN_PAIR_OPS))
                log(f"  {pairs} pairs within 2h: bound {bound_ms:.4f} ms "
                    f"({bound_by})")
                results[name] = {"max_abs_err": err, "ms": ms,
                                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                                 "bound_by": bound_by, "library_ms": None,
                                 "kernel_ms": kernel_ms, "pass_a_ms": a_ms,
                                 "pass_b_ms": b_ms}
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
    log_profile(f"unidyn tank ({n0} particles)",
                lambda steps: sph.step.run_python(st, cfg, steps), ms)

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


def window_slots(sph, st, bt, cfg, caps):
    """(slots of the stale window walk, slots of the whole columns)."""
    rows = sph.forces.pack_rows(st, bt.order, bt.in_dom)
    cz = sph.binning.cell_trunc(rows[:, 0:3], cfg)[:, 2]
    shift = sph.forces.column_shift(rows, bt, cfg)
    window = sph.binning.run_table(bt, cfg, caps, window=(cz, shift))[1]
    whole = sph.binning.run_table(bt, cfg, caps, whole=True)[1]
    return int(window.sum()), int(whole.sum()), int(shift.max())


def check_base_column(sph, dev):
    """base_forces_column against its plain version and its lane
    emulation, fresh and stale, at the 524288 fill (its suggest_col_cap)
    and at base_dam forced to cap 32; the row-block kernel's stale mode
    at base_dam and the fill.  Returns the column kernel's JSON entry
    (times and bound at the fill, fresh: the main path's call)."""
    col = sph.sph_kernels.base_forces_column
    col_plain = sph.sph_kernels.base_forces_column_plain
    tol = COLUMN_KERNELS["base_forces_column"][2]
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
            kernel_ms = kernel_alone_ms(lambda: call(col))
            pairs = pair_count(sph, pool, bt, cfg, caps=(b, w_cap),
                               stale=stale)
            bound_ms, bound_by = bound(*sph_work(pool, bt, bt.order, BASE_IN,
                                                 got[:2], pairs,
                                                 BASE_PAIR_OPS))
            mode = "xy_cells" if stale else "fresh"
            before = BASE_BEFORE_MS.get(
                f"base_forces_column, {'stale' if stale else 'fresh'}, "
                f"{scene}")
            log(f"kernel base_forces_column, {mode}, @ {scene} "
                f"({st.capacity} particles, pallas_col_cap "
                f"{cfg.pallas_col_cap}: b {b}, w_cap {w_cap}): max_abs_err "
                f"{e:.3e} (relative {r:.3e}, tolerance {tol:.0e}); overflow "
                f"{ovf} (plain {ovf_plain}), {capped.numel()} rows over the "
                f"cap, zero: {zeros}; ms per call: kernel {ms:.4f} (the "
                f"force kernel alone {kernel_ms:.4f} device-ms"
                f"{f'; before the lane schedule {before}' if before else ''}"
                f"), plain {plain_ms:.4f}; {pairs} pairs: bound "
                f"{bound_ms:.4f} ms ({bound_by})")
            check_base_lanes(sph, got, pool, bt, cfg, (b, w_cap), stale,
                             pairs, f"base_forces_column ({mode}) at {scene}")
            if stale:
                walked, whole, d = window_slots(sph, pool, bt, cfg,
                                                (b, w_cap))
                log(f"  stale window: {walked} slots walked, whole columns "
                    f"{whole} ({walked / whole:.4f}); largest column shift "
                    f"{d} cells")
                check(walked < whole, f"the stale window at {scene} walks "
                                      f"no fewer slots than whole columns")
                check_base_pack(sph, pool, bt, cfg, True, scene)
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
                         "library_ms": None, "kernel_ms": kernel_ms}
    entry["max_abs_err"] = worst

    row = sph.sph_kernels.base_forces_rowblock
    row_plain = sph.sph_kernels.base_forces_rowblock_plain
    tol = SPH_KERNELS["base_forces_rowblock"][2]
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
        kernel_ms = kernel_alone_ms(lambda: call(row))
        pairs = pair_count(sph, moved, bt, sph.cfg, stale=True)
        bound_ms, bound_by = bound(*sph_work(moved, bt, bt.order, BASE_IN,
                                             got[:2], pairs, BASE_PAIR_OPS))
        walked, whole, d = window_slots(sph, moved, bt, sph.cfg, None)
        log(f"kernel base_forces_rowblock, stale, @ {scene} ({st.capacity} "
            f"particles): max_abs_err {e:.3e} (relative {r:.3e}, tolerance "
            f"{tol:.0e}); ms per call: kernel {ms:.4f} (the force kernel "
            f"alone {kernel_ms:.4f} device-ms), plain {plain_ms:.4f}; "
            f"{pairs} pairs: bound {bound_ms:.4f} ms ({bound_by}); stale "
            f"window {walked} of the whole columns' {whole} slots, largest "
            f"column shift {d} cells")
        check(r <= tol, f"base_forces_rowblock (stale) disagrees with its "
                        f"plain version at {scene}")
        check_base_lanes(sph, got, moved, bt, sph.cfg, None, True, pairs,
                         f"base_forces_rowblock (stale) at {scene}")
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
        worst, err, _, _ = unidyn_errors(got, want, st.capacity,
                                         f"unidyn_forces_column at {scene}")
        same = (torch.equal(got["has_pair"], want["has_pair"])
                and torch.equal(got["merge_partner"], want["merge_partner"]))
        capped = capped_rows(sph, st, bt, cfg, cap)
        zeros = not any(bool(got[k][capped].any()) for k in UNIDYN_FIELDS)
        ovf = int(got["overflow"])
        ms = time_ms(lambda: call(kern))
        plain_ms = time_ms(lambda: call(plain), *PLAIN_REPS)
        kernel_ms = kernel_alone_ms(lambda: call(kern))
        a_ms, b_ms = pass_times(lambda: call(kern))
        log(f"kernel unidyn_forces_column @ {scene} ({st.capacity} "
            f"particles, mixed phases, cap {cap}, merge_dist {merge}): "
            f"max_abs_err {err:.3e} (worst column relative {worst:.3e}, "
            f"tolerance {tol:.0e}); pair counts and merge partners equal: "
            f"{same}; overflow {ovf} (plain {int(want['overflow'])}), "
            f"{capped.numel()} rows over the cap, zero: {zeros}; ms per "
            f"call: kernel {ms:.4f} (the two force kernels alone "
            f"{kernel_ms:.4f} device-ms: pass A {a_ms:.4f}, pass B "
            f"{b_ms:.4f}; before the lane schedule "
            f"{UNIDYN_BEFORE_MS['unidyn_forces_column']} at the tank), plain "
            f"{plain_ms:.4f}")
        check(worst <= tol and same, f"unidyn_forces_column disagrees with "
                                     f"its plain version at {scene}")
        check_against_lanes(sph, got, st, bt, cfg,
                            sph.config.column_caps(cfg),
                            f"unidyn_forces_column at {scene}")
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
                     "library_ms": None, "kernel_ms": kernel_ms,
                     "pass_a_ms": a_ms, "pass_b_ms": b_ms}
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


# ---------------------------------------------------------------------------
# the sharded grid step (BASELINE config 5) and its kernels


def seeded_grid(stam, cfg, device, seed):
    """The bench scene of config 3 (grid_state) with seeded velocities of
    up to half a cell a step, every field set_bnd-consistent: a slab
    rebuilds its x ghosts from the rule, as the reference's does."""
    s = grid_state(stam, "config 3, float32", cfg, device)
    rng = np.random.default_rng(seed)
    vmax = 0.5 / (cfg.dt * cfg.n)
    shape = (cfg.n + 2,) * 3

    def vel(b):
        a = rng.uniform(-vmax, vmax, shape).astype(np.float32)
        return stam.set_bnd3d(b, torch.from_numpy(a).to(device))

    return stam.GridState3D(vel(1), vel(2), vel(3),
                            stam.set_bnd3d(0, s.dens),
                            stam.set_bnd3d(0, s.temp))


def cut_rows(x, gx0, rows):
    """Rows gx0 .. gx0 + rows - 1 of the ghosted field x, zeros outside
    the grid: an x-slab placed at global row gx0."""
    out = x.new_zeros((rows,) + tuple(x.shape[1:]))
    lo, hi = max(gx0, 0), min(gx0 + rows, x.shape[0])
    out[lo - gx0:hi - gx0] = x[lo:hi]
    return out


def check_slab_modes(stam, kernels, dev):
    """The slab modes of the four stencil kernels against their plain
    versions, bit for bit, on the kernel step's padded slabs (2 pad rows
    a side, gx0 = rank c - 1) at 256^3: world 2's rank 0 (a face) and
    world 4's ranks 1 and 3 (inside, and at the far face).  Each slab's
    owned rows must also equal the dense kernels' rows."""
    rng = np.random.default_rng(SEED + 7)
    n = N_BIG
    cfg = grid_config(stam, "bench (DCT)", n)
    dt0 = cfg.dt * n

    def field(b, lo, hi):
        a = rng.uniform(lo, hi, (n + 2,) * 3).astype(np.float32)
        return stam.set_bnd3d(b, torch.from_numpy(a).to(dev))

    dense = [field(b, -1.2 / dt0, 1.2 / dt0) for b in (1, 2, 3)] + [
        field(0, 0.0, 1.0) for _ in range(3)]
    ref = {"advect3d_multi": kernels.advect3d_multi(dense[:3], (1, 2, 3),
                                                    *dense[:3], dt0)
           + kernels.advect3d_multi(dense[3:5], (0, 0), *dense[:3], dt0),
           "forcing3d": kernels.forcing3d(*dense[:5], cfg),
           "div3d": (kernels.div3d(*dense[:3]),),
           "gradsub3d": kernels.gradsub3d(dense[5], *dense[:3])}
    for c, rank in ((n // 2, 0), (n // 4, 1), (n // 4, 3)):
        gx0 = rank * c - 1
        u, v, w, d, t, p = (cut_rows(q, gx0, c + 4) for q in dense)
        calls = {"advect3d_multi": lambda k: k((u, v, w), (1, 2, 3), u, v, w,
                                               dt0, gx0=gx0)
                 + k((d, t), (0, 0), u, v, w, dt0, gx0=gx0),
                 "forcing3d": lambda k: k(u, v, w, d, t, cfg, gx0=gx0),
                 "div3d": lambda k: (k(u, v, w, gx0=gx0),),
                 "gradsub3d": lambda k: k(p, u, v, w, gx0=gx0)}
        for name, call in calls.items():
            got = call(getattr(kernels, name))
            want = call(getattr(kernels, name + "_plain"))
            same = all(torch.equal(g, w_) for g, w_ in zip(got, want))
            dense_rows = all(torch.equal(g[2:2 + c], r[gx0 + 2:gx0 + 2 + c])
                             for g, r in zip(got, ref[name]))
            log(f"slab mode of {name} @ {n}^3, rank {rank} of "
                f"{n // c} ({c + 4} rows at gx0 {gx0}): bitwise equal to "
                f"its plain version: {same}; owned rows equal the dense "
                f"kernel's: {dense_rows}")
            check(same and dense_rows, f"{name}: slab mode at gx0 {gx0}")


def check_rb_shard(stam, kernels, shard, dev):
    """lin_solve3d_rb_shard against its plain version, bit for bit: one
    pass on a face slab and on an inner slab (gx0 > 0) cut from a 47^3
    and a 48^3 grid, for fuse 1, 2 and 4, b 0 to 3, from a guess and
    from zeros, each also equal to the dense solve's rows; then the main
    path's call, config 5's pressure solve at 512^3 on a world of 1 (20
    iterations, fuse 4, five passes), timed against its plain version.
    Returns its row of the kernels line."""
    rng = np.random.default_rng(SEED + 9)
    checked = 0
    for n in (47, 48):
        for fuse in (1, 2, 4):
            halo, c_local = 2 * fuse, max(2 * fuse, 4)
            rows = c_local + 2 * halo
            for b in range(4):
                x = stam.set_bnd3d(b, torch.from_numpy(rng.uniform(
                    -1, 1, (n + 2,) * 3).astype(np.float32)).to(dev))
                x0 = torch.from_numpy(rng.uniform(
                    -1, 1, (n + 2,) * 3).astype(np.float32)).to(dev)
                for zero in (False, True):
                    guess = None if zero else x
                    dense = kernels.lin_solve3d_rb(b, guess, x0, 1.0, 6.0,
                                                   fuse)
                    for r0 in (0, n // 2):
                        gx0 = r0 + 1 - halo
                        args = (b, None if zero else cut_rows(x, gx0, rows),
                                cut_rows(x0, gx0, rows), 1.0, 6.0, fuse)
                        got = kernels.lin_solve3d_rb_shard(*args, gx0=gx0,
                                                           fuse=fuse)
                        want = kernels.lin_solve3d_rb_shard_plain(
                            *args, gx0=gx0, fuse=fuse)
                        check(torch.equal(got, want) and torch.equal(
                            got, dense[r0 + 1:r0 + 1 + c_local]),
                              f"lin_solve3d_rb_shard at n {n}, fuse {fuse}, "
                              f"b {b}, zero guess {zero}, gx0 {gx0}")
                        checked += 1
    log(f"lin_solve3d_rb_shard: {checked} single-pass slab calls (47^3 and "
        f"48^3, fuse 1/2/4, b 0-3, guess and zeros, face and inner slabs) "
        f"bitwise equal to the plain version and to the dense solve's rows")

    # the main path's call: the pressure solve of config 5 at 512^3, world 1
    n, iters = N_512, 20
    mesh = shard.make_mesh(device="cuda")
    fuse = kernels.rb_shard_plan(n, iters)
    halo = 2 * fuse
    rhs = torch.from_numpy(rng.uniform(0, 1, (n, n + 2, n + 2)).astype(
        np.float32)).to(dev)
    x0p = shard.grid_sharded._refresh_pad_(
        shard.grid_sharded._padded(rhs, halo), halo, 0, mesh)
    del rhs
    exchange = functools.partial(shard.grid_sharded._refresh_pad_,
                                 halo=halo, b=0, mesh=mesh)
    args = (0, None, x0p, 1.0, 6.0, iters)
    kw = dict(gx0=1 - halo, fuse=fuse, exchange=exchange)
    got = kernels.lin_solve3d_rb_shard(*args, **kw)
    want = kernels.lin_solve3d_rb_shard_plain(*args, **kw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"lin_solve3d_rb_shard at {n}^3 differs "
                                  f"from its plain version ({err:.3e})")
    ms = time_ms(lambda: kernels.lin_solve3d_rb_shard(*args, **kw))
    plain_ms = time_ms(lambda: kernels.lin_solve3d_rb_shard_plain(*args, **kw),
                       reps=PLAIN_REPS[0], warm=PLAIN_REPS[1])
    nbytes = x0p.nbytes + got.nbytes
    bound_ms, bound_by = bound(nbytes, 8 * iters * n ** 3)
    passes = [p for sp in range(iters // fuse)
              for p in kernels.rb_passes(2 * fuse, kernels.RB_TILE.k,
                                         first=sp == 0)]
    log(f"kernel lin_solve3d_rb_shard timed @ {n}^3 (world 1, {x0p.shape[0]} "
        f"padded rows, {iters} iterations, fuse {fuse}: {iters // fuse} "
        f"slab passes of {2 * fuse} half-sweeps, {len(passes)} blocked "
        f"launches): max_abs_err {err:.3e} (bitwise); ms per call: kernel "
        f"{ms:.4f}, plain {plain_ms:.4f}; bound {bound_ms:.4f} ms "
        f"({bound_by}: {nbytes} B, {8 * iters * n ** 3} operations)")
    # the finish pass reads the owned rows and writes them with ghosts
    chunks = kernels._rb_chunks_on(x0p, 1 - halo)
    log_blocked_floors("lin_solve3d_rb_shard", x0p, kernels.RB_TILE, chunks,
                       kernels.RB_TILE.k,
                       [(p.half_sweeps, not p.first) for p in passes],
                       (chunks.r_hi - chunks.r_lo + 1) * n * n,
                       2 * got.nbytes, 2 * iters, bound_ms)
    del got, want, x0p
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def sharded_launches(cfg, steps):
    """Launches of ``steps`` kernel steps of config 3's configuration:
    per step a forcing, two projections (div, the sharded solve, gradsub)
    and two advections."""
    want = dict.fromkeys(KERNELS, 0)
    want.update({"forcing3d": steps, "div3d": 2 * steps,
                 "gradsub3d": 2 * steps, "advect3d_multi": 2 * steps})
    if cfg.projection == "jacobi":
        want["lin_solve3d_rb_shard"] = 2 * steps
    return want


def run_config5(stam, kernels, shard, dev, unsharded_ms):
    """BASELINE config 5 on one card, a world of 1: config 3's
    configuration at 512^3 through shard.make_sharded_step.  Two steps
    must equal two dense steps (stam.run3d_python) bit for bit; then the
    warm-up and the timed steps of the bench scene, the launch counts
    reset before and read after; then a profile window.  Returns (counts,
    ms/step)."""
    warm, timed = CONFIG5_STEPS
    cfg = grid_config(stam, "config 3, float32")
    mesh = shard.make_mesh(device="cuda")
    state = seeded_grid(stam, cfg, dev, SEED + 11)
    out, res = shard.make_sharded_step(mesh, cfg, 2)(
        shard.shard_state(shard.to_sharded_layout(state), mesh))
    ref, ref_res = stam.run3d_python(state, cfg, 2)
    out = shard.from_sharded_layout(out)
    same = all(torch.equal(getattr(out, f), getattr(ref, f)) for f in FIELDS)
    log(f"config 5 @ {cfg.n}^3, world 1, two steps: bitwise equal to two "
        f"dense steps: {same}; residual {float(res):.6e}, dense "
        f"{float(ref_res[0]):.6e}")
    check(same and float(res) == float(ref_res[0]),
          "config 5 at world 1 differs from the dense step")
    del state, out, ref

    step = shard.make_sharded_step(mesh, cfg, timed)
    check(step.backend == "kernels", "config 5 did not take the kernels")
    state = shard.shard_state(shard.to_sharded_layout(
        grid_state(stam, "config 3, float32", cfg, dev)), mesh)
    state, _ = shard.make_sharded_step(mesh, cfg, warm)(state)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, res = step(state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    ms = seconds / timed * 1e3
    finite = all(bool(torch.isfinite(getattr(state, f)).all())
                 for f in FIELDS)
    log(f"config 5 @ {cfg.n}^3 (world 1, fuse {step.fuse}), {timed} timed "
        f"steps after {warm} warm-up: {ms:.4f} ms/step, "
        f"{cfg.n ** 3 / (ms / 1e3):.4e} cell-updates/s, final residual "
        f"{float(res):.6e}, finite {finite}; the unsharded config 3 in this "
        f"run: {unsharded_ms:.4f} ms/step (ratio {ms / unsharded_ms:.4f})")
    log(f"launches: {counts}")
    check(finite and 0.0 < float(res) < 1e-2, "config 5: fields not finite "
                                              "or no residual")
    check(counts == sharded_launches(cfg, timed),
          f"config 5: launches {counts}")
    # one call of k steps, as the timed run: each call pads and unpads
    log_profile("config 5, world 1",
                lambda k: shard.make_sharded_step(mesh, cfg, k)(state), ms)
    return counts, ms


def shard_rank(legs):
    """A rank of a world that shares the card over gloo: each leg (name,
    n, configuration keywords, scene) runs warm-up and timed sharded kernel
    steps; rank 0 collects them and holds them against as many dense
    steps (stam.run3d_python) on the same card: bit for bit with the
    Jacobi projection, within DCT_SHARD_TOL of max|field| with the DCT
    projection (its x transform is summed over the ranks), whose final
    residual must stay at or below MAX_RESIDUAL."""
    import torch.distributed as dist

    from tpufluids_torch import shard
    from tpufluids_torch.grid import kernels, stam
    mesh = shard.make_mesh(device="cuda")
    warm, timed = SHARD_STEPS
    for name, n, kw, scene in legs:
        cfg = stam.StamConfig(n=n, dt=0.5 / n, **kw)
        dense = (seeded_grid(stam, cfg, mesh.device, SEED + n)
                 if scene == "seeded" else
                 grid_state(stam, "bench (DCT)", cfg, mesh.device))
        state = shard.shard_state(shard.to_sharded_layout(dense), mesh)
        state, _ = shard.make_sharded_step(mesh, cfg, warm)(state)
        step = shard.make_sharded_step(mesh, cfg, timed)
        torch.cuda.synchronize()
        dist.barrier()
        staged = mesh.staged_bytes
        kernels.reset_launches()
        t0 = time.perf_counter()
        state, res = step(state)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        staged = mesh.staged_bytes - staged
        counts = kernels.launch_counts()
        check(counts == sharded_launches(cfg, timed),
              f"{name}: rank {mesh.rank} launches {counts}")
        full = shard.collect(state, mesh)
        if mesh.rank:
            continue
        ref, ref_res = stam.run3d_python(dense, cfg, warm + timed)
        full = shard.from_sharded_layout(full)
        e, r = rel_err([getattr(full, f) for f in FIELDS],
                       [getattr(ref, f) for f in FIELDS])
        res, ref_res = float(res), float(ref_res[0])
        log(f"{name} @ {n}^3 ({scene} scene), world {mesh.size} on one "
            f"shared card (gloo, "
            f"host-staged halos; a correctness run, not scaling): "
            f"{seconds / timed * 1e3:.4f} ms/step over {timed} steps after "
            f"{warm}, {staged / timed:.0f} staged bytes a step on rank 0, "
            f"fuse {step.fuse}; against {warm + timed} dense steps: "
            f"max_abs_err {e:.3e} (relative {r:.3e}); residual {res:.6e}, "
            f"dense {ref_res:.6e}")
        if cfg.projection == "jacobi":
            check(e == 0.0 and res == ref_res,
                  f"{name}: the collected step differs from the dense step")
        else:
            check(r <= DCT_SHARD_TOL and res <= MAX_RESIDUAL,
                  f"{name}: the collected DCT step is off the dense step "
                  f"({r:.3e}) or its residual {res:.3e} > {MAX_RESIDUAL}")


def run_shared_card_worlds(shard):
    """Worlds 2 and 4 as processes on the one card over gloo."""
    for world, legs in SHARD_WORLDS.items():
        t0 = time.perf_counter()
        shard.spawn(world, shard_rank, legs, backend="gloo")
        log(f"world {world}: {time.perf_counter() - t0:.1f} s in all, "
            f"process start-up included")


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
                                 scenes, shard, sph_kernels, state, step)
    from tpufluids_torch.config import BASE_CONFIG, UNIDYN_CONFIG
    from tpufluids_torch.grid import kernels, mac, stam

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
    check_step_whole(stam, kernels, dev, build.log, checked)
    check_step2d_whole(stam, kernels, dev, build.log, checked)
    check_blocked(stam, kernels, dev, build.log)
    check_small_against_cpu(stam, dev)
    counts, ms = {}, {}
    for path in GRID_PATHS:
        c, ms[path] = run_grid_path(stam, kernels, dev, path)
        add_counts(counts, c)
    log(f"config 3 @ {N_512}^3: the bf16 solver's ms/step over float32's "
        f"in this run: {ms['config 3, bf16 solver']:.4f} / "
        f"{ms['config 3, float32']:.4f} = "
        f"{ms['config 3, bf16 solver'] / ms['config 3, float32']:.4f}")
    mac_res = {}
    for path in MAC_PATHS:
        c, ms[path], mac_res[path] = run_mac_path(stam, mac, kernels, dev,
                                                  path)
        add_counts(counts, c)
    # two V-cycles a projection against twenty Jacobi sweeps
    check(mac_res["plume3d --mac, multigrid"] < mac_res["plume3d --mac"],
          f"MAC: multigrid leaves more divergence than Jacobi: {mac_res}")
    for path in GRID2D_PATHS:
        for name, c in run_grid2d_path(stam, kernels, dev, path).items():
            counts[name] = counts.get(name, 0) + c


    check_base_build(sph, build.log)
    checked["base_forces_rowblock"] = check_sph_kernel(sph, dev)
    check_sph_against_cpu(sph, dev)
    check_sph_determinism(sph, dev)
    counts.update(run_sph_main_path(sph, dev))

    check_unidyn_build(sph, build.log)
    checked.update(check_unidyn_kernels(sph, dev))
    check_unidyn_against_cpu(sph, dev)
    counts.update(run_unidyn_main_path(sph, dev))

    checked["base_forces_column"] = check_base_column(sph, dev)
    checked["unidyn_forces_column"] = check_unidyn_column(sph, dev,
                                                          build.log)
    check_column_identities(sph, dev)
    fill_speeds(sph, dev)
    for path in COLUMN_PATHS:
        add_counts(counts, run_column_path(sph, dev, path))

    checked["lin_solve3d_rb_shard"] = check_rb_shard(stam, kernels, shard,
                                                     dev)
    check_slab_modes(stam, kernels, dev)
    c, ms["config 5, world 1"] = run_config5(stam, kernels, shard, dev,
                                             ms["config 3, float32"])
    add_counts(counts, c)
    run_shared_card_worlds(shard)

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
