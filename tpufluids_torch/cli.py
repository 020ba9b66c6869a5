"""Command-line runner: ``tpufluids.cli`` for the port.

The same six scenes with the same flags, defaults and summary line as
the JAX package's CLI; everything runs on the card unless ``--cpu`` is
given, and on a machine without a card a run without ``--cpu`` raises::

    python -m tpufluids_torch.cli base_dam --steps 4000 --out anim/
    python -m tpufluids_torch.cli unidyn_tank --steps 1450 --snapshot-every 20
    python -m tpufluids_torch.cli smoke2d --steps 200 --out frames/
    python -m tpufluids_torch.cli plume3d --size 64 --steps 100
    python -m tpufluids_torch.cli grid3d --size 256 --steps 10 --red-black
    python -m tpufluids_torch.cli grid3d_sharded --size 64 --devices 4

The last line on stdout is one JSON summary: ``steps_per_sec`` and
``particle_updates_per_sec`` (SPH) or ``cell_updates_per_sec`` and the
final ``poisson_residual`` (grid), with ``wall_s`` on the host clock,
ending in ``torch.cuda.synchronize()`` on the card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import tempfile
import time

import torch

from tpufluids_torch import binning, diagnostics, scenes, shard, step
from tpufluids_torch.config import BASE_CONFIG, UNIDYN_CONFIG
from tpufluids_torch.grid import mac, stam
from tpufluids_torch.io import checkpoint, vtk
from tpufluids_torch.io.snapshots import SnapshotWriter

SPH_SCENES = ("base_dam", "unidyn_tank")
GRID_SCENES = ("smoke2d", "plume3d", "grid3d", "grid3d_sharded")
# grid3d_sharded's --backend, named as the JAX CLI names them, ->
# shard.grid_sharded's backends
SHARD_BACKENDS = {"auto": "auto", "xla": "plain", "pallas": "kernels"}


def _add_common(p):
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--out", type=str, default=None,
                   help="VTK output directory (omit to skip snapshots)")
    p.add_argument("--snapshot-every", type=int, default=20)
    p.add_argument("--binary", action="store_true",
                   help="binary (big-endian) VTK instead of ASCII")
    p.add_argument("--metrics", type=str, default=None,
                   help="JSONL metrics path")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")


def build_parser():
    ap = argparse.ArgumentParser(prog="tpufluids_torch")
    sub = ap.add_subparsers(dest="scene", required=True)
    for name in SPH_SCENES:
        p = sub.add_parser(name)
        _add_common(p)
        p.add_argument("--particles", type=int, default=None)
        if name == "base_dam":
            p.add_argument("--boundary-particles", type=int, default=0,
                           help="boundary lattice plane at z=-0.24 "
                                "(solver.cu:122-128; the driver ships "
                                "nbpts=000)")
        p.add_argument("--subbin-parity",
                       action=argparse.BooleanOptionalAction, default=None,
                       help="reference two-level-binning stencil semantics "
                            "(default: on for unidyn, off for base — the "
                            "reference's active behavior)")
        p.add_argument("--split-reinjection", action="store_true")
        if name == "base_dam":
            p.add_argument("--sort-every", type=int, default=1,
                           help="spatial-sort cadence: 1 = every step "
                                "(the reference's thrust cadence, "
                                "solver.cu:181); K > 1 amortizes the "
                                "sort over K steps (base variant on the "
                                "force kernels; SPHConfig.sort_every)")
    for name in GRID_SCENES:
        p = sub.add_parser(name)
        _add_common(p)
        p.add_argument("--size", type=int, default=None)
        p.add_argument("--jacobi-iters", type=int, default=20)
        p.add_argument("--red-black", action="store_true")
        # grid3d_sharded has no sharded multigrid (make_sharded_step
        # raises); restrict its choices so argparse reports it upfront
        p.add_argument("--projection", default="jacobi",
                       choices=(("jacobi", "dct")
                                if name == "grid3d_sharded" else
                                ("jacobi", "multigrid", "dct")),
                       help="Poisson solver: 'dct' (exact spectral "
                            "solve, the most accurate), 'jacobi' "
                            "(fixed-iteration sweeps, red-black with "
                            "--red-black, the reference-style scheme), "
                            "'multigrid' (V-cycles, kept for solver "
                            "validation)")
        p.add_argument("--vorticity", type=float, default=0.0)
        if name in ("plume3d", "grid3d"):
            p.add_argument("--mac", action="store_true",
                           help="staggered (MAC) grid: exact face-"
                                "difference divergence driven to solver"
                                " tolerance (tpufluids_torch.grid.mac)")
        if name == "grid3d_sharded":
            p.add_argument("--devices", type=int, default=None,
                           help="ranks of the x-slab mesh (default 1, "
                                "in this process)")
            p.add_argument("--backend", default="auto",
                           choices=tuple(SHARD_BACKENDS),
                           help="per-slab step: pallas = the kernel step "
                                "(needs red-black jacobi or dct + "
                                "stencil advection), xla = the plain "
                                "step, auto = the kernels on the card "
                                "where supported")
            p.add_argument("--advect-mode", default="gather",
                           choices=("gather", "stencil"))
    return ap


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _emit(summary: dict) -> dict:
    print(json.dumps(summary), flush=True)
    return summary


def run_sph(args, device):
    if args.scene == "base_dam":
        cfg = BASE_CONFIG
        state = scenes.base_dam(cfg, n=args.particles or 8000,
                                nb=args.boundary_particles, device=device)
        varnames = ("dens", "cellnumber")   # solver.cu:108
        if (args.particles and args.particles != 8000
                and step.resolve_kernel_family(cfg, state.capacity)
                == "column"):
            # the preset pallas_col_cap is tuned to the default
            # 8000-particle dam; a larger dam packs taller (x, y)
            # columns, which would overflow the column kernel family
            # (dropped force pairs, surfaced only via bin_overflow):
            # derive the cap from the actual initial occupancy instead.
            # The row-block family has no cap.
            cfg = cfg.replace(
                pallas_col_cap=binning.suggest_col_cap(state, cfg))
        if args.sort_every > 1:
            cfg = cfg.replace(sort_every=args.sort_every)
    else:
        cfg = UNIDYN_CONFIG
        if args.split_reinjection:
            cfg = cfg.replace(split_reinjection=True)
        state = scenes.unidyn_tank(cfg, device=device)
        varnames = ("mass", "surface_level")  # solver-unidyn.cu:118

    if args.resume:
        state, meta = checkpoint.load(args.resume, device=device)
        print(f"resumed from step {meta['step']}", file=sys.stderr)

    snap = None
    if args.out:
        snap = SnapshotWriter(args.out, prefix=f"{args.scene}_",
                              varnames=varnames, use_binary=args.binary,
                              cfg=cfg)
    log = diagnostics.MetricsLogger(args.metrics) if args.metrics else None

    def cb(i, host_state):
        if snap is not None:
            snap(i, host_state)
        if (args.checkpoint and args.checkpoint_every
                and i % args.checkpoint_every == 0):
            checkpoint.save(args.checkpoint, host_state, cfg, step=i)

    t0 = time.perf_counter()
    state, metrics = step.run(state, cfg, args.steps,
                              snapshot_every=args.snapshot_every
                              if (snap or args.checkpoint_every) else 0,
                              snapshot_fn=cb,
                              subbin_parity=args.subbin_parity)
    _sync(device)
    dt = time.perf_counter() - t0
    if snap:
        snap.close()
    if log:
        log.log(args.steps, metrics, wall_s=dt)
        log.close()
    diagnostics.check_state(state, cfg)
    if args.checkpoint:
        checkpoint.save(args.checkpoint, state, cfg, step=args.steps)
    n = int(state.num_alive())
    return _emit({
        "scene": args.scene, "steps": args.steps, "wall_s": dt,
        "steps_per_sec": args.steps / dt, "particles": n,
        "particle_updates_per_sec": n * args.steps / dt,
        "max_speed": float(metrics.max_speed[-1]),
        "bin_overflow": int(metrics.bin_overflow.max()),
    })


def sharded_rank(cfg, steps, backend, device, out_path=None):
    """One rank of grid3d_sharded: the zero state of ``cfg`` cut into this
    rank's x-slab, ``steps`` sharded steps; returns {"poisson_residual"
    (the maximum over the ranks), "wall_s", "backend" (the step's)},
    which rank 0 also writes to ``out_path`` as JSON.  Module level, so
    that ``shard.spawn`` can import it by name."""
    t0 = time.perf_counter()
    mesh = shard.make_mesh(device=device)
    state = shard.shard_state(shard.to_sharded_layout(
        stam.make_grid3d(cfg, device=mesh.device)), mesh)
    step_fn = shard.make_sharded_step(mesh, cfg, n_steps=steps,
                                      backend=backend)
    state, res = step_fn(state)
    res = float(res)
    _sync(mesh.device)
    result = {"poisson_residual": res, "wall_s": time.perf_counter() - t0,
              "backend": step_fn.backend}
    if out_path is not None and mesh.rank == 0:
        with open(out_path, "w") as f:
            json.dump(result, f)
    return result


def _run_sharded(args, cfg, device):
    """grid3d_sharded: a world of 1 in this process, or ``--devices`` N
    ranks through ``shard.spawn`` (nccl with a card a rank, else gloo,
    which shares the card); (residual, rank 0's wall seconds)."""
    backend = SHARD_BACKENDS[args.backend]
    world = args.devices or 1
    if world == 1:
        result = sharded_rank(cfg, args.steps, backend, device)
    else:
        cards = torch.cuda.device_count() if device == "cuda" else 0
        dist_backend = "nccl" if device == "cuda" and world <= cards \
            else "gloo"
        # by its module's name, so that spawned ranks can import it when
        # this module runs as __main__
        rank_fn = importlib.import_module("tpufluids_torch.cli").sharded_rank
        with tempfile.TemporaryDirectory(prefix="tpufluids_cli_") as tmp:
            out = os.path.join(tmp, "rank0.json")
            shard.spawn(world, rank_fn, cfg, args.steps, backend, device,
                        out, backend=dist_backend)
            with open(out) as f:
                result = json.load(f)
    return result["poisson_residual"], result["wall_s"]


def run_grid(args, device):
    n = args.size or (128 if args.scene == "smoke2d" else 64)
    cfg = stam.StamConfig(
        n=n, dt=0.1 if args.scene == "smoke2d" else 0.05,
        diff=1e-5, visc=1e-5, jacobi_iters=args.jacobi_iters,
        red_black=args.red_black, projection=args.projection,
        vorticity_eps=args.vorticity,
        buoyancy_alpha=0.05 if args.scene == "plume3d" else 0.0,
        buoyancy_beta=1.0 if args.scene == "plume3d" else 0.0)
    use_mac = getattr(args, "mac", False)

    t0 = time.perf_counter()
    dt = None
    if args.scene == "smoke2d":
        s = stam.make_grid2d(cfg, device=device)
        src = torch.zeros((n + 2, n + 2), dtype=torch.float32,
                          device=device)
        src[n // 2 - 4:n // 2 + 4, 4:8] = 5.0
        fv = torch.zeros_like(src)
        fv[n // 2 - 4:n // 2 + 4, 4:8] = 2.0
        frame = [0]

        def snap(i, host_state):
            vtk.write_regular_mesh(
                f"{args.out}/smoke_{frame[0]}", int(args.binary),
                [n + 2, n + 2, 1], 1, [1], [1], ["dens"],
                [host_state.dens.reshape(-1)])
            frame[0] += 1

        stam.run2d_python(
            s, cfg, args.steps, sources={"dens": src, "fv": fv},
            snapshot_every=args.snapshot_every if args.out else 0,
            snapshot_fn=snap if args.out else None)
        res = float("nan")
    elif args.scene == "grid3d_sharded":
        res, dt = _run_sharded(
            args, cfg.replace(advect_mode=args.advect_mode), device)
    elif use_mac:
        s = mac.make_mac3d(cfg, device=device)
        k = max(n // 8, 1)
        s.dens[3 * k:5 * k, 3 * k:5 * k, 0:k] = 1.0
        s.temp[3 * k:5 * k, 3 * k:5 * k, 0:k] = 3.0
        s, residuals = mac.run3d_python(s, cfg, args.steps)
        res = float(residuals[-1])
        if args.out:
            vtk.write_regular_mesh(
                f"{args.out}/{args.scene}_mac_final", int(args.binary),
                [n, n, n], 1, [1], [1], ["dens"], [s.dens.reshape(-1)])
    else:
        s = stam.make_grid3d(cfg, device=device)
        k = max(n // 8, 1)
        s.dens[3 * k:5 * k, 3 * k:5 * k, 1:k + 1] = 1.0
        s.temp[3 * k:5 * k, 3 * k:5 * k, 1:k + 1] = 3.0
        s, residuals = stam.run3d_python(s, cfg, args.steps)
        res = float(residuals[-1])
        if args.out:
            vtk.write_regular_mesh(
                f"{args.out}/{args.scene}_final", int(args.binary),
                [n + 2, n + 2, n + 2], 1, [1], [1], ["dens"],
                [s.dens.reshape(-1)])
    _sync(device)
    if dt is None:
        dt = time.perf_counter() - t0
    cells = n ** 2 if args.scene == "smoke2d" else n ** 3
    return _emit({
        "scene": args.scene, "steps": args.steps, "wall_s": dt,
        "steps_per_sec": args.steps / dt,
        "cell_updates_per_sec": cells * args.steps / dt,
        "poisson_residual": res,
        # the --mac residual is max |div(u)| after projection (exact
        # face-difference divergence), NOT the collocated Poisson-system
        # residual of the other scenes: incomparable scales
        "residual_kind": ("mac_max_divergence" if use_mac
                          else "poisson_system"),
    })


def main(argv=None):
    """Run one scene; prints its summary as the last stdout line and
    returns it."""
    args = build_parser().parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    if args.scene in SPH_SCENES:
        return run_sph(args, device)
    return run_grid(args, device)


if __name__ == "__main__":
    main()
