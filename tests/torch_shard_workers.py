"""Rank functions of the sharded-step tests.  ``tpufluids_torch.shard.spawn``
runs them in fresh processes, which import torch and the port only
(neither JAX nor a test module); each reads its inputs from an npz file
the test wrote and leaves its results in npz files beside it, rank 0's
holding the collected global fields."""

from __future__ import annotations

import numpy as np
import torch


def _mesh():
    torch.set_num_threads(1)
    from tpufluids_torch.shard import make_mesh
    return make_mesh(device="cpu")


def mesh_checks(out_dir):
    """The collectives, then the halo refreshes."""
    mesh = _mesh()
    _collectives(out_dir, mesh)
    _refresh_multi(out_dir, mesh)


def _collectives(out_dir, mesh):
    """Each collective on a known tensor: rank r holds arange(4 world) +
    100 r."""
    t = torch.arange(4 * mesh.size, dtype=torch.float32) + 100 * mesh.rank
    gathered = mesh.gather(t)
    np.savez(f"{out_dir}/collectives_{mesh.rank}.npz",
             right=mesh.shift(t, +1).numpy(), left=mesh.shift(t, -1).numpy(),
             scattered=mesh.reduce_scatter(t).numpy(),
             max=mesh.max(t.sum()).numpy(),
             gathered=(np.stack([g.numpy() for g in gathered])
                       if gathered is not None else np.zeros(0)))


def _refresh_multi(out_dir, mesh):
    """The batched halo refresh against per-field refreshes, on five
    seeded (c + 4, 10, 12) fields, different on each rank."""
    from tpufluids_torch.shard import grid_sharded as gs
    rng = np.random.default_rng(mesh.rank)
    qs = [torch.from_numpy(rng.normal(0, 1, (12, 10, 12)).astype(np.float32))
          for _ in range(5)]
    multi = gs._refresh_halo_multi([q.clone() for q in qs], gs.BNDS, mesh)
    per = [gs._refresh_halo(q.clone(), b, mesh) for q, b in zip(qs, gs.BNDS)]
    np.savez(f"{out_dir}/refresh_{mesh.rank}.npz",
             **{f"multi{i}": q.numpy() for i, q in enumerate(multi)},
             **{f"per{i}": q.numpy() for i, q in enumerate(per)},
             **{f"in{i}": q.numpy() for i, q in enumerate(qs)})


def rb_solves(out_dir, inputs, cases):
    """The sharded red-black solve (its plain version, through
    grid_sharded's halo exchange) of each case (name, b, x key or None,
    x0 key, a, c, iters) on this rank's slabs; rank 0 saves the
    collected (n, n+2, n+2) results."""
    mesh = _mesh()
    from tpufluids_torch.grid import kernels
    from tpufluids_torch.shard import grid_sharded as gs
    data = np.load(inputs)
    out = {}
    for name, b, xkey, x0key, a, c, iters in cases:
        def slab(key):
            full = torch.from_numpy(data[key])[1:-1]
            rows = full.shape[0] // mesh.size
            return full[mesh.rank * rows:(mesh.rank + 1) * rows].contiguous()

        x0 = slab(x0key)
        fuse = kernels.rb_shard_plan(x0.shape[0], iters)
        got = gs._rb_solve(b, None if xkey is None else slab(xkey), x0, a, c,
                           iters, mesh, fuse)
        parts = mesh.gather(got)
        if parts is not None:
            out[name] = torch.cat(parts).numpy()
    if mesh.rank == 0:
        np.savez(f"{out_dir}/rb.npz", **out)


def steps(out_dir, inputs, cases):
    """make_sharded_step for each case (name, configuration keywords,
    backend, steps) from the dense fields in ``inputs``; rank 0 saves
    the collected fields with x ghosts and the residual."""
    mesh = _mesh()
    from tpufluids_torch.grid import convert, stam
    from tpufluids_torch.shard import grid_sharded as gs
    data = dict(np.load(inputs))
    out = {}
    for name, kw, backend, n_steps in cases:
        cfg = stam.StamConfig(**kw)
        state = convert.slab_state_from_numpy(data, mesh.rank, mesh.size,
                                              device="cpu")
        step = gs.make_sharded_step(mesh, cfg, n_steps, backend)
        state, res = step(state)
        full = gs.collect(state, mesh)
        if full is not None:
            full = gs.from_sharded_layout(full)
            for f in gs.FIELDS:
                out[f"{name}/{f}"] = getattr(full, f).numpy()
            out[f"{name}/res"] = res.numpy()
            out[f"{name}/backend"] = np.array(step.backend)
    if mesh.rank == 0:
        np.savez(f"{out_dir}/steps.npz", **out)


def particle_steps(out_dir, inputs, cases):
    """The sharded SPH step (tpufluids_torch.shard.particles) of each case
    (name, SPHConfig, scene, steps, capacity a rank, keywords of
    make_sharded_step) on this rank's pool of the dense scene in
    ``inputs`` (its fields under "<scene>/<field>"); rank 0 saves the
    collected pools and the metrics under "<name>/..."."""
    mesh = _mesh()
    from tpufluids_torch import convert
    from tpufluids_torch.shard import particles
    data = np.load(inputs)
    out = {}
    for name, cfg, scene, n_steps, cap, kw in cases:
        dense = convert.state_from_numpy(
            {k.split("/", 1)[1]: data[k] for k in data.files
             if k.startswith(scene + "/")}, device="cpu")
        local = particles.distribute(dense, mesh, cfg, cap)
        local, m = particles.make_sharded_step(mesh, cfg, n_steps=n_steps,
                                               **kw)(local)
        full = particles.collect(local, mesh)
        if full is not None:
            out.update({f"{name}/{k}": v for k, v in
                        convert.state_to_numpy(full).items()})
            out.update({f"{name}/m_{k}": v.numpy()
                        for k, v in m._asdict().items()})
    if mesh.rank == 0:
        np.savez(f"{out_dir}/particles.npz", **out)
