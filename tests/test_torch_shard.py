"""The port's mesh and slab layout (tpufluids_torch.shard) on the CPU:
the collectives over gloo at worlds 2 and 4, the layout round trip
against the JAX package's to_sharded_layout / from_sharded_layout, and
the batched halo refresh bit-equal to per-field refreshes.

Worlds above 1 run in processes that ``spawn`` starts, once per world
size in this module (tests/torch_shard_workers.py); their results come
back through npz files in a temporary directory."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_shard_workers as workers

from tpufluids.grid import stam as jstam
from tpufluids.shard import grid_sharded as jgs
from tpufluids_torch.grid import convert
from tpufluids_torch.shard import (Mesh, collect, from_sharded_layout,
                                   grid_sharded, make_mesh, shard_state,
                                   spawn, to_sharded_layout)

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """world -> the directory holding that world's results."""
    out = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"world{world}")
        spawn(world, workers.mesh_checks, str(d), backend="gloo")
        out[world] = d
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_over_gloo(runs, world):
    base = np.arange(4 * world, dtype=np.float32)
    total = world * base + 100 * sum(range(world))
    for rank in range(world):
        got = np.load(runs[world] / f"collectives_{rank}.npz")
        np.testing.assert_array_equal(got["right"],
                                      base + 100 * ((rank - 1) % world))
        np.testing.assert_array_equal(got["left"],
                                      base + 100 * ((rank + 1) % world))
        np.testing.assert_array_equal(got["scattered"],
                                      total[4 * rank:4 * rank + 4])
        assert float(got["max"]) == float((base + 100 * (world - 1)).sum())
        if rank == 0:
            np.testing.assert_array_equal(
                got["gathered"], np.stack([base + 100 * r
                                           for r in range(world)]))


def test_world_of_one_needs_no_group_and_its_collectives_are_identities():
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, None)
    t = torch.arange(6.0)
    for got in (mesh.shift(t, 1), mesh.shift(t, -1), mesh.reduce_scatter(t),
                mesh.max(t)):
        assert torch.equal(got, t)
    assert torch.equal(mesh.gather(t)[0], t) and mesh.staged_bytes == 0


def test_make_mesh_rejects_a_world_without_a_group():
    with pytest.raises(ValueError, match="world of 2"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        make_mesh(device="meta")


def _seeded(n, seed):
    rng = np.random.default_rng(seed)
    return {f: np.asarray(jstam.set_bnd3d(b, jnp.asarray(
        rng.normal(0, 1, (n + 2,) * 3).astype(np.float32))))
        for f, b in zip(grid_sharded.FIELDS, grid_sharded.BNDS)}


def test_layout_round_trip_matches_jax():
    n = 8
    fields = _seeded(n, 3)
    jstate = jstam.GridState3D(**{f: jnp.asarray(a)
                                  for f, a in fields.items()})
    tstate = convert.state_from_numpy(fields, device="cpu")
    jsh, tsh = jgs.to_sharded_layout(jstate), to_sharded_layout(tstate)
    back = from_sharded_layout(tsh)
    jback = jgs.from_sharded_layout(jsh, jstam.StamConfig(n=n))
    for f in grid_sharded.FIELDS:
        np.testing.assert_array_equal(getattr(tsh, f).numpy(),
                                      np.asarray(getattr(jsh, f)))
        np.testing.assert_array_equal(getattr(back, f).numpy(),
                                      np.asarray(getattr(jback, f)))
        np.testing.assert_array_equal(getattr(back, f).numpy(), fields[f])


@pytest.mark.parametrize("world", [1, 2, 4])
def test_slabs_of_numpy_fields_tile_the_sharded_layout(world):
    n = 8
    fields = _seeded(n, 4)
    sharded = to_sharded_layout(convert.state_from_numpy(fields,
                                                         device="cpu"))
    for rank in range(world):
        slab = convert.slab_state_from_numpy(fields, rank, world,
                                             device="cpu")
        mesh = Mesh(rank=rank, size=world, group=None,
                    device=torch.device("cpu"))
        cut = shard_state(sharded, mesh)
        for f in grid_sharded.FIELDS:
            assert torch.equal(getattr(slab, f), getattr(cut, f))
    whole = convert.slab_state_from_numpy(fields, 0, 1, device="cpu")
    assert torch.equal(collect(whole, make_mesh(device="cpu")).u,
                       sharded.u)
    with pytest.raises(ValueError):
        convert.slab_state_from_numpy(fields, 0, 3, device="cpu")


@pytest.mark.parametrize("world", WORLDS)
def test_refresh_halo_multi_is_bitwise_per_field(runs, world):
    for rank in range(world):
        got = np.load(runs[world] / f"refresh_{rank}.npz")
        for i, b in enumerate(grid_sharded.BNDS):
            np.testing.assert_array_equal(got[f"multi{i}"], got[f"per{i}"])
            q, src = got[f"multi{i}"], got[f"in{i}"]
            np.testing.assert_array_equal(q[2:-2], src[2:-2])
            sx = -1.0 if b == 1 else 1.0
            if rank == 0:
                np.testing.assert_array_equal(q[1], sx * src[2])
            else:
                left = np.load(runs[world] / f"refresh_{rank - 1}.npz")
                np.testing.assert_array_equal(q[:2], left[f"in{i}"][-4:-2])
            if rank == world - 1:
                np.testing.assert_array_equal(q[-2], sx * src[-3])


def test_refresh_halo_multi_at_world_1_seeds_both_faces():
    mesh = make_mesh(device="cpu")
    qs = [torch.randn(10, 6, 6) for _ in range(5)]
    out = grid_sharded._refresh_halo_multi([q.clone() for q in qs],
                                           grid_sharded.BNDS, mesh)
    for q, src, b in zip(out, qs, grid_sharded.BNDS):
        sx = -1.0 if b == 1 else 1.0
        assert torch.equal(q[1], sx * src[2]) and torch.equal(q[-2],
                                                              sx * src[-3])
        assert not q[0].any() and not q[-1].any()


@pytest.mark.parametrize("gx0", [None, -1, 5, 9], ids=["cubic", "face",
                                                        "inner", "far-face"])
def test_plain_slab_modes_equal_the_dense_stages(gx0):
    """The plain versions of the four stencil kernels: on a cubic field
    they equal the dense stages (stam.buoyancy3d then
    stam.vorticity_confinement3d; divergence3d with set_bnd3d(0);
    stam._advect_stencil), and on a slab padded with 2 rows a side, its
    owned rows equal the dense stages' rows, bit for bit."""
    from tpufluids_torch.grid import kernels, stam as tstam
    n = 14
    rng = np.random.default_rng(5)
    cfg = tstam.StamConfig(n=n, dt=0.5 / n, vorticity_eps=2.0,
                           buoyancy_alpha=0.05, buoyancy_beta=0.5)
    dt0 = cfg.dt * n
    u, v, w, d, t, p = (tstam.set_bnd3d(b, torch.from_numpy(rng.uniform(
        -1.2 / dt0, 1.2 / dt0, (n + 2,) * 3).astype(np.float32)))
        for b in (1, 2, 3, 0, 0, 0))
    dense = {"forcing": [], "advect": tstam._advect_stencil(
        (u, v, w, d), (1, 2, 3, 0), (u, v, w), dt0)}
    for c in (cfg, cfg.replace(vorticity_eps=0.0),
              cfg.replace(buoyancy_alpha=0.0, buoyancy_beta=0.0)):
        ww = tstam.buoyancy3d(w, d, t, c) if c.buoyancy_beta else w
        dense["forcing"].append(tstam.vorticity_confinement3d(u, v, ww, c)
                                if c.vorticity_eps else (u, v, ww))
    div = torch.zeros_like(u)
    div[1:-1, 1:-1, 1:-1] = tstam.divergence3d(u, v, w)
    dense["div"] = (tstam.set_bnd3d(0, div),)
    dense["gradsub"] = tuple(
        tstam._with_interior(q, q[1:-1, 1:-1, 1:-1] - 0.5 * (
            p[tuple(slice(2, None) if a == ax else slice(1, -1)
                    for a in range(3))]
            - p[tuple(slice(0, -2) if a == ax else slice(1, -1)
                      for a in range(3))]) * n, b)
        for ax, (b, q) in enumerate(((1, u), (2, v), (3, w))))
    if gx0 is None:
        rows, cut, own, gown = n + 2, lambda q: q, slice(None), slice(None)
    else:
        rows, own = 8, slice(2, 6)
        gown = slice(gx0 + 2, gx0 + 6)

        def cut(q):
            out = torch.zeros((rows, n + 2, n + 2))
            lo, hi = max(gx0, 0), min(gx0 + rows, n + 2)
            out[lo - gx0:hi - gx0] = q[lo:hi]
            return out
    su, sv, sw, sd, st, sp = map(cut, (u, v, w, d, t, p))
    got = {"advect": kernels.advect3d_multi_plain(
               (su, sv, sw), (1, 2, 3), su, sv, sw, dt0, gx0)
           + kernels.advect3d_multi_plain((sd,), (0,), su, sv, sw, dt0, gx0),
           "forcing": [kernels.forcing3d_plain(su, sv, sw, sd, st, c, gx0)
                       for c in (cfg, cfg.replace(vorticity_eps=0.0),
                                 cfg.replace(buoyancy_alpha=0.0,
                                             buoyancy_beta=0.0))],
           "div": (kernels.div3d_plain(su, sv, sw, gx0),)}
    for g, r in zip(got["advect"], dense["advect"]):
        assert torch.equal(g[own], r[gown])
    for gs, rs in zip(got["forcing"], dense["forcing"]):
        for g, r in zip(gs, rs):
            assert torch.equal(g[own], r[gown])
    assert torch.equal(got["div"][0][own], dense["div"][0][gown])
    for g, r in zip(kernels.gradsub3d_plain(sp, su, sv, sw, gx0),
                    kernels.gradsub3d_plain(p, u, v, w)):
        assert torch.equal(g[own], r[gown])
