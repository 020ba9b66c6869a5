"""The sharded red-black solve (kernels.lin_solve3d_rb_shard, PERF.md row
12) on the CPU, through its plain version: stitched over worlds 1, 2 and
4 it equals the port's dense lin_solve3d_rb bit for bit; one slab's
single pass equals the dense solve's rows at a face and inside the grid;
it matches the JAX package's lin_solve3d_rb_shard inside shard_map in
interpret mode at 1 and 2 devices; and its fuse choice is
rb_shard_plan's.

Tolerances: bit for bit against the port's dense solve (the same
operations in the same order).  Against the JAX Pallas solve,
1e-6 * max|reference|, as tests/test_torch_jacobi.py holds the dense
solve against lin_solve3d_rb_packed.  Inputs are set_bnd-consistent:
a slab rebuilds its x ghosts from the rule, as JAX's does."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_shard_workers as workers
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import PartitionSpec as P

from tpufluids.grid import pallas_kernels as pk
from tpufluids.grid import stam as jstam
from tpufluids.shard import make_mesh as jax_mesh
from tpufluids_torch.grid import kernels
from tpufluids_torch.shard import grid_sharded, make_mesh, spawn

N = 16
WORLDS = (2, 4)
# (name, b, initial guess key or None, x0 key, a, c, iters)
A_DIFF = 0.05 * 2e-4 * N * N        # a diffusion coefficient: a = dt nu n^2
CASES = ([(f"b{b}", b, f"x{b}", "x0", 1.0, 6.0, 8) for b in range(4)]
         + [(f"b{b}_zero", b, None, "x0", 1.0, 6.0, 8) for b in range(4)]
         + [("b0_zero_20", 0, None, "x0", 1.0, 6.0, 20),
            ("b1_diffusion", 1, "x1", "x1", A_DIFF, 1 + 6 * A_DIFF, 8)])
TOL = 1e-6


def _inputs(n, seed):
    """Dense ghosted fields: x0 (b = 0) and a set_bnd-consistent guess
    x{b} for each b."""
    rng = np.random.default_rng(seed)
    out = {"x0": rng.normal(0, 1, (n + 2,) * 3).astype(np.float32)}
    for b in range(4):
        out[f"x{b}"] = np.array(jstam.set_bnd3d(b, jnp.asarray(
            rng.normal(0, 1, (n + 2,) * 3).astype(np.float32))))
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(inputs, world -> {case name: the collected (n, n+2, n+2)
    result}); worlds above 1 run once each in spawned processes."""
    d = tmp_path_factory.mktemp("rb_shard")
    inputs = _inputs(N, 0)
    np.savez(d / "inputs.npz", **inputs)
    results = {}
    for world in WORLDS:
        out = d / f"world{world}"
        out.mkdir()
        spawn(world, workers.rb_solves, str(out), str(d / "inputs.npz"),
              CASES, backend="gloo")
        results[world] = dict(np.load(out / "rb.npz"))
    mesh = make_mesh(device="cpu")
    results[1] = {}
    for name, b, xkey, x0key, a, c, iters in CASES:
        x0 = torch.from_numpy(inputs[x0key])[1:-1].contiguous()
        x = None if xkey is None else torch.from_numpy(inputs[xkey])[1:-1]
        results[1][name] = grid_sharded._rb_solve(
            b, x, x0, a, c, iters, mesh,
            kernels.rb_shard_plan(N, iters)).numpy()
    return inputs, results


@pytest.mark.parametrize("world", (1,) + WORLDS)
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_stitched_slabs_equal_the_dense_solve(data, world, case):
    inputs, results = data
    name, b, xkey, x0key, a, c, iters = case
    dense = kernels.lin_solve3d_rb_plain(
        b, None if xkey is None else torch.from_numpy(inputs[xkey]),
        torch.from_numpy(inputs[x0key]), a, c, iters)
    np.testing.assert_array_equal(results[world][name],
                                  dense[1:-1].numpy())


@pytest.mark.parametrize("n", [15, 16])
@pytest.mark.parametrize("fuse", [1, 2, 4])
def test_one_pass_on_one_slab_equals_the_dense_rows(n, fuse):
    """A slab at the low face and one inside the grid, cut from the dense
    field with its ghost row and zeros outside the grid: one pass (iters
    = fuse) equals the dense solve's rows, for each b, from a guess and
    from zeros."""
    halo, c_local = 2 * fuse, max(2 * fuse, 4)
    rows = c_local + 2 * halo
    inputs = _inputs(n, 10 + n)

    def cut(x, gx0):
        out = torch.zeros((rows, n + 2, n + 2))
        lo, hi = max(gx0, 0), min(gx0 + rows, n + 2)
        out[lo - gx0:hi - gx0] = torch.from_numpy(x[lo:hi])
        return out

    for b in range(4):
        for zero in (False, True):
            x = None if zero else torch.from_numpy(inputs[f"x{b}"])
            dense = kernels.lin_solve3d_rb_plain(
                b, x, torch.from_numpy(inputs["x0"]), 1.0, 6.0, fuse)
            for r0 in (0, n // 2 - c_local // 2):
                gx0 = r0 + 1 - halo
                got = kernels.lin_solve3d_rb_shard(
                    b, None if zero else cut(inputs[f"x{b}"], gx0),
                    cut(inputs["x0"], gx0), 1.0, 6.0, fuse, gx0=gx0,
                    fuse=fuse)
                assert torch.equal(got, dense[r0 + 1:r0 + 1 + c_local]), \
                    (b, zero, r0)


def _jax_shard_solve(n_dev, b, x, x0, iters, x_zero):
    """JAX's lin_solve3d_rb_shard inside shard_map, in interpret mode, on
    the sharded layout; returned in the ghosted layout."""
    n = x0.shape[0]
    y = n + 2
    yp, zp = pk.zg_extents(y, y)
    tx, fuse, pipeline = pk.rb_shard_plan(n // n_dev, y, y, iters)
    spec = P("x", None, None)

    @jax.jit
    @partial(jax.shard_map, mesh=jax_mesh(n_dev), in_specs=(spec, spec),
             out_specs=spec, check_vma=False)
    def run(x, x0):
        out = pk.lin_solve3d_rb_shard(
            b, pk.zg_pad(x, yp, zp), pk.zg_pad(x0, yp, zp), 1.0, 6.0, iters,
            axis_name="x", n_dev=n_dev, y_true=y, z_true=y, tx=tx,
            fuse=fuse, pipeline=pipeline, x_zero=x_zero)
        return pk.zg_restore(out, b, y, y)

    with pltpu.force_tpu_interpret_mode():
        return np.asarray(run(jnp.asarray(x), jnp.asarray(x0)))


@pytest.mark.parametrize("n_dev,case", [(1, "b1"), (2, "b0_zero")])
def test_matches_jax_lin_solve3d_rb_shard(data, n_dev, case):
    inputs, results = data
    name, b, xkey, x0key, a, c, iters = next(k for k in CASES
                                             if k[0] == case)
    x = inputs[xkey][1:-1] if xkey else np.zeros_like(inputs["x0"][1:-1])
    ref = _jax_shard_solve(n_dev, b, x, inputs[x0key][1:-1], iters,
                           xkey is None)
    np.testing.assert_allclose(results[n_dev][name], ref, rtol=0,
                               atol=TOL * float(np.abs(ref).max()))


@pytest.mark.parametrize("c_local", [2, 4, 6, 8, 16, 32])
def test_fuse_choice_is_rb_shard_plan(c_local):
    for iters in (1, 2, 3, 4, 6, 8, 20):
        assert kernels.rb_shard_plan(c_local, iters) == \
            pk.rb_shard_plan(c_local, 18, 18, iters)[1], iters
    # a halo of 4 or 8 rows does not fit a slab of 2: fuse 1
    assert kernels.rb_shard_plan(2, 8) == 1


def test_rejects_what_the_solve_does_not_take():
    x0 = torch.zeros((5 + 8, 6, 6))          # c_local 5, fuse 2
    with pytest.raises(ValueError, match="must be even"):
        kernels.lin_solve3d_rb_shard(0, None, x0, 1.0, 6.0, 4, gx0=-3,
                                     fuse=2)
    x0 = torch.zeros((4 + 8, 6, 6))
    with pytest.raises(ValueError, match="multiple of fuse"):
        kernels.lin_solve3d_rb_shard(0, None, x0, 1.0, 6.0, 3, gx0=-3,
                                     fuse=2)
    with pytest.raises(ValueError, match="fewer owned rows"):
        kernels.lin_solve3d_rb_shard(0, None, torch.zeros((2 + 8, 6, 6)),
                                     1.0, 6.0, 2, gx0=-3, fuse=2)
    with pytest.raises(ValueError, match="halo of 2"):
        kernels.rb_shard_plan(1, 8)
