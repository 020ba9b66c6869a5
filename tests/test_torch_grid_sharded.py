"""The port's sharded grid step (tpufluids_torch.shard.make_sharded_step)
on the CPU against the JAX package's, on the same seeded 16^3 fields:
the plain slab step against JAX's backend="xla" at worlds 1, 2 and 4;
the kernel step (the kernels' plain versions here) against JAX's
backend="pallas" in interpret mode at worlds 1 and 2, and against the
port's own dense step; and the rejections of JAX's tests.

Tolerances: JAX's own (tests/test_grid_sharded.py): rtol 2e-4, atol 2e-5
for the XLA slab step, rtol 3e-4, atol 3e-5 for the Pallas step; final
Jacobi residuals within 1e-3 relative (a max over nearly cancelling
terms); a DCT residual is rounding noise, held below DCT_RESIDUAL as
JAX's test holds its own.
The kernel step equals the port's dense step bit for bit with the
Jacobi projection; with the DCT projection its x transform is summed
over the ranks in another order, within 1e-6 of max|field|.  Inputs are
set_bnd-consistent: a slab rebuilds its x ghosts from the rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_shard_workers as workers
from jax.experimental.pallas import tpu as pltpu

from tpufluids.grid import stam as jstam
from tpufluids.shard import grid_sharded as jgs
from tpufluids.shard import make_mesh as jax_mesh
from tpufluids_torch.grid import convert, stam
from tpufluids_torch.shard import Mesh, grid_sharded, make_mesh, spawn

N = 16
WORLDS = (2, 4)
XLA_TOL = dict(rtol=2e-4, atol=2e-5)
PALLAS_TOL = dict(rtol=3e-4, atol=3e-5)
RESIDUAL_RTOL = 1e-3
DCT_TOL = 1e-6
DCT_RESIDUAL = 1e-6
# tests/test_grid_sharded.py's configurations at 16^3: the XLA slab step
# with diffusion and forcing; config 3's step for the kernels
PLAIN_KW = dict(n=N, dt=0.05, jacobi_iters=8, red_black=True,
                buoyancy_beta=0.5, vorticity_eps=2.0, visc=1e-4, diff=1e-4,
                temp_diff=1e-4)
KERNEL_KW = dict(n=N, dt=0.02, jacobi_iters=8, red_black=True,
                 advect_mode="stencil", vorticity_eps=2.0,
                 buoyancy_alpha=0.05, buoyancy_beta=1.0)
# (name, configuration keywords, backend, steps)
CASES = [("plain", PLAIN_KW, "plain", 1),
         ("plain_dct", dict(PLAIN_KW, projection="dct"), "plain", 1),
         ("kernels", KERNEL_KW, "kernels", 2),
         ("kernels_one", KERNEL_KW, "kernels", 1),
         ("kernels_dct", dict(KERNEL_KW, projection="dct"), "kernels", 2),
         ("kernels_diffusion", dict(KERNEL_KW, visc=1e-4, diff=1e-4,
                                    temp_diff=1e-4), "kernels", 1)]
FIELDS = grid_sharded.FIELDS


def _seeded(seed=3):
    """tests/test_grid_sharded.py's seeded3d, set_bnd-consistent."""
    rng = np.random.default_rng(seed)
    shape = (N + 2,) * 3
    raw = {"u": rng.normal(0, 0.3, shape), "v": rng.normal(0, 0.3, shape),
           "w": rng.normal(0, 0.3, shape), "dens": rng.uniform(0, 1, shape),
           "temp": rng.uniform(0, 1, shape)}
    return {f: np.array(jstam.set_bnd3d(b, jnp.asarray(raw[f], jnp.float32)))
            for f, b in zip(FIELDS, grid_sharded.BNDS)}


def _run_port(fields, cases):
    """{name/field: collected field with x ghosts, name/res: residual} of
    a world of 1, in this process."""
    mesh = make_mesh(device="cpu")
    out = {}
    for name, kw, backend, n_steps in cases:
        state = convert.slab_state_from_numpy(fields, 0, 1, device="cpu")
        step = grid_sharded.make_sharded_step(mesh, stam.StamConfig(**kw),
                                              n_steps, backend)
        state, res = step(state)
        full = grid_sharded.from_sharded_layout(state)
        out.update({f"{name}/{f}": getattr(full, f).numpy() for f in FIELDS})
        out[f"{name}/res"] = res.numpy()
        out[f"{name}/backend"] = np.array(step.backend)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(seeded fields, world -> results); worlds above 1 run once each in
    spawned processes."""
    d = tmp_path_factory.mktemp("grid_sharded")
    fields = _seeded()
    np.savez(d / "inputs.npz", **fields)
    results = {1: _run_port(fields, CASES)}
    for world in WORLDS:
        out = d / f"world{world}"
        out.mkdir()
        spawn(world, workers.steps, str(out), str(d / "inputs.npz"), CASES,
              backend="gloo")
        results[world] = dict(np.load(out / "steps.npz"))
    return fields, results


def _jax_step(fields, kw, n_dev, backend, n_steps):
    cfg = jstam.StamConfig(solver_backend="xla", **kw)
    state = jstam.GridState3D(**{f: jnp.asarray(a) for f, a in fields.items()})
    mesh = jax_mesh(n_dev)
    step = jgs.make_sharded_step(mesh, cfg, n_steps=n_steps, backend=backend)
    sh = jgs.shard_state(jgs.to_sharded_layout(state), mesh)
    with pltpu.force_tpu_interpret_mode():
        out, res = step(sh)
    full = jgs.from_sharded_layout(jax.device_get(out), cfg)
    return {f: np.asarray(getattr(full, f)) for f in FIELDS}, float(res)


def _case(name):
    return next(c for c in CASES if c[0] == name)


def _check_residual(got, want, dct):
    if dct:
        assert got < DCT_RESIDUAL and want < DCT_RESIDUAL
    else:
        np.testing.assert_allclose(got, want, rtol=RESIDUAL_RTOL)


def _check(results, name, ref, ref_res, tol):
    for f in FIELDS:
        np.testing.assert_allclose(results[f"{name}/{f}"], ref[f], **tol,
                                   err_msg=f)
    _check_residual(float(results[f"{name}/res"]), ref_res,
                    name.endswith("dct"))


@pytest.mark.parametrize("world,name", [(1, "plain"), (2, "plain"),
                                        (4, "plain"), (2, "plain_dct")])
def test_plain_step_matches_jax_xla(runs, world, name):
    fields, results = runs
    _, kw, _, n_steps = _case(name)
    ref, ref_res = _jax_step(fields, kw, world, "xla", n_steps)
    assert str(results[world][f"{name}/backend"]) == "plain"
    _check(results[world], name, ref, ref_res, XLA_TOL)


@pytest.mark.parametrize("world", [1, 2])
def test_kernel_step_matches_jax_pallas(runs, world):
    fields, results = runs
    _, kw, _, n_steps = _case("kernels_one")
    ref, ref_res = _jax_step(fields, kw, world, "pallas", n_steps)
    _check(results[world], "kernels_one", ref, ref_res, PALLAS_TOL)


@pytest.mark.parametrize("world", (1,) + WORLDS)
def test_kernel_step_is_bitwise_dense(runs, world):
    """The kernel step, collected, equals the port's dense step
    (stam.run3d_python) bit for bit with the Jacobi projection; with the
    DCT projection within DCT_TOL of max|field|."""
    fields, results = runs
    state = convert.state_from_numpy(fields, device="cpu")
    for name in ("kernels", "kernels_dct"):
        _, kw, backend, n_steps = _case(name)
        assert str(results[world][f"{name}/backend"]) == "kernels"
        dense, res = stam.run3d_python(state, stam.StamConfig(**kw), n_steps)
        for f in FIELDS:
            want = getattr(dense, f).numpy()
            got = results[world][f"{name}/{f}"]
            if name == "kernels" or world == 1:
                np.testing.assert_array_equal(got, want, err_msg=f)
            else:
                np.testing.assert_allclose(
                    got, want, rtol=0,
                    atol=DCT_TOL * float(np.abs(want).max()), err_msg=f)
        _check_residual(float(results[world][f"{name}/res"]),
                        float(res[0]), name == "kernels_dct")


@pytest.mark.parametrize("world", (1,) + WORLDS)
def test_kernel_step_with_diffusion_matches_jax_xla(runs, dense_diffusion,
                                                    world):
    """The kernel step's diffusion runs red-black sweeps, as JAX's Pallas
    step does, where the dense step runs Jacobi sweeps: within JAX's
    Pallas tolerance of the dense JAX step at these coefficients."""
    _, results = runs
    ref, ref_res = dense_diffusion
    _check(results[world], "kernels_diffusion", ref, ref_res, PALLAS_TOL)


@pytest.fixture(scope="module")
def dense_diffusion(runs):
    """The JAX dense step of the diffusion case, once for the module."""
    fields, _ = runs
    _, kw, _, _ = _case("kernels_diffusion")
    cfg = jstam.StamConfig(solver_backend="xla", **kw)
    ref = jstam.GridState3D(**{f: jnp.asarray(a) for f, a in fields.items()})
    ref, ref_res = jstam.step3d(ref, cfg, with_residual=True)
    return {f: np.asarray(getattr(ref, f)) for f in FIELDS}, float(ref_res)


def _mesh(size):
    """A rank of a world of ``size``, for the checks make_sharded_step
    makes before any collective."""
    return Mesh(rank=0, size=size, group=None, device=torch.device("cpu"))


def test_rejects_multigrid():
    cfg = stam.StamConfig(n=16, projection="multigrid")
    with pytest.raises(ValueError, match="projection"):
        grid_sharded.make_sharded_step(_mesh(2), cfg)


def test_kernels_reject_unsupported():
    cfg = stam.StamConfig(n=16, jacobi_iters=8, red_black=False)
    with pytest.raises(ValueError, match="even per-device slab"):
        grid_sharded.make_sharded_step(_mesh(2), cfg, backend="kernels")
    for bad in (dict(red_black=True, advect_mode="gather"),
                dict(red_black=True, advect_mode="stencil",
                     solver_dtype="bfloat16")):
        with pytest.raises(ValueError, match="backend='kernels'"):
            grid_sharded.make_sharded_step(_mesh(2), cfg.replace(**bad),
                                           backend="kernels")


def test_tiny_slab_plan():
    """c_local = 2 slabs take a halo that fits one slab: fuse 1."""
    cfg = stam.StamConfig(n=16, dt=0.02, jacobi_iters=8, red_black=True,
                          advect_mode="stencil")
    step = grid_sharded.make_sharded_step(_mesh(8), cfg, backend="kernels")
    assert (step.backend, step.fuse) == ("kernels", 1)


def test_kernels_reject_odd_slab():
    cfg = stam.StamConfig(n=24, jacobi_iters=8, red_black=True,
                          advect_mode="stencil")        # c_local = 3
    with pytest.raises(ValueError, match="even per-device slab"):
        grid_sharded.make_sharded_step(_mesh(8), cfg, backend="kernels")


def test_rejects_bad_worlds_and_backends():
    cfg = stam.StamConfig(n=18, red_black=True, advect_mode="stencil")
    with pytest.raises(ValueError, match="must divide"):
        grid_sharded.make_sharded_step(_mesh(4), cfg)
    with pytest.raises(ValueError, match="backend"):
        grid_sharded.make_sharded_step(_mesh(1), cfg, backend="pallas")
    with pytest.raises(ValueError, match="n_steps"):
        grid_sharded.make_sharded_step(_mesh(1), cfg, n_steps=0)


def test_auto_takes_the_kernels_on_cuda_slabs_by_configuration():
    cfg = stam.StamConfig(n=16, red_black=True, advect_mode="stencil")
    cuda = Mesh(rank=0, size=2, group=None, device=torch.device("cuda"))
    assert grid_sharded.make_sharded_step(cuda, cfg).backend == "kernels"
    assert grid_sharded.make_sharded_step(_mesh(2), cfg).backend == "plain"
    assert grid_sharded.make_sharded_step(
        cuda, cfg.replace(advect_mode="gather")).backend == "plain"
    assert grid_sharded.make_sharded_step(
        Mesh(rank=0, size=8, group=None, device=torch.device("cuda")),
        cfg.replace(n=24)).backend == "plain"           # odd slabs
