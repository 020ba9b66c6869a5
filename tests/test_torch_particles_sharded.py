"""The port's sharded SPH step (tpufluids_torch.shard.particles) against
the JAX package on the CPU: JAX's cases of tests/test_particles_sharded.py
(base and unidyn against the single-device step by pid, merges across
every cut, migration, receiver-slot exhaustion), the column family, one
case per variant and the clipped XLA pair path against JAX's own
make_sharded_step on the fake CPU mesh, a world of 1 bit for bit against
the port's sph_step, and a slab's tables and runs against JAX's
build_bins on the same slab.

Worlds of 2 and 4 ranks run over gloo in processes that ``spawn``
starts once per world in this module, every case inside that one spawn
(tests/torch_shard_workers.py); their collected pools come back through
an npz file.  Tolerances: JAX's, rtol 3e-4 (base) and 1e-3 (unidyn) with
atol 1e-5 * max(1, max|ref|); counts, pids and overflow counters exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_shard_workers as workers

from tests.test_forces_vs_oracle import mixed_blob
from tpufluids import binning as jbinning
from tpufluids.config import BASE_CONFIG as JBASE
from tpufluids.config import UNIDYN_CONFIG as JUNIDYN
from tpufluids.oracle import state_to_dict
from tpufluids.scenes import random_blob as jblob
from tpufluids.shard import make_mesh as jmake_mesh
from tpufluids.shard import particles as jparticles
from tpufluids.state import ParticleState as JState
from tpufluids.state import make_state as jmake_state
from tpufluids.step import run_chunk as jrun_chunk
from tpufluids.step import sph_step as jsph_step
from tpufluids_torch import binning, convert, step
from tpufluids_torch.shard import Mesh, make_mesh, particles, spawn
from tpufluids_torch.state import FIELDS
from tests.test_torch_unidyn_lanes import share_of_the_cores  # noqa: F401

JB = JBASE.replace(max_per_cell=32)
JU = JUNIDYN.replace(max_per_cell=64, grid_size=16, cell_size=0.125)
JM = JUNIDYN.replace(max_per_cell=32, grid_size=16, cell_size=0.125,
                     merge_dist=0.05)
# the clipped XLA pair path: sub-binned base, runs cut at 12 rows
JX = JBASE.replace(max_per_cell=4, force_backend="xla", subbin_parity=True)


def _port(jcfg):
    return convert.config_from_dict(dataclasses.asdict(jcfg))


def _merge_points(world):
    """JAX's merge scene: one close pair straddling every cut, a pair
    inside a slab, two singles."""
    pts = []
    for xc in ([0.0] if world == 2 else [-0.5, 0.0, 0.5]):
        pts += [[xc - 0.015, 0.3, 0.1], [xc + 0.015, 0.3, 0.1]]
    pts += [[0.4, -0.3, 0.2], [0.43, -0.3, 0.2]]
    pts += [[-0.6, 0.1, -0.2], [0.7, 0.5, 0.5]]
    return jmake_state(np.array(pts, np.float32), cfg=JM)


def _exhaust():
    """Rank 0 (x < 0): two fast rows just left of the cut; rank 1: four
    resting rows filling its pool of 4."""
    pos = np.array([[-0.001, -0.5, 0.0], [-0.001, 0.5, 0.0],
                    [0.3, -0.5, 0.0], [0.3, 0.5, 0.0],
                    [0.6, -0.5, 0.0], [0.6, 0.5, 0.0]], np.float32)
    vel = np.zeros((6, 3), np.float32)
    vel[:2, 0] = 3.0
    return jmake_state(pos, vel, cfg=JB)


def _migrating():
    st = jblob(100, seed=7, span=0.5)
    vel = np.asarray(st.vel).copy()
    vel[:, 0] = 3.0
    return st.replace(vel=jnp.asarray(vel))


SCENES = {
    "blob200": lambda: jblob(200, seed=5, span=0.6),
    "mixed150": lambda: mixed_blob(150, 21, JU, span=0.7, boundary_frac=0.1),
    "merge2": lambda: _merge_points(2),
    "merge4": lambda: _merge_points(4),
    "exhaust": _exhaust,
    "migrate": _migrating,
    "blob120": lambda: jblob(120, seed=3, span=0.5),
    "mixed100": lambda: mixed_blob(100, 11, JU, span=0.6, boundary_frac=0.1),
    "dense": lambda: jblob(400, seed=9, span=0.15),
}

# name -> (JAX config, the port's changes, scene, steps, capacity a rank,
# make_sharded_step keywords)
CASES = {
    2: {
        "base": (JB, {}, "blob200", 3, 220, {}),
        "unidyn": (JU, {}, "mixed150", 3, 170, {}),
        "merge": (JM, {}, "merge2", 2, 10, {}),
        "exhaust": (JB, {}, "exhaust", 3, 4, {}),
        "base_auto": (JB, {}, "blob120", 2, 140, {}),
        "unidyn_auto": (JU, {}, "mixed100", 2, 140, {}),
        "base_column": (JB, dict(pallas_kernel="column", pallas_col_cap=64),
                        "blob120", 2, 140, {}),
        "unidyn_column": (JU, dict(pallas_kernel="column",
                                   pallas_col_cap=64),
                          "mixed100", 2, 140, {}),
        "xla": (JX, {}, "dense", 2, 400, {}),
    },
    4: {
        "base": (JB, {}, "blob200", 3, 220, {}),
        "unidyn": (JU, {}, "mixed150", 3, 170, {}),
        "merge": (JM, {}, "merge4", 2, 10, {}),
        "migrate": (JB, {}, "migrate", 40, 120, {}),
    },
}


def _by_pid(d):
    alive = d["alive"].astype(bool)
    rows = np.argsort(d["pid"][alive])
    return {k: v[alive][rows] for k, v in d.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """world -> {case: (the collected pool by pid, metrics)}."""
    d = tmp_path_factory.mktemp("particles")
    inputs = d / "scenes.npz"
    np.savez(inputs, **{f"{s}/{k}": v for s, make in SCENES.items()
                        for k, v in state_to_dict(make()).items()})
    out = {}
    for world, cases in CASES.items():
        wd = d / f"world{world}"
        wd.mkdir()
        spawn(world, workers.particle_steps, str(wd), str(inputs),
              [(name, _port(jcfg).replace(**ch), scene, n, cap, kw)
               for name, (jcfg, ch, scene, n, cap, kw) in cases.items()],
              backend="gloo")
        data = np.load(wd / "particles.npz")
        out[world] = {}
        for name in cases:
            keys = [k for k in data.files if k.startswith(name + "/")]
            fields = {k.split("/")[1]: data[k] for k in keys
                      if "/m_" not in k}
            metrics = {k.split("/m_")[1]: data[k] for k in keys
                       if "/m_" in k}
            out[world][name] = (_by_pid(fields), metrics)
    return out


_JSTEP = jax.jit(jsph_step, static_argnames=("cfg",))


def _single(jcfg, scene, steps):
    """JAX's single-device step (its XLA path on the CPU, jitted), by
    pid."""
    st = SCENES[scene]()
    for _ in range(steps):
        st, _ = _JSTEP(st, jcfg)
    return _by_pid(state_to_dict(st))


_JAX_SHARDED = {}


def _jax_sharded(jcfg, scene, steps, cap, world=2):
    """JAX's make_sharded_step on the fake CPU mesh, by pid, and its
    metrics."""
    key = (jcfg, scene, steps, cap, world)
    if key not in _JAX_SHARDED:
        mesh = jmake_mesh(world)
        out, m = jparticles.make_sharded_step(mesh, jcfg, n_steps=steps)(
            jparticles.distribute(SCENES[scene](), mesh, jcfg, cap))
        _JAX_SHARDED[key] = (_by_pid(state_to_dict(jparticles.collect(out))),
                             {k: np.asarray(v)
                              for k, v in m._asdict().items()})
    return _JAX_SHARDED[key]


def _close(got, want, fields, rtol):
    np.testing.assert_array_equal(got["pid"], want["pid"])
    for f in fields:
        scale = max(1.0, float(np.abs(want[f]).max()))
        np.testing.assert_allclose(got[f], want[f], rtol=rtol,
                                   atol=1e-5 * scale, err_msg=f)


def _no_overflow(m):
    assert int(m["halo_overflow"]) == int(m["migrate_overflow"]) == 0


@pytest.mark.parametrize("world", [2, 4])
def test_base_sharded_matches_single(runs, world):
    got, m = runs[world]["base"]
    _no_overflow(m)
    assert int(m["n_alive"]) == 200 and int(m["bin_overflow"]) == 0
    _close(got, _single(JB, "blob200", 3),
           ("pos", "vel", "dens", "press", "acc"), 3e-4)


@pytest.mark.parametrize("world", [2, 4])
def test_unidyn_sharded_matches_single(runs, world):
    got, m = runs[world]["unidyn"]
    _no_overflow(m)
    _close(got, _single(JU, "mixed150", 3),
           ("pos", "vel", "dens", "solid", "fluid", "stress"), 1e-3)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_merge_matches_single(runs, world):
    """A close pair across every cut merges as on one device: the owners'
    picks replace the halo rows', and pids resolve the mutual picks."""
    got, m = runs[world]["merge"]
    _no_overflow(m)
    n_pairs = (1 if world == 2 else 3) + 1
    n = 2 * n_pairs + 2
    assert int(m["n_alive"]) == n - n_pairs == got["pid"].size
    want = _single(JM, f"merge{world}", 2)
    _close(got, want, ("pos", "vel", "mass", "dens"), 1e-3)
    assert (got["mass"] == JM.merge_mass_new).sum() == n_pairs


def test_migration_happens(runs):
    """Rows crossing three cuts in 40 steps stay conserved and track the
    single-device run."""
    got, m = runs[4]["migrate"]
    _no_overflow(m)
    assert int(m["n_alive"]) == 100 == got["pid"].size
    ref, _ = jrun_chunk(SCENES["migrate"](), JB, 40)
    refd = _by_pid(state_to_dict(ref))
    np.testing.assert_array_equal(got["pid"], refd["pid"])
    np.testing.assert_allclose(got["pos"], refd["pos"], rtol=3e-4,
                               atol=1e-5)
    x0 = np.asarray(SCENES["migrate"]().pos[:, 0])

    def rank(x):
        return np.trunc((x - JB.xmin) / JB.cell_size).astype(int) // 10

    assert (rank(got["pos"][:, 0]) != rank(x0)).any()


def test_receiver_slot_exhaustion_counted(runs):
    """Migrants that find no free slot on the receiver are dropped and
    counted in migrate_overflow, as JAX counts them."""
    _, m = runs[2]["exhaust"]
    assert int(m["migrate_overflow"]) == 2
    assert int(m["n_alive"]) == 4
    _, jm = _jax_sharded(JB, "exhaust", 3, 4)
    assert int(jm["migrate_overflow"]) == 2 and int(jm["n_alive"]) == 4


@pytest.mark.parametrize("name", ["base_auto", "unidyn_auto"])
def test_matches_jax_make_sharded_step(runs, name):
    """The port's default family against JAX's sharded step on the fake
    CPU mesh of 2 devices (its XLA path), counters equal."""
    jcfg, _, scene, steps, cap, _ = CASES[2][name]
    got, m = runs[2][name]
    want, jm = _jax_sharded(jcfg, scene, steps, cap)
    for k in ("n_alive", "halo_overflow", "migrate_overflow",
              "bin_overflow"):
        assert int(m[k]) == int(jm[k]), k
    _close(got, want, ("pos", "vel", "dens", "press"),
           3e-4 if name.startswith("base") else 1e-3)


@pytest.mark.parametrize("variant", ["base", "unidyn"])
def test_column_family_matches_jax(runs, variant):
    """The column family (a rank's slab of columns, unidyn with the drift
    hook between its passes) against JAX's sharded step and the row-block
    family's run."""
    jcfg, _, scene, steps, cap, _ = CASES[2][f"{variant}_column"]
    got, m = runs[2][f"{variant}_column"]
    assert int(m["bin_overflow"]) == 0
    _no_overflow(m)
    rtol = 3e-4 if variant == "base" else 1e-3
    _close(got, _jax_sharded(jcfg, scene, steps, cap)[0],
           ("pos", "vel", "dens", "press"), rtol)
    _close(got, runs[2][f"{variant}_auto"][0], ("pos", "vel", "dens"),
           rtol)


def test_clipped_xla_path_matches_jax_sharded(runs):
    """The sub-binned base variant with force_backend="xla" and runs
    clipped at 3 * max_per_cell rows: the dropped slots of every rank's
    slab (halo rows included), summed, equal JAX's, and the pool tracks
    JAX's sharded step."""
    got, m = runs[2]["xla"]
    want, jm = _jax_sharded(JX, "dense", 2, 400)
    assert int(m["bin_overflow"]) == int(jm["bin_overflow"]) > 0
    _no_overflow(m)
    _close(got, want, ("pos", "vel", "dens", "press"), 3e-4)


@pytest.mark.parametrize("name", ["base", "unidyn", "xla"])
def test_world_of_one_is_the_single_device_step(name):
    """A world of 1 runs exactly the port's sph_step: bit for bit."""
    jcfg, _, scene, steps, cap, _ = CASES[2][name]
    cfg = _port(jcfg)
    dense = convert.state_from_numpy(state_to_dict(SCENES[scene]()),
                                     device="cpu")
    mesh = make_mesh(device="cpu")
    local = particles.distribute(dense, mesh, cfg, cap)
    out, m = particles.make_sharded_step(mesh, cfg, n_steps=steps)(local)
    ref = local
    overflow = 0
    for _ in range(steps):
        ref, rm = step.sph_step(ref, cfg)
        overflow += int(rm.bin_overflow)
    for f in FIELDS:
        assert torch.equal(getattr(out, f), getattr(ref, f)), f
    assert int(m.bin_overflow) == overflow
    assert int(m.n_alive) == int(rm.n_alive)
    assert float(m.max_speed) == float(rm.max_speed)
    assert int(m.halo_overflow) == int(m.migrate_overflow) == 0
    assert (overflow > 0) == (name == "xla")


@pytest.mark.parametrize("x_offset,planes", [(9, 12), (-1, 6), (13, 8)])
def test_slab_tables_and_runs_match_build_bins(x_offset, planes):
    """A slab's sorted tables and clipped runs (binning.clipped_runs)
    against JAX's sort_by_cell and build_bins on the same GridSpec: at
    the domain's low face, inside and at its high face."""
    jcfg = JBASE.replace(max_per_cell=1)
    jst = jblob(2000, seed=4, span=0.9)
    grid = jbinning.GridSpec(g=20, x_planes=planes, x_offset=x_offset)
    jcfg = jcfg.replace(grid_size=20, cell_size=0.1)
    sorted_j, jbt = jax.jit(jbinning.sort_by_cell, static_argnums=(1, 2))(
        jst, jcfg, grid)
    cfg = _port(jcfg)
    tst = convert.state_from_numpy(state_to_dict(jst), device="cpu")
    sorted_t, bt, perm = binning.sort_by_cell(
        tst, cfg, binning.GridSpec(*grid), subbin=True)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jbt.order))
    np.testing.assert_array_equal(bt.cid.numpy(), np.asarray(jbt.cid))
    np.testing.assert_array_equal(bt.cell_start.numpy(),
                                  np.asarray(jbt.cell_start))
    np.testing.assert_array_equal(bt.in_dom.numpy(), np.asarray(jbt.in_dom))
    np.testing.assert_array_equal(bt.home_count.numpy(),
                                  np.asarray(jbt.home_count))
    np.testing.assert_array_equal(bt.octant.numpy(), np.asarray(jbt.octant))
    start, length, overflow = binning.clipped_runs(bt, cfg)
    np.testing.assert_array_equal(length.numpy(), np.asarray(jbt.run_len))
    live = length.numpy() > 0
    np.testing.assert_array_equal(start.numpy()[live],
                                  np.asarray(jbt.run_start)[live])
    assert int(overflow) == int(jbt.overflow) > 0
    inside = int(bt.in_dom.sum())
    assert 0 < inside < 2000


def test_distribute_and_collect_a_world_of_one():
    """One rank holds every alive row, in order, padded with dead rows
    (pid -1); too few slots raise."""
    cfg = _port(JB)
    dense = convert.state_from_numpy(state_to_dict(jblob(50, seed=2)),
                                     device="cpu")
    mesh = make_mesh(device="cpu")
    local = particles.distribute(dense, mesh, cfg, 64)
    assert local.capacity == 64 and int(local.alive.sum()) == 50
    assert torch.equal(local.pid[:50], dense.pid)
    assert bool((local.pid[50:] == -1).all())
    back = particles.collect(local, mesh)
    for f in FIELDS:
        assert torch.equal(getattr(back, f), getattr(local, f)), f
    assert particles.distribute(dense, mesh, cfg).capacity == 80
    with pytest.raises(ValueError, match="needs 50 slots"):
        particles.distribute(dense, mesh, cfg, 40)


def test_pack_unpack_and_insert_match_jax():
    """The exchange buffers and the free-slot insertion against JAX's
    _pack_rows, _unpack_rows and _insert, exactly."""
    jst = mixed_blob(40, 3, JU)
    rng = np.random.default_rng(5)
    d = state_to_dict(jst)
    d["alive"] = rng.uniform(size=40) < 0.7
    d["split"] = rng.uniform(size=40) < 0.3
    mask = rng.uniform(size=40) < 0.5
    jst = JState(**{k: jnp.asarray(v) for k, v in d.items()})
    tst = convert.state_from_numpy(d, device="cpu")
    for cap in (8, 64):
        jbuf, jval, jsrc, jovf = jax.jit(jparticles._pack_rows,
                                         static_argnums=2)(
            jst, jnp.asarray(mask), cap)
        buf, val, src, ovf = particles._pack_rows(
            tst, torch.from_numpy(mask), cap)
        np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
        np.testing.assert_array_equal(val.numpy(), np.asarray(jval))
        np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
        assert int(ovf) == int(jovf) == max(int(mask.sum()) - cap, 0)
        got = convert.state_to_numpy(particles._unpack_rows(buf, val))
        want = state_to_dict(jparticles._unpack_rows(jbuf, jval))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    inc = particles._unpack_rows(buf, val)
    jinc = jparticles._unpack_rows(jbuf, jval)
    got, dropped = particles._insert(tst, inc)
    want, jdropped = jax.jit(jparticles._insert)(jst, jinc)
    assert int(dropped) == int(jdropped) > 0
    got, want = convert.state_to_numpy(got), state_to_dict(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_a_grid_that_does_not_split_raises():
    """The tank's 17 planes split over no world above 1, as in JAX."""
    cfg = _port(JUNIDYN)
    particles.make_sharded_step(make_mesh(device="cpu"), cfg)
    two = Mesh(rank=0, size=2, group=None, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="must divide"):
        particles.make_sharded_step(two, cfg)
