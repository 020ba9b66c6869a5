"""The port's I/O and diagnostics against the JAX package's, on the CPU:
checkpoints load across the packages in both directions with equal
arrays, dtypes and meta, and resume bit for bit; the VTK writers (the
Python copy and the C++ writer built into ``build/native``) write the
JAX package's bytes; the snapshot writer, the metrics log and the
blow-up guard give the JAX package's frames, records and messages;
``profile`` writes a trace."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufluids import diagnostics as jdiag
from tpufluids import scenes as jscenes
from tpufluids import step as jstep
from tpufluids.config import BASE_CONFIG as JBASE
from tpufluids.config import UNIDYN_CONFIG as JUNIDYN
from tpufluids.grid import mac as jmac
from tpufluids.grid import stam as jstam
from tpufluids.io import checkpoint as jckpt
from tpufluids.io import vtk as jvtk
from tpufluids.io.snapshots import SnapshotWriter as JSnapshotWriter
from tpufluids.oracle import state_to_dict
from tpufluids.state import ParticleState as JParticleState
from tpufluids_torch import convert, diagnostics, scenes, step
from tpufluids_torch.config import BASE_CONFIG, UNIDYN_CONFIG
from tpufluids_torch.grid import mac, stam
from tpufluids_torch.io import checkpoint, native, vtk
from tpufluids_torch.io.snapshots import SnapshotWriter
from tpufluids_torch.state import FIELDS

TOLS = [("pos", 2e-4), ("vel", 2e-3), ("dens", 1e-4), ("press", 2e-3),
        ("acc", 2e-3)]


def _jax_state(d):
    return JParticleState(**{k: jnp.asarray(v) for k, v in d.items()})


def _seeded_fields(n=40, seed=7, capacity=48):
    """A particle state's fields (numpy) with every field nonzero and
    some dead rows."""
    d = {k: np.array(v) for k, v in state_to_dict(jscenes.random_blob(
        n, seed=seed, cfg=JUNIDYN, capacity=capacity)).items()}
    rng = np.random.default_rng(seed)
    for k in ("dens", "press", "mass", "solid", "fluid"):
        d[k] = rng.uniform(0.5, 2.0, d[k].shape).astype(np.float32)
    for k in ("diffusion", "delpress", "stress", "acc"):
        d[k] = rng.normal(0.0, 1.0, d[k].shape).astype(np.float32)
    d["alive"][[3, 9]] = False
    d["boundary"][[1, 4]] = True
    return d


# ---------------------------------------------------------------------------
# checkpoints

def _grid_pair(kind):
    """(JAX state, port state, port template) of a seeded grid state."""
    rng = np.random.default_rng(11)
    if kind == "GridState3D":
        jcls, tcls, n = jstam.GridState3D, stam.GridState3D, 8
        shapes = [(n + 2,) * 3] * 5
    elif kind == "GridState2D":
        jcls, tcls, n = jstam.GridState2D, stam.GridState2D, 8
        shapes = [(n + 2,) * 2] * 4
    else:
        jcls, tcls, n = jmac.MacState3D, mac.MacState3D, 6
        shapes = [(n + 1, n, n), (n, n + 1, n), (n, n, n + 1), (n,) * 3,
                  (n,) * 3]
    names = [f.name for f in dataclasses.fields(tcls)]
    arrs = {f: rng.normal(size=s).astype(np.float32)
            for f, s in zip(names, shapes)}
    return (jcls(**{k: jnp.asarray(v) for k, v in arrs.items()}),
            tcls(**{k: torch.from_numpy(v) for k, v in arrs.items()}),
            tcls(**{k: torch.zeros(1) for k in names}))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_particle_checkpoint_crosses_the_packages(tmp_path, writer):
    d = _seeded_fields()
    path = str(tmp_path / "ck.npz")
    if writer == "jax":
        jckpt.save(path, _jax_state(d), JUNIDYN, step=7, extra={"note": "hi"})
        got, meta = checkpoint.load(path, device="cpu")
        cfg = checkpoint.load_config(path)
        got = convert.state_to_numpy(got)
        _, ref_meta = jckpt.load(path)
    else:
        checkpoint.save(path, convert.state_from_numpy(d, device="cpu"),
                        UNIDYN_CONFIG, step=7, extra={"note": "hi"})
        st, meta = jckpt.load(path)
        cfg = jckpt.load_config(path)
        got = state_to_dict(st)
        _, ref_meta = checkpoint.load(path, device="cpu")
    for f in FIELDS:
        assert got[f].dtype == d[f].dtype, f
        np.testing.assert_array_equal(got[f], d[f], err_msg=f)
    assert meta == ref_meta
    assert meta["step"] == 7 and meta["extra"] == {"note": "hi"}
    assert meta["type"] == "ParticleState" and meta["fields"] == list(FIELDS)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JUNIDYN)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(UNIDYN_CONFIG)


@pytest.mark.parametrize("kind", ["GridState3D", "GridState2D",
                                  "MacState3D"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_grid_checkpoint_crosses_the_packages(tmp_path, kind, writer):
    jst, tst, template = _grid_pair(kind)
    path = str(tmp_path / "grid.npz")
    if writer == "jax":
        jckpt.save(path, jst, step=3)
        got, meta = checkpoint.load(path, template=template, device="cpu")
    else:
        checkpoint.save(path, tst, step=3)
        got, meta = jckpt.load(path, template=jst)
    assert meta["type"] == kind and meta["step"] == 3
    assert meta["config"] is None
    for f in dataclasses.fields(tst):
        a = np.asarray(getattr(got, f.name))
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, getattr(tst, f.name).numpy())
    with pytest.raises(ValueError):
        checkpoint.load(path, device="cpu")   # no template: not particles


def test_resume_continues_bit_for_bit(tmp_path):
    """Save at step 5, load, 5 more steps: the straight 10-step run's
    state, bit for bit (tests/test_io.py's check, in the port)."""
    cfg = BASE_CONFIG.replace(max_per_cell=32)
    state = scenes.random_blob(80, seed=1, span=0.12, device="cpu")
    full, _ = step.run_chunk(state, cfg, 10)
    half, _ = step.run_chunk(state, cfg, 5)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, half, cfg, step=5)
    resumed, meta = checkpoint.load(path, device="cpu")
    assert meta["step"] == 5
    assert checkpoint.load_config(path) == cfg
    done, _ = step.run_chunk(resumed, cfg, 5)
    for f in FIELDS:
        assert torch.equal(getattr(done, f), getattr(full, f)), f


def test_port_resumes_a_jax_checkpoint(tmp_path):
    """JAX saves after 5 steps; the port loads it and runs 5 more: within
    the SPH slice tolerances of the JAX package's straight 10 steps."""
    jcfg = JBASE.replace(max_per_cell=32)
    jst = jscenes.random_blob(80, seed=1, span=0.12)
    jfull, _ = jstep.run_chunk(jst, jcfg, 10)
    jhalf, _ = jstep.run_chunk(jst, jcfg, 5)
    path = str(tmp_path / "ck.npz")
    jckpt.save(path, jhalf, jcfg, step=5)
    resumed, _ = checkpoint.load(path, device="cpu")
    cfg = checkpoint.load_config(path)
    done, _ = step.run_chunk(resumed, cfg, 5)
    got, ref = convert.state_to_numpy(done), state_to_dict(jfull)
    gi, ri = np.argsort(got["pid"]), np.argsort(ref["pid"])
    np.testing.assert_array_equal(got["pid"][gi], ref["pid"][ri])
    for key, rtol in TOLS:
        b = ref[key][ri].astype(np.float64)
        np.testing.assert_allclose(
            got[key][gi].astype(np.float64), b, rtol=rtol,
            atol=1e-5 * max(1.0, np.abs(b).max()), err_msg=key)


# ---------------------------------------------------------------------------
# VTK

def _mesh_args(name):
    """The arguments after (filename, use_binary) of mesh writer ``name``,
    on seeded inputs."""
    rng = np.random.default_rng(0)
    npts = 23
    pts = rng.normal(size=(npts, 3)).astype(np.float32)
    s1, s2 = (rng.normal(size=npts).astype(np.float32) for _ in range(2))
    v1, v2 = (rng.normal(size=(npts, 3)).astype(np.float32)
              for _ in range(2))
    dims = [3, 4, 2]
    pdata = rng.normal(size=24).astype(np.float32)
    cdata = rng.normal(size=6).astype(np.float32)
    return {
        "point": (npts, pts, 4, [1, 3, 1, 3], ["a", "v", "b", "w"],
                  [s1, v1, s2, v2]),
        "unstructured": (4, pts[:4], 3, [jvtk.VISIT_TRIANGLE,
                                         jvtk.VISIT_TRIANGLE,
                                         jvtk.VISIT_QUAD],
                         [0, 1, 2, 0, 2, 3, 0, 1, 2, 3], 2, [1, 1], [1, 0],
                         ["s", "c"], [s1[:4], s2[:3]]),
        "rectilinear": (dims, np.arange(3, dtype=np.float32),
                        rng.normal(size=4).astype(np.float32),
                        np.arange(2, dtype=np.float32) + 2, 3, [1, 1, 3],
                        [1, 0, 1], ["p", "c", "pv"],
                        [pdata, cdata, rng.normal(size=72)]),
        "regular": (dims, 2, [1, 1], [1, 1], ["p", "q"],
                    [pdata, pdata[::-1].copy()]),
        "curvilinear": (dims, rng.normal(size=(24, 3)), 2, [1, 1], [1, 0],
                        ["s", "c"], [pdata, cdata]),
    }[name]


MESHES = ("point", "unstructured", "rectilinear", "regular", "curvilinear")


def _as_tensors(args):
    """The arguments with every float32 array as a CPU tensor."""
    def t(a):
        if isinstance(a, np.ndarray) and a.dtype == np.float32:
            return torch.from_numpy(a)
        if isinstance(a, list):
            return [t(x) for x in a]
        return a
    return tuple(t(a) for a in args)


@pytest.mark.parametrize("binary", [0, 1])
@pytest.mark.parametrize("mesh", MESHES)
def test_vtk_writers_match_jax_bytes(tmp_path, mesh, binary):
    fn = f"write_{mesh}_mesh"
    args = _mesh_args(mesh)
    getattr(jvtk, fn)(str(tmp_path / "jax"), binary, *args)
    getattr(vtk, fn)(str(tmp_path / "port"), binary, *_as_tensors(args))
    ref = (tmp_path / "jax.vtk").read_bytes()
    assert ref.startswith(b"# vtk DataFile Version 2.0\n")
    assert (tmp_path / "port.vtk").read_bytes() == ref


@pytest.mark.parametrize("binary", [0, 1])
@pytest.mark.parametrize("mesh", MESHES)
def test_native_writer_matches_python_bytes(tmp_path, mesh, binary):
    fn = f"write_{mesh}_mesh"
    args = _as_tensors(_mesh_args(mesh))
    getattr(vtk, fn)(str(tmp_path / "py"), binary, *args)
    getattr(native, fn)(str(tmp_path / "nat"), binary, *args)
    assert (tmp_path / "nat.vtk").read_bytes() == (
        tmp_path / "py.vtk").read_bytes()


def test_native_library_is_built_outside_the_package():
    lib = native.build()
    assert lib.parent.name == "native" and lib.parent.parent.name == "build"
    assert not list(native.SRC.parent.glob("*.so"))


VARNAMES = {"base": ("dens", "cellnumber"),
            "unidyn": ("mass", "surface_level"),
            "all": ("vel", "press", "solid", "cellnumber", "mass")}


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("names", list(VARNAMES))
def test_particle_snapshot_matches_jax_bytes(tmp_path, names, binary):
    """Seeded fields off the cell faces (a random blob), so ``cellnumber``
    is the same cell in both packages."""
    d = _seeded_fields()
    jvtk.write_particle_snapshot(str(tmp_path / "jax"), _jax_state(d),
                                 cfg=JBASE, varnames=VARNAMES[names],
                                 use_binary=binary)
    vtk.write_particle_snapshot(str(tmp_path / "port"),
                                convert.state_from_numpy(d, device="cpu"),
                                cfg=BASE_CONFIG, varnames=VARNAMES[names],
                                use_binary=binary)
    ref = (tmp_path / "jax.vtk").read_bytes()
    assert b"POINTS 38 float" in ref      # two dead rows left out
    assert (tmp_path / "port.vtk").read_bytes() == ref


def test_snapshot_writer_frames_match_jax(tmp_path):
    ds = [_seeded_fields(seed=s) for s in (1, 2, 3)]
    jsnap = JSnapshotWriter(str(tmp_path / "jax"), prefix="f_", cfg=JBASE,
                            varnames=("dens", "cellnumber"))
    snap = SnapshotWriter(str(tmp_path / "port"), prefix="f_",
                          cfg=BASE_CONFIG, varnames=("dens", "cellnumber"))
    for i, d in enumerate(ds):
        jsnap(5 * i, _jax_state(d))
        snap(5 * i, convert.state_from_numpy(d, device="cpu"))
    jsnap.close()
    snap.close()
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "f_0.vtk", "f_1.vtk", "f_2.vtk"]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (
            tmp_path / "jax" / name).read_bytes()


def test_snapshot_writer_error_surfaces_on_close(tmp_path):
    snap = SnapshotWriter(str(tmp_path), varnames=("no_such_field",))
    snap(0, convert.state_from_numpy(_seeded_fields(), device="cpu"))
    with pytest.raises(KeyError):
        snap.close()


# ---------------------------------------------------------------------------
# diagnostics

def test_metrics_logger_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    stacked = {f: rng.uniform(0, 100, 4).astype(np.float32)
               for f in step.StepMetrics._fields}
    stacked["n_alive"] = np.array([40, 40, 39, 39], np.int32)
    tm = step.StepMetrics(**{k: torch.from_numpy(v)
                             for k, v in stacked.items()})
    jm = jstep.StepMetrics(**{k: jnp.asarray(v) for k, v in stacked.items()})
    recs = []
    for logger, metrics, name in ((jdiag.MetricsLogger, jm, "jax"),
                                  (diagnostics.MetricsLogger, tm, "port"),
                                  (diagnostics.MetricsLogger,
                                   dict(tm._asdict()), "dict")):
        log = logger(str(tmp_path / f"{name}.jsonl"))
        rec = log.log(4, metrics, wall_s=0.5)
        log.close()
        lines = [json.loads(x) for x in open(tmp_path / f"{name}.jsonl")]
        assert lines == [rec]
        recs.append(rec)
    assert recs[0] == recs[1] == recs[2]
    assert list(recs[1]) == ["step", "wall_s", *step.StepMetrics._fields]


BLOWUPS = {"healthy": None, "nan pos": ("pos", np.nan),
           "inf vel": ("vel", np.inf), "fast": ("vel", 2e3)}


@pytest.mark.parametrize("case", list(BLOWUPS))
def test_check_state_matches_jax(tmp_path, case):
    d = _seeded_fields()
    if BLOWUPS[case]:
        field, value = BLOWUPS[case]
        d[field][5, 1] = value
    msgs = []
    for guard, st, name in ((jdiag, _jax_state(d), "jax"),
                            (diagnostics,
                             convert.state_from_numpy(d, device="cpu"),
                             "port")):
        dump = str(tmp_path / f"{name}.npz")
        try:
            guard.check_state(st, JBASE if name == "jax" else BASE_CONFIG,
                              dump_path=dump)
            msgs.append(None)
        except guard.BlowUpError as e:
            msgs.append(str(e).replace(dump, "<dump>"))
            assert os.path.exists(dump)
    assert msgs[0] == msgs[1]
    assert (msgs[0] is None) == (case == "healthy")
    if msgs[1] is not None:   # the port's dump loads in the JAX package
        st, _ = jckpt.load(str(tmp_path / "port.npz"))
        np.testing.assert_array_equal(np.asarray(st.vel), d["vel"])


def test_profile_writes_a_trace(tmp_path):
    x = torch.arange(1000.0)
    with diagnostics.profile("region", arrays=(x,),
                             trace_dir=str(tmp_path)) as held:
        y = (x * 2.0).sum()
    assert float(y) == 999000.0
    assert held["name"] == "region" and held["seconds"] > 0
    trace = tmp_path / "region.pt.trace.json"
    assert trace.is_file()
    assert "traceEvents" in json.loads(trace.read_text())
    with diagnostics.profile("plain") as held:
        pass
    assert held["seconds"] >= 0 and not (tmp_path / "plain.pt.trace.json"
                                         ).exists()


@pytest.mark.parametrize("binary", [0, 1])
def test_native_writer_writes_the_particle_snapshot(tmp_path, binary):
    st = convert.state_from_numpy(_seeded_fields(), device="cpu")
    names = ("dens", "cellnumber")
    vtk.write_particle_snapshot(str(tmp_path / "py"), st, cfg=BASE_CONFIG,
                                varnames=names, use_binary=binary)
    native.write_point_mesh(str(tmp_path / "nat"), binary,
                            *vtk.particle_snapshot_args(st, BASE_CONFIG,
                                                        names))
    assert (tmp_path / "nat.vtk").read_bytes() == (
        tmp_path / "py.vtk").read_bytes()
