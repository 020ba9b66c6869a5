"""The port's command line (``tpufluids_torch.cli``) on the CPU
(``--cpu``), in-process: every scene at a small size prints one summary
line, last on stdout, with the JAX CLI's keys (taken by running
``tpufluids.cli.main`` in-process); the same argv writes the same VTK
frame names and metrics keys; a checkpointed run resumes bit for bit;
grid3d_sharded runs on a world of 1 and on a spawned world of 2 gloo
processes."""

import contextlib
import io
import json
import math
import os

import numpy as np
import pytest

from tpufluids import cli as jcli
from tpufluids_torch import cli

SCENES = {
    "base_dam": ["base_dam", "--steps", "3", "--particles", "300",
                 "--boundary-particles", "30"],
    "base_dam, sort_every 2": ["base_dam", "--steps", "4", "--particles",
                               "300", "--sort-every", "2"],
    "base_dam, subbin parity": ["base_dam", "--steps", "2", "--particles",
                                "300", "--subbin-parity"],
    "unidyn_tank": ["unidyn_tank", "--steps", "1"],
    "smoke2d": ["smoke2d", "--size", "16", "--steps", "3"],
    "plume3d": ["plume3d", "--size", "16", "--steps", "2",
                "--vorticity", "2"],
    "plume3d --mac": ["plume3d", "--mac", "--size", "16", "--steps", "2",
                      "--projection", "multigrid"],
    "grid3d": ["grid3d", "--size", "16", "--steps", "2", "--projection",
               "dct", "--red-black", "--vorticity", "2"],
    "grid3d_sharded": ["grid3d_sharded", "--size", "16", "--steps", "2",
                       "--devices", "1"],
    "grid3d_sharded, pallas": ["grid3d_sharded", "--size", "16", "--steps",
                               "2", "--red-black", "--advect-mode",
                               "stencil", "--backend", "pallas"],
}


def _run(main, argv):
    """(summary, stdout lines) of ``main(argv)`` in this process."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    lines = buf.getvalue().strip().splitlines()
    return json.loads(lines[-1]), lines


def _argvs(out):
    return {
        "base_dam": ["base_dam", "--steps", "4", "--particles", "300",
                     "--out", str(out / "dam"), "--snapshot-every", "2",
                     "--metrics", str(out / "m.jsonl")],
        "grid3d": ["grid3d", "--size", "8", "--steps", "2"],
        "smoke2d": ["smoke2d", "--size", "8", "--steps", "4", "--out",
                    str(out / "smoke"), "--snapshot-every", "2"],
    }


# the JAX CLI's summary keys (tpufluids/cli.py:174-180, :266-277), held
# against its own runs by test_summaries_frames_and_metrics_match_the_jax_cli
SPH_KEYS = ["scene", "steps", "wall_s", "steps_per_sec", "particles",
            "particle_updates_per_sec", "max_speed", "bin_overflow"]
GRID_KEYS = ["scene", "steps", "wall_s", "steps_per_sec",
             "cell_updates_per_sec", "poisson_residual", "residual_kind"]


def _keys(scene):
    return SPH_KEYS if scene in cli.SPH_SCENES else GRID_KEYS


@pytest.mark.parametrize("case", list(SCENES))
def test_every_scene_runs_on_the_cpu(case):
    argv = SCENES[case]
    rec, lines = _run(cli.main, argv + ["--cpu"])
    assert list(rec) == _keys(argv[0])
    assert rec["scene"] == argv[0]
    assert rec["steps"] == int(argv[argv.index("--steps") + 1])
    assert rec["wall_s"] > 0 and rec["steps_per_sec"] > 0
    if argv[0] in cli.SPH_SCENES:
        want = 14040 if argv[0] == "unidyn_tank" else 300 + (
            30 if "--boundary-particles" in argv else 0)
        assert rec["particles"] == want
        assert rec["bin_overflow"] == 0
        assert math.isfinite(rec["max_speed"])
        return
    if argv[0] == "smoke2d":
        assert math.isnan(rec["poisson_residual"])
    else:
        assert 0.0 <= rec["poisson_residual"] < 1.0
    assert rec["residual_kind"] == ("mac_max_divergence" if "--mac" in argv
                                    else "poisson_system")


def test_summaries_frames_and_metrics_match_the_jax_cli(tmp_path):
    """The same argv through the JAX CLI and the port's (in directories of
    their own): the same summary keys, frame names and metrics keys."""
    jtmp = tmp_path / "jax"
    jrecs = {name: _run(jcli.main, a + ["--cpu"])[0]
             for name, a in _argvs(jtmp).items()}
    assert list(jrecs["base_dam"]) == SPH_KEYS
    assert list(jrecs["grid3d"]) == list(jrecs["smoke2d"]) == GRID_KEYS
    for name, a in _argvs(tmp_path).items():
        rec, _ = _run(cli.main, a + ["--cpu"])
        assert list(rec) == list(jrecs[name]), name
        for key in ("scene", "steps", "particles", "bin_overflow",
                    "residual_kind"):
            assert rec.get(key) == jrecs[name].get(key), (name, key)
    for frames in ("dam", "smoke"):
        assert sorted(os.listdir(tmp_path / frames)) == sorted(
            os.listdir(jtmp / frames)), frames
        first = sorted(os.listdir(tmp_path / frames))[0]
        assert (tmp_path / frames / first).read_bytes().startswith(
            b"# vtk DataFile Version 2.0\nWritten using VisIt writer\n")
    mine = [json.loads(x) for x in open(tmp_path / "m.jsonl")]
    ref = [json.loads(x) for x in open(jtmp / "m.jsonl")]
    assert [list(r) for r in mine] == [list(r) for r in ref]
    assert mine[0]["n_alive"] == ref[0]["n_alive"] == 300


def test_checkpoint_and_resume_match_a_straight_run(tmp_path):
    """6 straight steps against 3, a checkpoint, and 3 more resumed: the
    final checkpoints hold the same arrays, bit for bit."""
    base = ["base_dam", "--particles", "300", "--cpu"]
    a, b, c = (str(tmp_path / f"{x}.npz") for x in "abc")
    _run(cli.main, base + ["--steps", "6", "--checkpoint", a])
    _run(cli.main, base + ["--steps", "3", "--checkpoint", b])
    rec, _ = _run(cli.main, base + ["--steps", "3", "--resume", b,
                                    "--checkpoint", c])
    assert rec["particles"] == 300
    with np.load(a) as za, np.load(c) as zc:
        meta = json.loads(bytes(zc["meta"]).decode())
        assert meta["step"] == 3 and meta["type"] == "ParticleState"
        for i in range(len(meta["fields"])):
            np.testing.assert_array_equal(zc[f"arr_{i}"], za[f"arr_{i}"],
                                          err_msg=meta["fields"][i])


def test_checkpoint_every_writes_during_the_run(tmp_path):
    path = str(tmp_path / "ck.npz")
    _run(cli.main, ["base_dam", "--particles", "200", "--steps", "4",
                    "--checkpoint", path, "--checkpoint-every", "2",
                    "--snapshot-every", "2", "--cpu"])
    with np.load(path) as z:
        assert json.loads(bytes(z["meta"]).decode())["step"] == 4


def test_grid3d_sharded_on_a_spawned_world_of_two():
    """Rank 0 hands its result back; this process prints the one line."""
    rec, lines = _run(cli.main, ["grid3d_sharded", "--size", "16",
                                 "--steps", "2", "--devices", "2",
                                 "--cpu"])
    assert list(rec) == GRID_KEYS
    assert 0.0 <= rec["poisson_residual"] < 1.0
    assert len(lines) == 1
