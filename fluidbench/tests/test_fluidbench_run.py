"""Whole runs of the harness on the CPU at 16^3, without the look for a
card: a sound run is correct, a run with the timed path broken
underneath is not, and the command without a card exits non-zero with a
message and no result."""

import json
import subprocess
import sys

import pytest
import torch

from fluidbench import common, faults, run

CELLS = [w["name"] for w in common.manifest()["workloads"]]


def one_run(name, seconds=0.01, trace=0, seed=2 ** 31 + 3, overrides=None):
    args = run.parse(["--workload", name, "--seed", str(seed), "--seconds",
                      str(seconds), "--trace", str(trace)])
    return run.run(args, "cpu", require=False, overrides=overrides)


def test_no_card_exits_with_a_message():
    p = subprocess.run([sys.executable, str(common.HERE / "run.py"),
                        "--workload", CELLS[0], "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True, text=True,
                       cwd=common.ROOT, timeout=120)
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr
    assert p.stdout.strip() == ""


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(small_cells, name):
    out = one_run(name)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(out)[-1] == "checks"
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    w = common.workload(common.manifest(), name)
    names = [m["name"] for m in common.end_to_end(common.manifest(), w)]
    assert set(out["metrics"]) == set(names)
    assert {common.quantity(m) for m in names} == {
        "updates_per_s", "frame_ms_p95", "setup_s"}
    json.dumps(out)


def test_traced_run(small_cells):
    out = one_run("stam3d-256.dct", trace=1)
    assert out["correct"]
    assert "enqueue_ms_per_step.host_paced" in out["metrics"]
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", faults.ALL, ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", ["stam3d-256.dct", "stam3d-256.rbjacobi"])
def test_broken_timed_path_is_not_correct(small_cells, monkeypatch, name,
                                          fault):
    from tpufluids_torch.grid import stam
    real = stam.run3d_python
    monkeypatch.setattr(stam, "run3d_python", fault(real))
    out = one_run(name)
    assert out["correct"] is False and out["failed"] >= 1
    json.loads(json.dumps(out, allow_nan=False))


@pytest.mark.parametrize("name", ["stam3d-256.rbjacobi", "plume3d-64.whole"])
def test_control_is_not_correct(small_cells, name):
    """The control, the program in bfloat16 storage for its solves, at a
    size the CPU holds.  (The DCT cell's control, the final solve in
    TF32, exists only on the card: test_control_on_the_card.)"""
    w = common.workload(common.manifest(), name)
    control = common.cell_files(w)[2]["control"]
    out = one_run(name, overrides=control)
    assert out["correct"] is False


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(cuda, name):
    """The control at the cell's own size on the card, three seeds."""
    w = common.workload(common.manifest(), name)
    control = common.cell_files(w)[2]["control"]
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        args = run.parse(["--workload", name, "--seed", str(seed),
                          "--seconds", "2"])
        assert run.run(args, overrides=control)["correct"] is False
