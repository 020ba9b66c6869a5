"""Whole runs of the harness on the CPU at 16^3, without the look for a
card: a sound run is correct and reports its cell's metrics, a run with
the timed path broken underneath by one of its driver's faults is not,
nor is its control, and the command without a card exits non-zero with
a message and no result."""

import json
import subprocess
import sys

import pytest
import torch

from fluidbench import common, run
from fluidbench.tests.conftest import driver_of

CELLS = [w["name"] for w in common.manifest()["workloads"]]
BROKEN = [(name, fault)
          for name in ("stam3d-256.dct", "stam3d-256.rbjacobi")
          for fault in driver_of(name).FAULTS]


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


def assert_sound(name):
    """A sound run is correct and reports exactly the cell's end-to-end
    metrics: the set-up and a rate, and a frame tail where the cell has
    one."""
    out = one_run(name)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(out)[-1] == "checks"
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    w = common.workload(common.manifest(), name)
    names = [m["name"] for m in common.end_to_end(common.manifest(), w)]
    assert set(out["metrics"]) == set(names)
    assert {"updates_per_s", "setup_s"} <= {
        common.quantity(m) for m in names} <= {
        "updates_per_s", "frame_ms_p95", "setup_s"}
    json.dumps(out)


def assert_fault_fails(name, fault):
    """With the driver's fault ``fault`` under the timed path, the run is
    not correct and says so in plain JSON."""
    restore = driver_of(name).plant(fault)
    try:
        out = one_run(name)
    finally:
        restore()
    assert out["correct"] is False and out["failed"] >= 1
    json.loads(json.dumps(out, allow_nan=False))


def assert_control_fails(name):
    """The cell's control, the program on the limits file's lower path,
    is not correct."""
    w = common.workload(common.manifest(), name)
    control = common.cell_files(w)[2]["control"]
    assert one_run(name, overrides=control)["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(small_cells, name):
    assert_sound(name)


def test_traced_run(small_cells):
    out = one_run("stam3d-256.dct", trace=1)
    assert out["correct"]
    assert "enqueue_ms_per_step.host_paced" in out["metrics"]
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name,fault", BROKEN,
                         ids=[f"{name}-{fault}" for name, fault in BROKEN])
def test_broken_timed_path_is_not_correct(small_cells, name, fault):
    assert_fault_fails(name, fault)


@pytest.mark.parametrize("name", ["stam3d-256.rbjacobi", "plume3d-64.whole"])
def test_control_is_not_correct(small_cells, name):
    """The control, the program in bfloat16 storage for its solves, at a
    size the CPU holds.  (The DCT cell's control, the final solve in
    TF32, exists only on the card: test_control_on_the_card.)"""
    assert_control_fails(name)


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
