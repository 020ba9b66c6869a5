"""A configuration of another kind enters the harness with files of its
own only: the toy in toy/ (a manifest, a configuration naming its own
driver and reference, a traffic mix and a limits file) copied into a
benchmark tree of its own, where common's ROOT, HERE and MANIFEST point.
Its driver checks ``heat_gap``, cuts the cell itself, plants its own
faults and reports ``updates_per_s`` and ``setup_s`` only.  The cell is
held to the same checks as the real ones, run through run.run on the
CPU, and through calibrate.main's loop over its control and faults."""

import json
import shutil
from pathlib import Path

import pytest

from fluidbench import calibrate, common, run
from fluidbench.tests.conftest import driver_of
from fluidbench.tests.test_fluidbench_manifest import check_manifest
from fluidbench.tests.test_fluidbench_reference import assert_follows
from fluidbench.tests.test_fluidbench_run import (assert_control_fails,
                                                  assert_fault_fails,
                                                  assert_sound)

TOY = Path(__file__).resolve().parent / "toy"
NAME = "heat-12.sweeps"


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The toy's benchmark tree under tmp_path, with the harness's own
    reader of its one per-layer metric; returns its manifest."""
    here = tmp_path / "fluidbench"
    shutil.copytree(TOY, here, ignore=shutil.ignore_patterns(
        "__pycache__", "manifest.json"))
    (here / "metrics").mkdir()
    shutil.copy(common.HERE / "metrics" / "device_idle_share.py",
                here / "metrics")
    shutil.copy(TOY / "manifest.json", tmp_path / "BENCHMARK.json")
    monkeypatch.setattr(common, "ROOT", tmp_path)
    monkeypatch.setattr(common, "HERE", here)
    monkeypatch.setattr(common, "MANIFEST", tmp_path / "BENCHMARK.json")
    return common.manifest()


def test_toy_keeps_the_manifest_contract(toy):
    check_manifest(toy)
    assert [m["name"] for m in common.end_to_end(toy, toy["workloads"][0])] \
        == ["updates_per_s", "setup_s"]


@pytest.mark.parametrize("n", [6, 9])
def test_toy_follows_its_reference(toy, n):
    assert_follows(NAME, n)


def test_toy_sound_run_is_correct(toy, small_cells):
    assert_sound(NAME)


def test_toy_faults_and_control_are_not_correct(toy, small_cells):
    faults = driver_of(NAME).FAULTS
    assert faults
    for fault in faults:
        assert_fault_fails(NAME, fault)
    assert_control_fails(NAME)


def test_toy_calibrates(toy, small_cells, monkeypatch, tmp_path):
    """calibrate.main reads the program, the control and each of the
    driver's faults, here on the CPU, one seed each."""
    real = run.run
    monkeypatch.setattr(run, "run", lambda args, overrides=None: real(
        args, "cpu", require=False, overrides=overrides))
    out = tmp_path / "calibrate"
    calibrate.main(["--workload", NAME, "--seeds", "11", "--control-seeds",
                    "12", "--fault-seeds", "13", "--seconds", "0.01",
                    "--out", str(out)])
    rows = [json.loads(line) for line in
            (out / f"calibrate_{NAME}.jsonl").read_text().splitlines()]
    gaps = {row["side"]: row["checks"]["heat_gap"]["value"] for row in rows}
    assert list(gaps) == ["program", "control", *driver_of(NAME).FAULTS]
    limit = rows[0]["checks"]["heat_gap"]["limit"]
    assert gaps.pop("program") <= limit
    assert all(value > limit for value in gaps.values())
