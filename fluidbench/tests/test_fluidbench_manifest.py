"""BENCHMARK.json against the benchmark's contract: every name resolves
to its files, and every name, unit and text keeps to its characters.
Each check takes the manifest, so that another one (a test's own) can be
held to it too."""

import re

import pytest

from fluidbench import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
MAN = common.manifest()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(MAN) == KEYS
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (common.ROOT / p).is_dir()
    assert 1 <= len(MAN["command"]) <= 32
    assert all(text_ok(word) for word in MAN["command"])
    script = common.ROOT / MAN["command"][1]
    assert script.is_file() and common.HERE in script.parents
    assert isinstance(MAN["run_seconds"], int)
    assert 1 <= MAN["run_seconds"] <= 51


def test_run_seconds_fits_a_full_check():
    runs = 2 + 14 * 24
    need = runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert need <= 43200


def check_config(man, c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and text_ok(c["source"]) and text_ok(c["why"])
    assert c["file"] == f"fluidbench/configs/{c['name']}.json"
    data = common.load_json(common.ROOT / c["file"])
    assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
    assert (common.HERE / "drivers" / f"{data['driver']}.py").is_file()
    assert any(w["config"] == c["name"] for w in man["workloads"])
    assert len(c["reduced"]) <= 16
    assert all(NAME.match(k) for k in c["reduced"])


def check_workload(man, w):
    """The cell's files resolve; its limits file holds a limit for each
    number its driver checks, and its control; its configuration's
    reference is there."""
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for key in ("name", "config", "traffic"):
        assert NAME.match(w[key])
    assert text_ok(w["why"]) and w["chips"] in (1, 4)
    assert w["config"] in {c["name"] for c in man["configs"]}
    config, traffic, limits = common.cell_files(w)
    assert traffic["name"] == w["traffic"]
    driver = common.module("drivers", config["driver"])
    assert {*driver.CHECKS, "control"} <= set(limits)
    assert (common.HERE / "reference" / f"{config['reference']}.py").is_file()
    reported = [m["name"] for m in common.end_to_end(man, w)]
    assert "setup_s" in reported and len(reported) >= 2
    layers = common.per_layer(man, w)
    assert layers and all(m["moves"] in reported for m in layers)


def check_names_are_unique(man):
    for group in ("configs", "workloads"):
        names = [x["name"] for x in man[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))


def check_end_to_end_metric(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                      "source"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


def check_per_layer_metric(man, m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                      "layer", "moves"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and text_ok(m["layer"])
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    assert m["moves"] in {e["name"] for e in man["end_to_end"]}
    assert callable(common.reader(m["name"]))
    names = {w["name"] for w in man["workloads"]}
    assert set(m.get("workloads", names)) <= names
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"


def check_manifest_is_small(man):
    assert common.MANIFEST.stat().st_size <= 64 * 1024
    assert 1 <= len(man["configs"]) <= 24
    assert 1 <= len(man["workloads"]) <= 24
    assert 1 <= len(man["end_to_end"]) <= 16
    assert 1 <= len(man["per_layer"]) <= 128


def check_manifest(man):
    """Every check of this file that does not concern the command."""
    for c in man["configs"]:
        check_config(man, c)
    for w in man["workloads"]:
        check_workload(man, w)
    check_names_are_unique(man)
    for m in man["end_to_end"]:
        check_end_to_end_metric(m)
    for m in man["per_layer"]:
        check_per_layer_metric(man, m)
    check_manifest_is_small(man)


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_config_resolves(c):
    check_config(MAN, c)


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(w):
    check_workload(MAN, w)


def test_names_are_unique():
    check_names_are_unique(MAN)


@pytest.mark.parametrize("m", MAN["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    check_end_to_end_metric(m)


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_its_reader(m):
    check_per_layer_metric(MAN, m)


def test_manifest_is_small():
    check_manifest_is_small(MAN)


def test_metrics_of_a_cell():
    """A metric with no "workloads" is every cell's (end-to-end), or every
    cell's that reports the metric it moves (per-layer); a split
    quantity reads its quantity's reader."""
    man = {"end_to_end": [
        {"name": "rate", "workloads": ["a"]},
        {"name": "rate.host_paced", "workloads": ["b"]},
        {"name": "setup_s"}],
        "per_layer": [
            {"name": "x", "moves": "rate"},
            {"name": "x.host_paced", "moves": "rate.host_paced"},
            {"name": "y", "moves": "rate", "workloads": ["b"]}]}
    names = lambda ms: [m["name"] for m in ms]
    assert names(common.end_to_end(man, {"name": "a"})) == ["rate", "setup_s"]
    assert names(common.end_to_end(man, {"name": "b"})) == [
        "rate.host_paced", "setup_s"]
    assert names(common.per_layer(man, {"name": "a"})) == ["x"]
    assert names(common.per_layer(man, {"name": "b"})) == ["x.host_paced", "y"]
    assert common.quantity("rate.host_paced") == "rate"
    assert common.reader("step_mfu.host_paced") is not None
