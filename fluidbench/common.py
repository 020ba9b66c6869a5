"""What every part of the benchmark shares: the manifest, files found by
name, the card's facts, the statistics and the check for JAX."""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"
# top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "tpufluids")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(MANIFEST)


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in {MANIFEST.name}")


def cell_files(w: dict) -> tuple[dict, dict, dict]:
    """(configuration, traffic, limits) of workload ``w``, each found by
    name: configs/<config>.json, traffic/<traffic>.json and
    limits/<workload>.json."""
    return (load_json(HERE / "configs" / f"{w['config']}.json"),
            load_json(HERE / "traffic" / f"{w['traffic']}.json"),
            load_json(HERE / "limits" / f"{w['name']}.json"))


def module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark, loaded by path
    (a name may hold '.' or '-')."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"fluidbench_{kind}_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def end_to_end(man: dict, w: dict) -> list[dict]:
    """The end-to-end metrics that workload ``w`` reports: those that
    list it under "workloads", or list no workloads."""
    return [m for m in man["end_to_end"]
            if w["name"] in m.get("workloads", [w["name"]])]


def per_layer(man: dict, w: dict) -> list[dict]:
    """The per-layer metrics that workload ``w`` reports: those that list
    it under "workloads" and, of those that list none, each whose
    end-to-end metric (``moves``) the workload reports."""
    moves = {m["name"] for m in end_to_end(man, w)}
    return [m for m in man["per_layer"]
            if (w["name"] in m["workloads"] if "workloads" in m
                else m["moves"] in moves)]


def quantity(name: str) -> str:
    """The quantity a metric's name measures, the part before the first
    '.': a quantity split between cells whose end-to-end metrics differ
    (``updates_per_s`` and ``updates_per_s.host_paced``) is one."""
    return name.split(".")[0]


def reader(name: str):
    """The reader of per-layer metric ``name``: metrics/<name>.py, or
    the reader of its quantity where the metric has none of its own."""
    own = HERE / "metrics" / f"{name}.py"
    return module("metrics", name if own.is_file() else quantity(name)).read


def forbidden_modules(names) -> list[str]:
    """The loaded modules whose top-level name, the part before the
    first dot, is one of FORBIDDEN: ``tpufluids_torch`` is not
    ``tpufluids``."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def card_facts() -> dict:
    """The card's name, the device count, each card's power limit, and
    its SM clock, power draw and temperature now."""
    import torch
    rows = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit,clocks.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    cols = [[c.strip() for c in row.split(",")] for row in rows]
    return {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "power_limit": [c[0] for c in cols],
            "state": [", ".join(c[1:]) for c in cols]}


def quartiles(values) -> tuple[float, float, float]:
    """(first quartile, median, third quartile), as
    statistics.quantiles(values, n=4) gives them."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return q1, q2, q3


def p95(values) -> float:
    """The 95th percentile of all the values, linear between the order
    statistics (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = 0.95 * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def say(*a):
    print(*a, file=sys.stderr, flush=True)
