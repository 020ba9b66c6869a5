"""Fixtures of the benchmark's tests: cells cut to a size the CPU runs in
a second, and the look for a card for the tests marked gpu."""

import json

import pytest

from fluidbench import common

SMALL_N = 16
FULL_SIZE_FILES = common.cell_files


def small_files(w: dict, n: int = SMALL_N):
    """A cell's configuration, traffic and limits at n^3: dt scaled as
    0.5 / n where the configuration ties it to n, the blob scaled with
    the grid, a slice of two frames and the sampled frame among the
    first three."""
    config, traffic, limits = FULL_SIZE_FILES(w)
    config = json.loads(json.dumps(config))
    full = config["stam"]["n"]
    if config["stam"]["dt"] * full == 0.5:
        config["stam"]["dt"] = 0.5 / n
    config["stam"]["n"] = n
    config["scene"]["blob"] = {
        a: [max(1, lo * n // full), max(2, hi * n // full)]
        for a, (lo, hi) in config["scene"]["blob"].items()}
    traffic = dict(traffic, trace_frames=2, check_frame_max=3)
    return config, traffic, limits


@pytest.fixture
def small_cells(monkeypatch):
    """Every cell at SMALL_N^3 on the CPU."""
    monkeypatch.setattr(common, "cell_files", small_files)
    return small_files


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
