"""Fixtures of the benchmark's tests: cells cut to a size the CPU runs in
a second, and the look for a card for the tests marked gpu."""

import pytest

from fluidbench import common

SMALL_N = 16
FULL_SIZE_FILES = common.cell_files


def small_files(w: dict, n: int = SMALL_N):
    """A cell's configuration, traffic and limits cut to n^3 (or to its
    driver's own small size) by its driver's ``small``."""
    config, traffic, limits = FULL_SIZE_FILES(w)
    driver = common.module("drivers", config["driver"])
    return driver.small(config, traffic, limits, n)


def driver_of(name: str):
    """The driver module of cell ``name``."""
    config = common.cell_files(common.workload(common.manifest(), name))[0]
    return common.module("drivers", config["driver"])


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
