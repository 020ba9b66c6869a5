"""Each cell's program against its configuration's reference, at 16^3
and 24^3 through the cell's driver (``follows_reference``: for the grid
cells, the Jacobi and red-black cells bit for bit, the DCT cell within
float32 rounding), and the grid driver's scene and gaps."""

import dataclasses

import pytest
import torch

from fluidbench import common
from fluidbench.drivers import grid3d
from fluidbench.reference import stam3d as reference
from fluidbench.tests.conftest import small_files

CELLS = [w["name"] for w in common.manifest()["workloads"]]
SEED = 2 ** 31 + 11


def assert_follows(name: str, n: int):
    """The cell's program follows its reference at n^3: the gap within
    the driver's tolerance, the residual's within that or 1e-6 of the
    reference's scale, whichever is larger."""
    w = common.workload(common.manifest(), name)
    config, traffic, _ = common.cell_files(w)
    driver = common.module("drivers", config["driver"])
    gap, tol, residual_gap = driver.follows_reference(config, traffic, n,
                                                      SEED)
    assert gap <= tol
    assert residual_gap <= max(tol, 1e-6)


@pytest.mark.parametrize("n", [16, 24])
@pytest.mark.parametrize("name", CELLS)
def test_reference_follows_the_port(name, n):
    assert_follows(name, n)


def test_reference_leaves_its_inputs_alone():
    w = common.workload(common.manifest(), CELLS[0])
    config, traffic, _ = small_files(w, 12)
    kw = grid3d.grid_keywords(config, traffic)
    inputs = grid3d.seed_state(config, kw, 5, "cpu")
    copy = {f: t.clone() for f, t in inputs.items()}
    from tpufluids_torch.grid import stam
    reference.run(inputs, dataclasses.asdict(stam.StamConfig(**kw)), 2)
    assert all(torch.equal(inputs[f], copy[f]) for f in inputs)


def test_seed_state():
    w = common.workload(common.manifest(), CELLS[0])
    config, traffic, _ = small_files(w, 12)
    kw = grid3d.grid_keywords(config, traffic)
    a = grid3d.seed_state(config, kw, 2 ** 33 + 1, "cpu")
    b = grid3d.seed_state(config, kw, 2 ** 33 + 1, "cpu")
    c = grid3d.seed_state(config, kw, 2 ** 33 + 2, "cpu")
    assert all(torch.equal(a[f], b[f]) for f in a)
    assert not torch.equal(a["u"], c["u"])
    vmax = 0.5 / (kw["dt"] * 12)
    assert float(a["u"].abs().max()) <= vmax
    # set_bnd-consistent: the normal component is odd across its wall
    assert torch.equal(a["u"][0], -a["u"][1])
    assert float(a["dens"].sum()) > 0 and float(a["temp"].max()) == 3.0


@pytest.mark.parametrize("side", ["got", "want"])
def test_gap_is_nan_where_either_side_is_not_finite(side):
    fields = {f: torch.ones(4, 4, 4) for f in reference.FIELDS}
    broken = {f: t.clone() for f, t in fields.items()}
    broken["temp"][1, 2, 3] = float("nan")
    got, want = (broken, fields) if side == "got" else (fields, broken)
    gap = grid3d.gaps(got, want)
    assert gap != gap
    assert grid3d.gaps(fields, fields) == 0.0
