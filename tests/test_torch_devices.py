"""The port's entry points make their state on the card unless the
caller asks for the CPU: ``device`` defaults to "cuda", with no
fallback, so on a machine without a card a call that names no device
raises instead of running on the CPU."""

import inspect

import numpy as np
import pytest
import torch

from tpufluids_torch import cli, convert, scenes, state
from tpufluids_torch.grid import convert as grid_convert
from tpufluids_torch.grid import mac, stam
from tpufluids_torch.io import checkpoint
from tpufluids_torch.shard import make_mesh

ENTRY_POINTS = {
    "grid.stam.make_grid2d": stam.make_grid2d,
    "grid.stam.make_grid3d": stam.make_grid3d,
    "grid.convert.state_from_numpy": grid_convert.state_from_numpy,
    "grid.convert.slab_state_from_numpy": grid_convert.slab_state_from_numpy,
    "grid.mac.make_mac3d": mac.make_mac3d,
    "grid.convert.mac_state_from_numpy": grid_convert.mac_state_from_numpy,
    "state.make_state": state.make_state,
    "scenes.base_dam": scenes.base_dam,
    "scenes.unidyn_tank": scenes.unidyn_tank,
    "scenes.random_blob": scenes.random_blob,
    "convert.state_from_numpy": convert.state_from_numpy,
    "shard.make_mesh": make_mesh,
    "io.checkpoint.load": checkpoint.load,
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    fn = ENTRY_POINTS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_no_card_raises_instead_of_running_on_the_cpu():
    cfg = stam.StamConfig(n=4)
    calls = [lambda: stam.make_grid3d(cfg).u,
             lambda: stam.make_grid2d(cfg).u,
             lambda: mac.make_mac3d(cfg).u,
             lambda: grid_convert.state_from_numpy(
                 {f: np.zeros((6, 6)) for f in grid_convert.FIELDS2D}).u,
             lambda: scenes.random_blob(20, seed=0).pos,
             lambda: state.make_state(np.zeros((2, 3), np.float32)).pos]
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
            continue
        with pytest.raises((AssertionError, RuntimeError)):
            call()


def test_checkpoint_load_without_a_device_goes_to_the_card(tmp_path):
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, scenes.random_blob(10, seed=0, device="cpu"))
    if torch.cuda.is_available():
        assert checkpoint.load(path)[0].pos.device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError)):
        checkpoint.load(path)


def test_cli_without_cpu_runs_on_the_card(capsys):
    """Without --cpu every scene runs on the card; with none, it raises."""
    argv = ["base_dam", "--steps", "1", "--particles", "50"]
    if torch.cuda.is_available():
        assert cli.main(argv)["particles"] == 50
        return
    with pytest.raises((AssertionError, RuntimeError)):
        cli.main(argv)
    with pytest.raises((AssertionError, RuntimeError)):
        cli.main(["smoke2d", "--size", "8", "--steps", "1"])
