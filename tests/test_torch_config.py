"""The port's StamConfig mirrors the JAX package's, field for field."""

import dataclasses

import pytest

from tpufluids.grid import stam as jstam
from tpufluids_torch.grid import convert
from tpufluids_torch.grid import stam as tstam


def _defaults(cls):
    return {f.name: f.default for f in dataclasses.fields(cls)}


def test_stam_config_fields_and_defaults_match():
    assert _defaults(tstam.StamConfig) == _defaults(jstam.StamConfig)
    assert ([f.name for f in dataclasses.fields(tstam.StamConfig)]
            == [f.name for f in dataclasses.fields(jstam.StamConfig)])


def test_config_from_dict_round_trips_and_rejects_unknown_fields():
    jcfg = jstam.StamConfig(n=32, dt=0.5 / 32, projection="dct",
                            advect_mode="stencil", vorticity_eps=2.0,
                            dct_precision_first="default")
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.replace(n=16).n == 16 and tcfg.n == 32
    with pytest.raises(ValueError, match="bogus"):
        convert.config_from_dict({**dataclasses.asdict(jcfg), "bogus": 1})


def test_jacobi_and_diffusion_config_round_trips():
    """BASELINE config 4 (bench.py:324-329): the Jacobi projection with
    red-black sweeps and every diffusion on."""
    jcfg = jstam.StamConfig(n=64, dt=0.05, diff=1e-5, visc=1e-5,
                            temp_diff=2e-5, jacobi_iters=20, red_black=True,
                            advect_mode="stencil", projection="jacobi",
                            buoyancy_alpha=0.05, buoyancy_beta=1.0,
                            vorticity_eps=2.0)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
