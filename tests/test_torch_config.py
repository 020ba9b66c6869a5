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
