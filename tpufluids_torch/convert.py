"""Carry particle state and the SPH configuration between the JAX package
and the port without importing JAX: the state crosses as a dict of
numpy arrays (one per ParticleState field), the configuration as the
dict of ``dataclasses.asdict``.  The counterpart of ``grid/convert.py``
for particles."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpufluids_torch.config import SPHConfig
from tpufluids_torch.state import FIELDS, ParticleState


def _check_keys(d: dict, names, what: str):
    unknown = set(d) - set(names)
    if unknown:
        raise ValueError(f"unknown {what} fields: {sorted(unknown)}")


def state_from_numpy(fields: dict, device="cuda") -> ParticleState:
    """A ParticleState holding copies of ``fields`` (every name in
    state.FIELDS, and no other) on ``device``, with the JAX package's
    dtypes: bool for the flags, int32 for pid, float32 for the rest."""
    _check_keys(fields, FIELDS, "ParticleState")
    missing = set(FIELDS) - set(fields)
    if missing:
        raise ValueError(f"missing fields: {sorted(missing)}")

    def dtype(name):
        if name in ("boundary", "alive", "split"):
            return bool
        return np.int32 if name == "pid" else np.float32

    return ParticleState(**{
        f: torch.from_numpy(np.array(fields[f], dtype(f))).to(device)
        for f in FIELDS})


def state_to_numpy(state: ParticleState) -> dict:
    return {f: getattr(state, f).cpu().numpy() for f in FIELDS}


def config_from_dict(d: dict) -> SPHConfig:
    """SPHConfig from the ``dataclasses.asdict`` of the JAX package's
    SPHConfig; unknown keys raise."""
    _check_keys(d, (f.name for f in dataclasses.fields(SPHConfig)),
                "SPHConfig")
    return SPHConfig(**d)
