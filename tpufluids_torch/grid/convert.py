"""Carry grid state and configuration between the JAX package and the
port without importing JAX: the state crosses as numpy arrays, the
configuration as the dict of ``dataclasses.asdict``."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpufluids_torch.grid.stam import GridState3D, StamConfig

FIELDS = tuple(f.name for f in dataclasses.fields(GridState3D))


def state_from_numpy(fields: dict, device="cuda") -> GridState3D:
    """A GridState3D holding float32 copies of ``fields`` (one (n+2)^3
    array per name in FIELDS) on ``device``."""
    missing = set(FIELDS) - set(fields)
    if missing:
        raise ValueError(f"missing fields: {sorted(missing)}")
    return GridState3D(**{
        f: torch.tensor(np.asarray(fields[f], np.float32), device=device)
        for f in FIELDS})


def state_to_numpy(state: GridState3D) -> dict:
    return {f: getattr(state, f).cpu().numpy() for f in FIELDS}


def config_from_dict(d: dict) -> StamConfig:
    """StamConfig from the ``dataclasses.asdict`` of the JAX package's
    StamConfig; unknown keys raise."""
    names = {f.name for f in dataclasses.fields(StamConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown StamConfig fields: {sorted(unknown)}")
    return StamConfig(**d)
