"""Carry grid state and configuration between the JAX package and the
port without importing JAX: the state crosses as numpy arrays, the
configuration as the dict of ``dataclasses.asdict``.  A state is 2D or
3D by the rank of its fields; a MAC state (``grid.mac.MacState3D``) has
its own pair of functions."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpufluids_torch.grid.mac import MacState3D
from tpufluids_torch.grid.stam import GridState2D, GridState3D, StamConfig

FIELDS = tuple(f.name for f in dataclasses.fields(GridState3D))
FIELDS2D = tuple(f.name for f in dataclasses.fields(GridState2D))
MAC_FIELDS = tuple(f.name for f in dataclasses.fields(MacState3D))


def _tensors(fields: dict, names, device):
    missing = set(names) - set(fields)
    if missing:
        raise ValueError(f"missing fields: {sorted(missing)}")
    return {f: torch.tensor(np.asarray(fields[f], np.float32), device=device)
            for f in names}


def state_from_numpy(fields: dict, device="cuda"):
    """A GridState3D, or a GridState2D when ``fields["u"]`` is 2D,
    holding float32 copies of ``fields`` (one array per name in FIELDS or
    FIELDS2D) on ``device``."""
    flat = "u" in fields and np.ndim(fields["u"]) == 2
    cls, names = (GridState2D, FIELDS2D) if flat else (GridState3D, FIELDS)
    return cls(**_tensors(fields, names, device))


def slab_state_from_numpy(fields: dict, rank: int, world: int,
                          device="cuda") -> GridState3D:
    """Rank ``rank``'s x-slab of a world of ``world`` ranks, in the
    sharded layout of ``tpufluids_torch.shard``: rows rank c + 1 .. (rank
    + 1) c of the dense ghosted (n+2)^3 arrays ``fields`` (c = n / world),
    float32 on ``device``."""
    n = np.shape(fields["u"])[0] - 2
    if world < 1 or not 0 <= rank < world or n % world:
        raise ValueError(f"rank {rank} of {world} cannot hold a slab of "
                         f"n={n}")
    c = n // world
    rows = slice(1 + rank * c, 1 + (rank + 1) * c)
    return GridState3D(**_tensors(
        {f: np.asarray(fields[f])[rows] for f in FIELDS}, FIELDS, device))


def state_to_numpy(state) -> dict:
    return {f.name: getattr(state, f.name).cpu().numpy()
            for f in dataclasses.fields(state)}


def mac_state_from_numpy(fields: dict, device="cuda") -> MacState3D:
    """A MacState3D holding float32 copies of ``fields`` (the face arrays
    u, v, w and the cell arrays dens, temp of the JAX package's
    MacState3D) on ``device``."""
    return MacState3D(**_tensors(fields, MAC_FIELDS, device))


# a MacState3D's fields go out as any state's
mac_state_to_numpy = state_to_numpy


def config_from_dict(d: dict) -> StamConfig:
    """StamConfig from the ``dataclasses.asdict`` of the JAX package's
    StamConfig; unknown keys raise."""
    names = {f.name for f in dataclasses.fields(StamConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown StamConfig fields: {sorted(unknown)}")
    return StamConfig(**d)
