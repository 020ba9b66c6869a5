"""Checkpoint / resume: ``tpufluids.io.checkpoint`` for the port's states.

The file is the JAX package's ``.npz``: ``arr_i`` for the i-th field in
dataclass field order (the JAX package's leaf order for its
``ParticleState``, ``GridState2D``, ``GridState3D`` and ``MacState3D``)
and ``meta``, uint8 JSON with ``step``, ``fields``, ``type``,
``config`` and ``extra``.  Either package loads the other's files with
equal arrays, dtypes and meta.  The write is atomic (a temporary file,
then ``os.replace``), and resume is bit for bit: load, then go on
stepping.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from tpufluids_torch.config import SPHConfig
from tpufluids_torch.state import ParticleState


def _fields(state) -> list:
    if not dataclasses.is_dataclass(state):
        raise TypeError(f"a checkpoint holds a state dataclass, not "
                        f"{type(state).__name__}")
    return [f.name for f in dataclasses.fields(state)]


def save(path: str, state, cfg: SPHConfig | None = None, step: int = 0,
         extra: dict | None = None) -> None:
    """Write a state dataclass of tensors (on any device) to ``path``
    (.npz)."""
    names = _fields(state)
    payload = {f"arr_{i}": getattr(state, name).detach().cpu().numpy()
               for i, name in enumerate(names)}
    meta = {
        "step": step,
        "fields": names,
        "type": type(state).__name__,
        "config": dataclasses.asdict(cfg) if cfg is not None else None,
        "extra": extra or {},
    }
    payload["meta"] = np.frombuffer(json.dumps(meta).encode(),
                                    dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load(path: str, template=None, device="cuda"):
    """Load a checkpoint onto ``device``; returns (state, meta).  With a
    ``template`` (any state dataclass of the port) the arrays fill its
    fields in order; otherwise the file must hold a ParticleState, which
    is rebuilt by field name."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        arrs = [torch.from_numpy(z[f"arr_{i}"]).to(device)
                for i in range(len(meta["fields"]))]
    if template is not None:
        names = _fields(template)
        if len(names) != len(arrs):
            raise ValueError(f"{path} holds {len(arrs)} arrays, "
                             f"{type(template).__name__} has {len(names)} "
                             f"fields")
        state = type(template)(**dict(zip(names, arrs)))
    elif meta["type"] == "ParticleState":
        state = ParticleState(**dict(zip(meta["fields"], arrs)))
    else:
        raise ValueError(
            f"cannot reconstruct {meta['type']} without a template")
    return state, meta


def load_config(path: str) -> SPHConfig:
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
    if meta["config"] is None:
        raise ValueError("checkpoint has no config")
    return SPHConfig(**meta["config"])
