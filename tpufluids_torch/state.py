"""Particle state as a structure of tensors: ``tpufluids.state`` in
PyTorch.  The same 15 fields, shapes and dtypes, on any device."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tpufluids_torch.config import SPHConfig


@dataclasses.dataclass
class ParticleState:
    """Particle pool of static capacity N; ``alive`` marks the used rows
    (the pool is padded with dead rows up to its capacity)."""

    pos: torch.Tensor        # (N, 3) f32
    vel: torch.Tensor        # (N, 3) f32
    acc: torch.Tensor        # (N, 3) f32, acceleration of the previous step
    mass: torch.Tensor       # (N,)  f32
    dens: torch.Tensor       # (N,)  f32
    press: torch.Tensor      # (N,)  f32
    delpress: torch.Tensor   # (N, 3) f32, previous step's pressure gradient
    diffusion: torch.Tensor  # (N, 3) f32
    solid: torch.Tensor      # (N,)  f32, solid volume fraction (unidyn)
    fluid: torch.Tensor      # (N,)  f32, fluid volume fraction (unidyn)
    stress: torch.Tensor     # (N, 3, 3) f32
    boundary: torch.Tensor   # (N,)  bool
    alive: torch.Tensor      # (N,)  bool
    split: torch.Tensor      # (N,)  bool
    pid: torch.Tensor        # (N,)  i32, stable particle id

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    def replace(self, **kw) -> "ParticleState":
        return dataclasses.replace(self, **kw)


FIELDS = tuple(f.name for f in dataclasses.fields(ParticleState))


def make_state(pos, vel=None, *, boundary=None, solid=None, fluid=None,
               mass=None, cfg: Optional[SPHConfig] = None,
               capacity: Optional[int] = None, rho0: float = 9550.0,
               gravity: float = -9.8, device="cpu") -> ParticleState:
    """A ParticleState from seed arrays (numpy or tensors), padded with
    dead rows to ``capacity``; as ``tpufluids.state.make_state``.

    Fluid particles start with acc = (0, 0, gravity), boundary particles
    with zero acceleration (FluidGPU.cuh:88-110); density rho0, mass 1,
    zero pressure.  Padding rows are dead, with pid -1."""
    if cfg is not None:
        rho0, gravity = cfg.rho0, cfg.gravity
    pos = np.asarray(pos, np.float32)
    n = pos.shape[0]
    cap = capacity or n
    vel = (np.zeros((n, 3), np.float32) if vel is None
           else np.asarray(vel, np.float32))
    boundary = (np.zeros(n, bool) if boundary is None
                else np.asarray(boundary, bool))
    solid = (np.zeros(n, np.float32) if solid is None
             else np.asarray(solid, np.float32))
    fluid = (1.0 - solid if fluid is None
             else np.asarray(fluid, np.float32))
    mass = (np.ones(n, np.float32) if mass is None
            else np.asarray(mass, np.float32))
    acc = np.where(boundary[:, None], np.float32(0.0),
                   np.array([0.0, 0.0, gravity], np.float32))

    def pad(a, fill=0):
        a = np.asarray(a)
        width = [(0, cap - n)] + [(0, 0)] * (a.ndim - 1)
        return torch.from_numpy(
            np.pad(a, width, constant_values=fill)).to(device)

    return ParticleState(
        pos=pad(pos),
        vel=pad(vel),
        acc=pad(acc.astype(np.float32)),
        mass=pad(mass),
        dens=pad(np.full(n, rho0, np.float32)),
        press=pad(np.zeros(n, np.float32)),
        delpress=pad(np.zeros((n, 3), np.float32)),
        diffusion=pad(np.zeros((n, 3), np.float32)),
        solid=pad(solid),
        fluid=pad(fluid.astype(np.float32)),
        stress=pad(np.zeros((n, 3, 3), np.float32)),
        boundary=pad(boundary, fill=False),
        alive=pad(np.ones(n, bool), fill=False),
        split=pad(np.zeros(n, bool), fill=False),
        pid=pad(np.arange(n, dtype=np.int32), fill=-1),
    )
