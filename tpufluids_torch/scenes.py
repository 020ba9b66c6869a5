"""Scene presets: the particle seeding of ``tpufluids.scenes``.  The
arrays are made with numpy exactly as the JAX package makes them, so
both packages start from identical states."""

from __future__ import annotations

import numpy as np
import torch

from tpufluids_torch.config import BASE_CONFIG, UNIDYN_CONFIG, SPHConfig
from tpufluids_torch.state import ParticleState, make_state


def base_dam(cfg: SPHConfig = BASE_CONFIG, n: int = 8000, nb: int = 0,
             capacity=None, device="cpu") -> ParticleState:
    """The base variant's scene: a fluid column seeded on a 15x15
    lattice (solver.cu:17-19, 115-121), with no floor.

    ``nb``: optional boundary particles on a 30-wide lattice plane at
    z = -0.24, spacing 0.06 (solver.cu:122-128), inert in the shipped
    scene."""
    j = np.arange(n)
    pos = np.stack(
        [
            -0.16 + 0.04 * ((j // 15) % 15),
            -0.76 + 0.04 * (j // 15 // 15),
            -0.20 + 0.04 * (j % 15),
        ],
        axis=1,
    ).astype(np.float32)
    if nb:
        i = np.arange(nb)
        bpos = np.stack(
            [-0.96 + 0.06 * (i % 30), -0.96 + 0.06 * (i // 30),
             np.full_like(i, -0.24, dtype=float)], axis=1
        ).astype(np.float32)
        boundary = np.concatenate([np.zeros(n, bool), np.ones(nb, bool)])
        return make_state(np.concatenate([pos, bpos], axis=0),
                          boundary=boundary, cfg=cfg, capacity=capacity,
                          device=device)
    return make_state(pos, cfg=cfg, capacity=capacity, device=device)


def unidyn_tank(cfg: SPHConfig = UNIDYN_CONFIG, nf: int = 10000,
                nb: int = 4040, capacity=None, device="cpu") -> ParticleState:
    """The unidyn scene: a 30x30-lattice fluid block above a tank made of
    a floor plane plus four wall planes of boundary particles, all with
    sand phase (solid=1, fluid=0) (solver-unidyn.cu:21-23, 127-184)."""
    j = np.arange(nf)
    fluid_pos = np.stack(
        [
            -0.76 + 0.05 * ((j // 30) % 30),
            -0.76 + 0.05 * (j % 30),
            -0.40 + 0.05 * (j // 30 // 30),
        ],
        axis=1,
    )
    i = np.arange(nb // 2)  # floor at z = -0.7 (solver-unidyn.cu:139-149)
    planes = [np.stack([-0.96 + 0.04 * (i % 45), -0.96 + 0.04 * (i // 45),
                        np.full_like(i, -0.7, dtype=float)], axis=1)]
    i = np.arange(nb // 8)
    along, up = -0.96 + 0.04 * (i % 45), -0.74 + 0.04 * (i // 45)
    for axis, at in ((1, -0.96), (1, 0.84), (0, -0.96), (0, 0.76)):
        # walls y = -0.96, y = 0.84, x = -0.96, x = 0.76 (:151-184)
        fixed = np.full_like(i, at, dtype=float)
        xy = (along, fixed) if axis == 1 else (fixed, along)
        planes.append(np.stack([*xy, up], axis=1))
    bnd_pos = np.concatenate(planes, axis=0)

    pos = np.concatenate([fluid_pos, bnd_pos], axis=0).astype(np.float32)
    boundary = np.concatenate(
        [np.zeros(nf, bool), np.ones(bnd_pos.shape[0], bool)])
    solid = np.concatenate(
        [np.zeros(nf), np.ones(bnd_pos.shape[0])]).astype(np.float32)
    return make_state(pos, boundary=boundary, solid=solid, cfg=cfg,
                      capacity=capacity, device=device)


def random_blob(n: int, seed: int = 0, cfg: SPHConfig = BASE_CONFIG,
                span: float = 0.3, boundary_frac: float = 0.0,
                capacity=None, device="cpu") -> ParticleState:
    """Small random cluster for tests: particles dense enough to
    interact."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-span, span, size=(n, 3)).astype(np.float32)
    vel = rng.normal(0.0, 0.5, size=(n, 3)).astype(np.float32)
    boundary = rng.uniform(size=n) < boundary_frac
    return make_state(pos, vel, boundary=boundary, cfg=cfg,
                      capacity=capacity, device=device)


def mixed_phase(st: ParticleState, seed: int) -> ParticleState:
    """``st`` with mixed phases for checking the unidyn force pass: solid
    in (0, 1) with some pure-fluid rows, fluid = 1 - solid, and seeded
    stress, delpress, vel, dens and press; boundary rows stay pure sand.
    On the pure tank the drift, velocity gradient, stress acceleration
    and mixture terms are exactly 0."""
    n = st.capacity
    rng = np.random.default_rng(seed)
    solid = rng.uniform(0.0, 1.0, n)
    solid[rng.uniform(size=n) < 0.3] = 0.0
    solid[st.boundary.cpu().numpy()] = 1.0

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(st.pos.device)

    return st.replace(solid=t(solid), fluid=t(1.0 - solid),
                      stress=t(rng.normal(0.0, 1e-4, (n, 3, 3))),
                      delpress=t(rng.normal(0.0, 1e-3, (n, 3))),
                      vel=t(rng.normal(0.0, 0.5, (n, 3))),
                      dens=t(rng.uniform(9300.0, 9900.0, n)),
                      press=t(rng.normal(0.0, 3e4, n)))
