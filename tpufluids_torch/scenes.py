"""Scene presets: the particle seeding of ``tpufluids.scenes`` for the
base variant.  The arrays are made with numpy exactly as the JAX
package makes them, so both packages start from identical states."""

from __future__ import annotations

import numpy as np

from tpufluids_torch.config import BASE_CONFIG, SPHConfig
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
