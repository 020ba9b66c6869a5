"""The SPH step and its step loop: ``tpufluids.step`` for the base
variant in PyTorch.

One step is the JAX package's row-block path (``step.py:183-226``):
``binning.sort_tables`` (the pool is never permuted), the force pass
``sph_kernels.base_forces_rowblock`` (the CUDA kernel on the card, its
plain version on the CPU), then the update and the step's metrics.
Nothing in a step synchronises the host with the device: the metrics
stay device tensors, so ``run_python`` enqueues steps back to back.

Configurations outside the ported slice raise ``NotImplementedError``
naming the ROADMAP.md item that will port them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpufluids_torch import binning, sph_kernels
from tpufluids_torch.config import SPHConfig
from tpufluids_torch.forces import ForceAccum
from tpufluids_torch.integrate import update
from tpufluids_torch.state import ParticleState


class StepMetrics(NamedTuple):
    """Per-step diagnostics, as 0-dim device tensors."""
    n_alive: torch.Tensor
    max_speed: torch.Tensor
    total_mass: torch.Tensor
    dens_residual: torch.Tensor   # max |dens - rho0| / rho0 over fluid
    bin_overflow: torch.Tensor
    n_split: torch.Tensor


# the JAX package's "auto" crossover between the row-block and the
# column kernel family (pool rows)
ROWBLOCK_MAX_POOL = 262144


def resolve_kernel_family(cfg: SPHConfig, capacity: int) -> str:
    """Resolve cfg.pallas_kernel ("auto" picks by static pool size)."""
    if cfg.pallas_kernel == "auto":
        return "rowblock" if capacity <= ROWBLOCK_MAX_POOL else "column"
    return cfg.pallas_kernel


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to tpufluids_torch yet (ROADMAP.md {item})")


def _check_slice(cfg: SPHConfig, capacity: int, subbin_parity):
    """Raise for a configuration outside the ported base slice."""
    unidyn = "Queue 1 item 4"
    if cfg.variant != "base":
        raise _not_ported(f"variant={cfg.variant!r}", unidyn)
    if cfg.sort_every > 1:
        raise _not_ported("sort_every > 1", unidyn)
    if (cfg.subbin_parity if subbin_parity is None else subbin_parity):
        raise _not_ported("subbin_parity=True", unidyn)
    family = resolve_kernel_family(cfg, capacity)
    if family != "rowblock":
        raise _not_ported(
            f"the {family!r} kernel family (pallas_kernel="
            f"{cfg.pallas_kernel!r}, {capacity} rows)",
            "Queue 2, kernel #13 base_forces_pallas")


def sph_step(state: ParticleState, cfg: SPHConfig, subbin_parity=None
             ) -> tuple[ParticleState, StepMetrics]:
    """One physics step; returns the new state and its metrics."""
    _check_slice(cfg, state.capacity, subbin_parity)
    order, bt = binning.sort_tables(state, cfg)
    sum_w, dpress, overflow = sph_kernels.base_forces_rowblock(
        state, bt, cfg, order)
    return _finish_step(state, ForceAccum(sum_w, dpress), overflow, cfg)


def _finish_step(state: ParticleState, acc: ForceAccum, overflow,
                 cfg: SPHConfig):
    """Update and per-step metrics (the base branch of the JAX
    package's ``_finish_step``)."""
    state = update(state, acc, cfg)
    fluid_alive = state.alive & (~state.boundary)
    metrics = StepMetrics(
        # adapt.count_alive in the JAX package: the alive-mask sum
        n_alive=torch.sum(state.alive.to(torch.int32)),
        max_speed=torch.max(torch.where(
            fluid_alive, torch.linalg.vector_norm(state.vel, dim=-1), 0.0)),
        total_mass=torch.sum(torch.where(state.alive, state.mass, 0.0)),
        dens_residual=torch.max(torch.where(
            fluid_alive, torch.abs(state.dens - cfg.rho0) / cfg.rho0, 0.0)),
        bin_overflow=overflow,
        n_split=torch.sum(state.split.to(torch.int32)),
    )
    return state, metrics


def run_python(state: ParticleState, cfg: SPHConfig, n_steps: int,
               subbin_parity=None):
    """``n_steps`` steps, one ``sph_step`` call each, with no host sync;
    returns (state, last-step metrics).  The JAX package's tunnel fence
    (``FENCE_EVERY``) has no counterpart here."""
    metrics = None
    for _ in range(n_steps):
        state, metrics = sph_step(state, cfg, subbin_parity)
    return state, metrics
