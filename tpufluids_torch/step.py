"""The SPH step and its step loop: ``tpufluids.step`` in PyTorch.

One step is the JAX package's Pallas path (``step.py:183-226``):
``binning.sort_tables`` (the pool is never permuted), the force pass
(the CUDA kernels of ``sph_kernels`` on the card, their plain versions
on the CPU), then, for the unidyn variant, the granular pass and the
split trigger, the merges, the update, the split re-injection, and the
step's metrics.  The force pass is ``base_forces_rowblock`` for the base
variant, and ``unidyn_forces_resident`` or ``unidyn_forces_rowblock``
for the unidyn variant, chosen as the JAX package's
``dispatch_forces`` chooses.  Nothing in a step synchronises the host
with the device: the metrics stay device tensors, so ``run_python``
enqueues steps back to back.

Configurations outside the ported slice raise ``NotImplementedError``
naming the ROADMAP.md item that will port them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpufluids_torch import adapt, binning, sph_kernels
from tpufluids_torch.config import SPHConfig
from tpufluids_torch.forces import ForceAccum, accum_from_sums
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
# the JAX package's pool budget of its resident unidyn kernel: packed rows
# of 128 float32 lanes, padded by max(128, pallas_w_chunk) rows
RESIDENT_MAX_BYTES = 48 * 1024 * 1024


def resolve_kernel_family(cfg: SPHConfig, capacity: int) -> str:
    """Resolve cfg.pallas_kernel ("auto" picks by static pool size)."""
    if cfg.pallas_kernel == "auto":
        return "rowblock" if capacity <= ROWBLOCK_MAX_POOL else "column"
    return cfg.pallas_kernel


def resolve_subbin(cfg: SPHConfig, subbin_parity) -> bool:
    """Per-call override (bool) or the config default (None)."""
    return cfg.subbin_parity if subbin_parity is None else subbin_parity


def resolve_unidyn_kernel(cfg: SPHConfig, capacity: int) -> str:
    """"resident", "rowblock" or "column": the unidyn force kernel of the
    JAX package's ``dispatch_forces`` (``step.py:153-175``).  Its
    ``drift_fix`` hook, which sends the sharded step to the row-block
    kernel, comes with x-slab sharding (ROADMAP Queue 1 item 8)."""
    pad = max(128, cfg.pallas_w_chunk or 32)
    if (cfg.pallas_kernel in ("auto", "resident")
            and (capacity + pad) * 128 * 4 <= RESIDENT_MAX_BYTES):
        return "resident"
    if resolve_kernel_family(cfg, capacity) == "rowblock":
        return "rowblock"
    return "column"


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to tpufluids_torch yet (ROADMAP.md {item})")


def _check_slice(cfg: SPHConfig, capacity: int, subbin_parity):
    """Raise for a configuration outside the ported slice."""
    if cfg.sort_every > 1:
        raise _not_ported("sort_every > 1", "Queue 1 item 4")
    if cfg.variant == "base":
        if resolve_subbin(cfg, subbin_parity):
            raise _not_ported("the base variant with subbin_parity=True",
                              "Queue 1 item 4")
        family = resolve_kernel_family(cfg, capacity)
        if family != "rowblock":
            raise _not_ported(
                f"the {family!r} kernel family (pallas_kernel="
                f"{cfg.pallas_kernel!r}, {capacity} rows)",
                "Queue 2, kernel #13 base_forces_pallas")
    elif resolve_unidyn_kernel(cfg, capacity) == "column":
        raise _not_ported(
            f"the unidyn column kernel family (pallas_kernel="
            f"{cfg.pallas_kernel!r}, {capacity} rows)",
            "Queue 2, kernel #14 unidyn_forces_pallas")


def sph_step(state: ParticleState, cfg: SPHConfig, subbin_parity=None
             ) -> tuple[ParticleState, StepMetrics]:
    """One physics step; returns the new state and its metrics."""
    _check_slice(cfg, state.capacity, subbin_parity)
    order, bt = binning.sort_tables(state, cfg)
    if cfg.variant == "base":
        sum_w, dpress, overflow = sph_kernels.base_forces_rowblock(
            state, bt, cfg, order)
        return _finish_step(state, ForceAccum(sum_w, dpress), overflow, cfg)
    threshold = (cfg.subbin_threshold if resolve_subbin(cfg, subbin_parity)
                 else None)
    if resolve_unidyn_kernel(cfg, state.capacity) == "resident":
        r = sph_kernels.unidyn_forces_resident(
            state, bt, cfg, order, subbin_threshold=threshold)
    else:
        r = sph_kernels.unidyn_forces_rowblock(
            state, bt, cfg, order, subbin_threshold=threshold)
    return _finish_step(state, accum_from_sums(state, r, cfg),
                        r["overflow"], cfg)


def _finish_step(state: ParticleState, acc: ForceAccum, overflow,
                 cfg: SPHConfig):
    """Merges, update, splits and per-step metrics (the JAX package's
    ``_finish_step``)."""
    unidyn = cfg.variant != "base"
    if unidyn and cfg.merge_dist > 0:
        state = adapt.apply_merges(state, acc.merge_partner, cfg)
    state = update(state, acc, cfg)
    if unidyn and cfg.split_reinjection:
        state = adapt.apply_splits(state, cfg)
    fluid_alive = state.alive & (~state.boundary)
    metrics = StepMetrics(
        n_alive=adapt.count_alive(state),
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
