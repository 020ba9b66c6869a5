"""The SPH step and its step loop: ``tpufluids.step`` in PyTorch.

One step is the JAX package's Pallas path (``step.py:183-226``):
``binning.sort_tables`` (the pool is not permuted), the force pass
(the CUDA kernels of ``sph_kernels`` on the card, their plain versions
on the CPU), then, for the unidyn variant, the granular pass and the
split trigger, the merges, the update, the split re-injection, and the
step's metrics.  ``dispatch_forces`` picks the force kernel as the JAX
package's does: the row-block or column family of the base variant,
the resident, row-block or column family of the unidyn variant.  With
``sort_every`` k > 1 (base only), ``run_python`` sorts the pool into
cell order every k-th step and runs the steps between on the stale
tables (``sph_sort_step``, ``sph_step_stale``).  Nothing in a step
synchronises the host with the device: the metrics stay device
tensors, so ``run_python`` enqueues steps back to back.

The base variant with ``subbin_parity`` raises ``NotImplementedError``
naming the ROADMAP.md item that will port it.
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


def use_sort_every(cfg: SPHConfig, subbin_parity=None) -> bool:
    """Whether ``run_python`` runs the sort cadence (``sort_every > 1``),
    as the JAX package's ``use_sort_every``: the base variant on the
    kernels only.  The unidyn sub-bin and merge state lives in the tables
    and would go stale; the JAX package's XLA backend has no stale pass.
    The port's "auto" backend is the kernels (the plain versions on the
    CPU); the base variant with ``subbin_parity`` runs on none of them."""
    if cfg.sort_every <= 1:
        return False
    if cfg.variant != "base":
        raise ValueError("sort_every > 1 supports the base variant only "
                         "(unidyn sub-bin/merge state would go stale "
                         "between sorts)")
    if cfg.force_backend == "xla" or resolve_subbin(cfg, subbin_parity):
        raise ValueError("sort_every > 1 requires the Pallas force backend "
                         "(the port's kernels)")
    return True


def _check_slice(cfg: SPHConfig, subbin_parity):
    """Raise for a configuration outside the ported slice, or one that
    the JAX package refuses (``use_sort_every``)."""
    if cfg.variant == "base" and resolve_subbin(cfg, subbin_parity):
        raise _not_ported("the base variant with subbin_parity=True",
                          "Queue 1 item 4")
    use_sort_every(cfg, subbin_parity)


def dispatch_forces(state: ParticleState, bt: binning.BinTable,
                    cfg: SPHConfig, subbin_parity=None, stale=False):
    """The force pass of the JAX package's ``dispatch_forces``
    (``tpufluids/step.py:76-180``): the kernel family by
    ``resolve_kernel_family`` for the base variant (the row-block kernel,
    or the column kernel for "column" and "resident" alike), by
    ``resolve_unidyn_kernel`` for the unidyn variant.  ``state`` in pool
    order and ``bt`` from ``binning.sort_tables`` (or ``sort_by_cell``);
    ``stale``: ``bt`` is an earlier step's (base only).  Returns
    (ForceAccum, kernel overflow)."""
    order = bt.order
    if cfg.variant == "base":
        if resolve_kernel_family(cfg, state.capacity) == "rowblock":
            fn = sph_kernels.base_forces_rowblock
        else:
            fn = sph_kernels.base_forces_column
        sum_w, dpress, overflow = fn(state, bt, cfg, order, stale)
        return ForceAccum(sum_w, dpress), overflow
    threshold = (cfg.subbin_threshold if resolve_subbin(cfg, subbin_parity)
                 else None)
    fn = getattr(sph_kernels,
                 f"unidyn_forces_{resolve_unidyn_kernel(cfg, state.capacity)}")
    r = fn(state, bt, cfg, order, subbin_threshold=threshold)
    return accum_from_sums(state, r, cfg), r["overflow"]


def sph_step(state: ParticleState, cfg: SPHConfig, subbin_parity=None
             ) -> tuple[ParticleState, StepMetrics]:
    """One physics step; returns the new state and its metrics."""
    _check_slice(cfg, subbin_parity)
    _, bt = binning.sort_tables(state, cfg)
    acc, overflow = dispatch_forces(state, bt, cfg, subbin_parity)
    return _finish_step(state, acc, overflow, cfg)


def sph_step_stale(state: ParticleState, bt: binning.BinTable,
                   cfg: SPHConfig) -> tuple[ParticleState, StepMetrics]:
    """One step against the tables of the last sort (the sort cadence):
    the pool is still in that sort's order (``binning.sort_by_cell``), so
    the force kernels read it as it lies and mask every pair by the
    current cells; no sort, as the JAX package's ``sph_step_stale``."""
    acc, overflow = dispatch_forces(state, bt, cfg, stale=True)
    return _finish_step(state, acc, overflow, cfg)


def sph_sort_step(state: ParticleState, cfg: SPHConfig):
    """The cadence's sort step, as the JAX package's ``_jitted_sort_step``:
    the pool permuted into cell order, then one stale step on the fresh
    tables.  Returns (state, tables, metrics); ``sph_sort_step.calls``
    counts the calls."""
    state, bt = binning.sort_by_cell(state, cfg)
    state, metrics = sph_step_stale(state, bt, cfg)
    sph_sort_step.calls += 1
    return state, bt, metrics


sph_sort_step.calls = 0


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
    """``n_steps`` steps with no host sync; returns (state, last-step
    metrics).  With ``sort_every`` k > 1 (``use_sort_every``) every k-th
    step, the first included, is a sort step and the others are stale
    steps on its tables, as the JAX package's ``run_python`` runs them;
    otherwise every step is one ``sph_step`` call.  The JAX package's
    tunnel fence (``FENCE_EVERY``) has no counterpart here."""
    _check_slice(cfg, subbin_parity)
    metrics = None
    if use_sort_every(cfg, subbin_parity):
        bt = None
        for i in range(n_steps):
            if i % cfg.sort_every == 0:
                state, bt, metrics = sph_sort_step(state, cfg)
            else:
                state, metrics = sph_step_stale(state, bt, cfg)
        return state, metrics
    for _ in range(n_steps):
        state, metrics = sph_step(state, cfg, subbin_parity)
    return state, metrics
