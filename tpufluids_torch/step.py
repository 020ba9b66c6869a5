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
tables (``sph_sort_step``, ``sph_step_stale``).  ``run`` and
``run_chunk`` are the JAX package's drivers: per-step metrics stacked
along a leading axis, and ``run``'s snapshots at the JAX package's
cadence.

``use_kernels`` is the JAX package's ``use_pallas_forces``: the base
variant with ``subbin_parity`` and ``force_backend="xla"`` take the JAX
package's XLA pair path instead, in torch ops on either device, as the
JAX package computes it outside any Pallas kernel: the pool permuted
into cell order (``binning.sort_by_cell``), the pair passes of
``forces.compute_forces`` over neighbour runs clipped at
``3 * max_per_cell`` rows, whose dropped slots count in
``bin_overflow``.  Nothing in a kernel step synchronises the host with
the device: the metrics stay device tensors, so ``run_python`` enqueues
steps back to back (the XLA path reads its longest run once a step).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpufluids_torch import adapt, binning, sph_kernels
from tpufluids_torch.config import SPHConfig
from tpufluids_torch.forces import ForceAccum, accum_from_sums, compute_forces
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


def resolve_unidyn_kernel(cfg: SPHConfig, capacity: int,
                          hooked: bool = False) -> str:
    """"resident", "rowblock" or "column": the unidyn force kernel of the
    JAX package's ``dispatch_forces`` (``step.py:153-175``).  ``hooked``:
    a ``drift_fix`` hook goes between the passes (the sharded step), and
    the resident kernel, which runs them back to back, is never picked."""
    pad = max(128, cfg.pallas_w_chunk or 32)
    if (cfg.pallas_kernel in ("auto", "resident") and not hooked
            and (capacity + pad) * 128 * 4 <= RESIDENT_MAX_BYTES):
        return "resident"
    if resolve_kernel_family(cfg, capacity) == "rowblock":
        return "rowblock"
    return "column"


def use_kernels(cfg: SPHConfig, subbin_parity=None) -> bool:
    """Whether the force kernels (their plain versions on the CPU) take
    this configuration, as the JAX package's ``use_pallas_forces``
    (``tpufluids/step.py:63-73``): "auto" and "pallas" mean the kernels;
    ``force_backend="xla"`` and the base variant with sub-binning (not a
    reference combination) take the XLA pair path."""
    return cfg.force_backend != "xla" and not (
        cfg.variant == "base" and resolve_subbin(cfg, subbin_parity))


def use_sort_every(cfg: SPHConfig, subbin_parity=None) -> bool:
    """Whether ``run_python`` runs the sort cadence (``sort_every > 1``),
    as the JAX package's ``use_sort_every``: the base variant on the
    kernels only.  The unidyn sub-bin and merge state lives in the tables
    and would go stale; the XLA pair path has no stale pass."""
    if cfg.sort_every <= 1:
        return False
    if cfg.variant != "base":
        raise ValueError("sort_every > 1 supports the base variant only "
                         "(unidyn sub-bin/merge state would go stale "
                         "between sorts)")
    if not use_kernels(cfg, subbin_parity):
        raise ValueError("sort_every > 1 requires the Pallas force backend "
                         "(the port's kernels)")
    return True


def dispatch_forces(state: ParticleState, bt: binning.BinTable,
                    cfg: SPHConfig, subbin_parity=None, stale=False,
                    drift_fix=None):
    """The force pass of the JAX package's ``dispatch_forces``
    (``tpufluids/step.py:76-180``) on the grid of ``bt`` (the cube, or a
    rank's x-slab): off the kernels (``use_kernels``), the XLA pair path
    of ``forces.compute_forces`` over ``binning.clipped_runs``; else the
    kernel family by ``resolve_kernel_family`` for the base variant (the
    row-block kernel, or the column kernel for "column" and "resident"
    alike), by ``resolve_unidyn_kernel`` for the unidyn variant.
    ``state`` in pool order and ``bt`` from ``binning.sort_tables`` (or
    ``sort_by_cell``, which the XLA path needs for the base variant with
    sub-binning: its tables carry ``octant``); ``stale``: ``bt`` is an
    earlier step's (base only).  ``drift_fix`` (unidyn) maps pass A's
    drift velocities, in pool order, to those pass B reads.  Returns
    (ForceAccum, overflow: the clip's dropped slots or the kernel's)."""
    sp = resolve_subbin(cfg, subbin_parity)
    if not use_kernels(cfg, sp):
        start, length, overflow = binning.clipped_runs(bt, cfg)
        return compute_forces(state, bt, cfg, sp, cfg.subbin_threshold,
                              drift_fix, runs=(start, length)), overflow
    order = bt.order
    if cfg.variant == "base":
        if resolve_kernel_family(cfg, state.capacity) == "rowblock":
            fn = sph_kernels.base_forces_rowblock
        else:
            fn = sph_kernels.base_forces_column
        sum_w, dpress, overflow = fn(state, bt, cfg, order, stale)
        return ForceAccum(sum_w, dpress), overflow
    threshold = cfg.subbin_threshold if sp else None
    kernel = resolve_unidyn_kernel(cfg, state.capacity, drift_fix is not None)
    fn = getattr(sph_kernels, f"unidyn_forces_{kernel}")
    hook = {} if drift_fix is None else {"drift_fix": drift_fix}
    r = fn(state, bt, cfg, order, subbin_threshold=threshold, **hook)
    return accum_from_sums(state, r, cfg), r["overflow"]


def sort_for_forces(state: ParticleState, cfg: SPHConfig, subbin_parity=None,
                    grid=None):
    """(state, tables) for ``dispatch_forces``: on the kernels the pool as
    it is and ``binning.sort_tables``; on the XLA pair path the pool
    permuted into cell order by ``binning.sort_by_cell`` (with the
    sub-bin tables when sub-binning), as the JAX package's ``sph_step``
    takes them."""
    sp = resolve_subbin(cfg, subbin_parity)
    if use_kernels(cfg, sp):
        return state, binning.sort_tables(state, cfg, grid)[1]
    return binning.sort_by_cell(state, cfg, grid, subbin=sp)[:2]


def sph_step(state: ParticleState, cfg: SPHConfig, subbin_parity=None
             ) -> tuple[ParticleState, StepMetrics]:
    """One physics step; returns the new state and its metrics.  On the
    XLA pair path the state comes back in cell order, as the JAX
    package's does."""
    use_sort_every(cfg, subbin_parity)
    state, bt = sort_for_forces(state, cfg, subbin_parity)
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
    state, bt, _ = binning.sort_by_cell(state, cfg)
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


def _steps(state: ParticleState, cfg: SPHConfig, n_steps: int,
           subbin_parity=None):
    """Yield (step number from 1, state, metrics) of ``n_steps`` steps
    with no host sync.  With ``sort_every`` k > 1 (``use_sort_every``)
    every k-th step, the first included, is a sort step and the others
    are stale steps on its tables, as the JAX package's ``run_python``
    runs them; otherwise every step is one ``sph_step`` call."""
    if use_sort_every(cfg, subbin_parity):
        bt = None
        for i in range(n_steps):
            if i % cfg.sort_every == 0:
                state, bt, metrics = sph_sort_step(state, cfg)
            else:
                state, metrics = sph_step_stale(state, bt, cfg)
            yield i + 1, state, metrics
        return
    for i in range(n_steps):
        state, metrics = sph_step(state, cfg, subbin_parity)
        yield i + 1, state, metrics


def stack_metrics(metrics) -> StepMetrics:
    """A StepMetrics of (len(metrics),) tensors from 0-d per-step
    ones."""
    return StepMetrics(*(torch.stack(f) for f in zip(*metrics)))


def run_python(state: ParticleState, cfg: SPHConfig, n_steps: int,
               subbin_parity=None):
    """``n_steps`` steps with no host sync (``_steps``: the sort cadence
    with ``sort_every`` > 1); returns (state, last-step metrics).  The
    JAX package's tunnel fence (``FENCE_EVERY``) has no counterpart
    here."""
    metrics = None
    for _, state, metrics in _steps(state, cfg, n_steps, subbin_parity):
        pass
    return state, metrics


def run_chunk(state: ParticleState, cfg: SPHConfig, n_steps: int,
              subbin_parity=None):
    """``n_steps`` calls of ``sph_step`` with no host sync, as the JAX
    package's ``lax.scan`` chunk (no sort cadence); returns (state,
    StepMetrics of (n_steps,) tensors)."""
    metrics = []
    for _ in range(n_steps):
        state, m = sph_step(state, cfg, subbin_parity)
        metrics.append(m)
    return state, stack_metrics(metrics)


def run(state: ParticleState, cfg: SPHConfig, n_steps: int,
        snapshot_every: int = 0, snapshot_fn=None, subbin_parity=None):
    """Drive ``n_steps`` steps, as the JAX package's ``run``; returns
    (state, StepMetrics of (n_steps,) tensors, stacked once at the end).

    ``snapshot_fn(step, host_state)`` receives the state as CPU tensors,
    the only host sync the driver adds.  On the kernels (``use_kernels``) the steps
    go one at a time (``_steps``, the sort cadence included) and
    ``snapshot_fn`` runs after every step that is a multiple of
    ``snapshot_every``.  On the XLA pair path the steps go in
    ``run_chunk`` chunks of ``snapshot_every`` (all ``n_steps`` when it
    is 0) and ``snapshot_fn`` runs after every chunk, the last partial
    one included, as the JAX package's scan branch does."""
    snap = snapshot_fn is not None and snapshot_every > 0
    if use_kernels(cfg, subbin_parity):
        metrics = []
        for i, state, m in _steps(state, cfg, n_steps, subbin_parity):
            metrics.append(m)
            if snap and i % snapshot_every == 0:
                snapshot_fn(i, state.to("cpu"))
        return state, stack_metrics(metrics)
    use_sort_every(cfg, subbin_parity)
    chunk = snapshot_every if snapshot_every > 0 else n_steps
    chunks, done = [], 0
    while done < n_steps:
        this = min(chunk, n_steps - done)
        state, m = run_chunk(state, cfg, this, subbin_parity)
        chunks.append(m)
        done += this
        if snap:
            snapshot_fn(done, state.to("cpu"))
    return state, StepMetrics(*(torch.cat(f) for f in zip(*chunks)))
