"""Adaptive resolution: particle merge and split as masked pool ops,
``tpufluids.adapt`` in PyTorch.

* merge: mutual-nearest eligible pairs merge; the lower pid absorbs
  (mass ``merge_mass_new``, averaged pos and vel) and the higher pid
  dies (FluidGPU-unidyn.cu:261-275).
* split: flagged particles re-inject a child into a free (dead) slot
  with the mother's velocity and a y offset (the reference's latent
  host block, solver-unidyn.cu:495-542).

The JAX package scatters with ``.at[idx].set(..., mode="drop")`` and the
out-of-range index ``n``; on a CUDA tensor that index is a device-side
assert, so ``scatter_drop`` scatters into an ``n + 1``-row buffer and
drops its last row.  Nothing here synchronises the host.
"""

from __future__ import annotations

import torch

from tpufluids_torch.config import SPHConfig
from tpufluids_torch.state import FIELDS, ParticleState


def resolve_merges(state: ParticleState, partner_row: torch.Tensor,
                   pick_pid: torch.Tensor, cfg: SPHConfig) -> ParticleState:
    """Apply merge outcomes from each row's nearest eligible partner row
    (``partner_row``, -1 if none) and the pid each row picked
    (``pick_pid``): a pair merges iff the picks are mutual; the lower
    pid absorbs and the higher pid dies."""
    n = state.capacity
    pc = torch.clamp(partner_row, 0, n - 1)
    has = (partner_row >= 0) & (pick_pid >= 0)
    mutual = has & (pick_pid[pc] == state.pid) & (pick_pid != state.pid)
    absorber = mutual & (state.pid < pick_pid)
    victim = mutual & (state.pid > pick_pid)
    mass = torch.where(absorber, cfg.merge_mass_new, state.mass)
    return state.replace(
        pos=torch.where(absorber[:, None], (state.pos + state.pos[pc]) / 2.0,
                        state.pos),
        vel=torch.where(absorber[:, None], (state.vel + state.vel[pc]) / 2.0,
                        state.vel),
        mass=torch.where(victim, 0.0, mass),
        alive=state.alive & (~victim))


def apply_merges(state: ParticleState, merge_partner: torch.Tensor,
                 cfg: SPHConfig) -> ParticleState:
    """Merge every pair (i, j) in which each is the other's nearest
    eligible partner (``merge_partner``: pool rows, -1 if none)."""
    n = state.capacity
    pick_pid = torch.where(merge_partner >= 0,
                           state.pid[torch.clamp(merge_partner, 0, n - 1)], -1)
    return resolve_merges(state, merge_partner, pick_pid, cfg)


def scatter_drop(dst: torch.Tensor, idx: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    """``dst`` with ``dst[idx[i]] = src[i]`` for every ``idx[i] < n``
    (``src`` broadcast to the indexed rows); the rows with ``idx[i] == n``
    are dropped (JAX's ``mode="drop"``).  The indices below n are
    distinct."""
    n = dst.shape[0]
    out = torch.cat([dst, dst[:1]])
    out.index_put_((idx,), src)
    return out[:n]


def apply_splits(state: ParticleState, cfg: SPHConfig) -> ParticleState:
    """Re-inject children for split-flagged particles into dead slots.

    Mother: mass reset to 1, flag cleared (FluidGPU-unidyn.cu:279,
    solver-unidyn.cu:512).  Child: the mother's position with a y offset,
    her velocity, acceleration, density, pressure and fractions, mass 1,
    zero delpress, diffusion and stress (solver-unidyn.cu:507-531).  The
    k-th splitter takes the k-th free slot; splits beyond the free slots
    wait for a later step."""
    n = state.capacity
    i32 = torch.int32
    want = state.split & state.alive & (~state.boundary)
    free = ~state.alive
    want_rank = torch.cumsum(want.to(i32), 0, dtype=i32) - 1
    free_rank = torch.cumsum(free.to(i32), 0, dtype=i32) - 1
    served = want & (want_rank < torch.sum(free.to(i32)))
    rows = torch.arange(n, dtype=torch.int64, device=free.device)
    # slot_of_rank[r] = the r-th free slot
    slot_of_rank = scatter_drop(torch.full_like(rows, n),
                                 torch.where(free, free_rank.long(), n), rows)
    child = torch.where(served,
                        slot_of_rank[torch.clamp(want_rank.long(), 0, n - 1)],
                        n)
    dev = free.device
    offset = torch.zeros(3, dtype=state.pos.dtype, device=dev)
    offset[1] = cfg.split_child_y_offset      # a fill: no host-to-device copy
    zero = torch.zeros((), device=dev)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    yes = torch.ones((), dtype=torch.bool, device=dev)
    child_values = dict(
        pos=state.pos + offset, mass=torch.ones((), device=dev),
        delpress=zero, diffusion=zero, stress=zero, boundary=no, alive=yes,
        split=no, pid=state.pid + n)
    new = {f: scatter_drop(getattr(state, f), child,
                            child_values.get(f, getattr(state, f)))
           for f in FIELDS}
    new["mass"] = torch.where(served, 1.0, new["mass"])
    new["split"] = new["split"] & ~served
    return ParticleState(**new)


def count_alive(state: ParticleState) -> torch.Tensor:
    """The reference's ``count_after_merge`` compaction count
    (FluidGPU-unidyn.cu:554-562): the alive-mask sum."""
    return torch.sum(state.alive.to(torch.int32))
