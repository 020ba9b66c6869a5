"""Pair-force accumulation of the base variant: the plain PyTorch force
pass, ``tpufluids.forces.compute_forces`` (base branch) in PyTorch.

Per home particle i, over its 27-cell stencil (FluidGPU.cu:224-281):

* ``sum_w  = sum_j W(r_ij) (1 + nb_bnd * BDENSFACTOR)``
* ``dpress = sum_j (p_j/rho_j^2 + p_i/rho_i^2 + s_ij) dW_spiky(r)/r r_ij``

with ``s`` the inline Monaghan viscosity, quadratic term included
(FluidGPU.cu:255), ``nb_bnd`` = (i fluid, j boundary), and pairs with
0 < r <= 2h.  Each particle gathers and sums its own candidates, so the
result is deterministic (the reference scatter-adds with atomics).

The pool is never permuted.  ``pack_rows`` gathers the fields the pair
pass reads into sorted order with one row gather; the sums come back
to pool order through the permutation.  The candidates are the 9
uncapped neighbour runs of ``binning.run_table``, padded to the longest
run present (reading that length is this plain path's one host sync),
and the home rows go in chunks so a 262144-particle pool fits in
memory.  The CUDA kernel of ``tpufluids_torch.sph_kernels`` computes
the same sums on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpufluids_torch.binning import BinTable, run_table
from tpufluids_torch.config import SPHConfig
from tpufluids_torch.kernels import grad_w_spiky, w_cubic
from tpufluids_torch.state import ParticleState

# packed row: pos 0:3, vel 3:6, dens 6, press 7, boundary 8, alive 9 (as
# 0/1, and 0 outside the domain), then zeros to 12 columns, so that a
# row is three 16-byte loads for the CUDA kernel
ROW_WIDTH = 12
_X, _V, _DENS, _PRESS, _BND, _ALIVE = 0, 3, 6, 7, 8, 9
# candidate slots per chunk of home rows in the plain pass
CHUNK_SLOTS = 1 << 21


class ForceAccum(NamedTuple):
    """Per-step accumulators of the base variant (the reference's
    ``newdens`` / ``newdelpress``), in pool order.  The unidyn extras of
    ``tpufluids.forces.ForceAccum`` come with that variant (ROADMAP.md
    Queue 1 item 4)."""
    sum_w: torch.Tensor    # (N,)
    dpress: torch.Tensor   # (N, 3)


def pack_rows(state: ParticleState, order: torch.Tensor,
              in_dom: torch.Tensor) -> torch.Tensor:
    """(N, ROW_WIDTH) float32 rows in sorted order, one gather by
    ``order`` (``in_dom`` is sorted too), as the JAX package's
    ``_pack_base_by_order`` without its 128-lane padding."""
    f32 = torch.float32
    n = state.capacity
    cols = torch.cat([
        state.pos, state.vel, state.dens[:, None], state.press[:, None],
        state.boundary.to(f32)[:, None], state.alive.to(f32)[:, None],
        torch.zeros((n, ROW_WIDTH - 10), dtype=f32, device=state.pos.device),
    ], dim=1)
    rows = cols[order]
    rows[:, _ALIVE] *= in_dom
    return rows


def to_pool(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Sorted rows back to pool order: out[order[i]] = x[i]."""
    return torch.empty_like(x).index_copy_(0, order, x)


def _chunk_sums(home, cand, valid, cfg: SPHConfig):
    """sum_w (c,) and dpress (c, 3) of c home rows over their M
    candidates: home (c, ROW_WIDTH), cand (c, M, ROW_WIDTH), valid (c, M).
    The operations of ``tpufluids.forces.compute_forces`` (base)."""
    h = cfg.cutoff
    rab = home[:, None, _X:_X + 3] - cand[..., _X:_X + 3]
    ds = torch.sqrt(torch.sum(rab * rab, dim=-1))
    # ds > 0 excludes self and exact-coincident pairs (FluidGPU.cu:236)
    mask = valid & (cand[..., _ALIVE] > 0.5) & (ds > 0) & (ds <= 2 * h)
    ds = torch.where(ds > 0, ds, 1.0)
    vab = home[:, None, _V:_V + 3] - cand[..., _V:_V + 3]
    w = w_cubic(ds, h)
    dk = (grad_w_spiky(ds, h) / ds)[..., None] * rab

    di, pi = home[:, None, _DENS], home[:, None, _PRESS]
    dj, pj = cand[..., _DENS], cand[..., _PRESS]
    nb_bnd = (home[:, None, _BND] < 0.5) & (cand[..., _BND] > 0.5)
    d = torch.sum(vab * rab, dim=-1)
    mu = h * (d / (ds * ds + 0.01 * h * h))
    rho_bar = (di + dj) / 2.0
    # inline viscosity of the base force kernel (FluidGPU.cu:255)
    s = (cfg.alpha_fluid * cfg.sound
         * (mu + cfg.visc_quadratic / cfg.sound * mu * mu) / rho_bar
         * (d < 0) * (1.0 + nb_bnd * cfg.alpha_boundary))
    p_term = pj / (dj * dj) + pi / (di * di) + s
    sum_w = torch.where(mask, w * (1.0 + nb_bnd * cfg.bdensfactor),
                        0.0).sum(dim=1)
    dpress = torch.where(mask[..., None], p_term[..., None] * dk,
                         0.0).sum(dim=1)
    return sum_w, dpress


def pair_sums(rows: torch.Tensor, bt: BinTable, cfg: SPHConfig):
    """(sum_w (N,), dpress (N, 3)) of the sorted ``rows`` (pack_rows),
    over the uncapped 27-cell stencil runs; rows outside the domain get
    zeros."""
    n = rows.shape[0]
    run_start, run_len = run_table(bt, cfg)
    k = int(run_len.max()) if n else 0       # the plain path's host sync
    sum_w = rows.new_zeros(n)
    dpress = rows.new_zeros((n, 3))
    if k == 0:
        return sum_w, dpress
    slot = torch.arange(k, device=rows.device)
    step = max(1, CHUNK_SLOTS // (9 * k))
    for a in range(0, n, step):
        b = min(n, a + step)
        idx = run_start[a:b, :, None] + slot                   # (c, 9, k)
        valid = slot < run_len[a:b, :, None]
        idx = torch.clamp(idx, 0, n - 1).reshape(b - a, -1)
        sum_w[a:b], dpress[a:b] = _chunk_sums(
            rows[a:b], rows[idx], valid.reshape(b - a, -1), cfg)
    return sum_w, dpress


def compute_forces(state: ParticleState, bt: BinTable,
                   cfg: SPHConfig) -> ForceAccum:
    """The base-variant pair pass in plain PyTorch, on any device:
    ``state`` in pool order, ``bt`` from ``binning.sort_tables``;
    returns the sums in pool order."""
    if cfg.variant != "base":
        raise NotImplementedError(
            "the unidyn force pass is not ported to tpufluids_torch yet "
            "(ROADMAP.md Queue 1 item 4)")
    rows = pack_rows(state, bt.order, bt.in_dom)
    sum_w, dpress = pair_sums(rows, bt, cfg)
    return ForceAccum(to_pool(sum_w, bt.order), to_pool(dpress, bt.order))
