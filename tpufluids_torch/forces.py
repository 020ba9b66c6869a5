"""Pair-force accumulation: the plain PyTorch force passes,
``tpufluids.forces.compute_forces`` in PyTorch, for both variants.

Base variant, per home particle i over its 27-cell stencil
(FluidGPU.cu:224-281):

* ``sum_w  = sum_j W(r_ij) (1 + nb_bnd * BDENSFACTOR)``
* ``dpress = sum_j (p_j/rho_j^2 + p_i/rho_i^2 + s_ij) dW_spiky(r)/r r_ij``

with ``s`` the inline Monaghan viscosity, quadratic term included
(FluidGPU.cu:255), ``nb_bnd`` = (i fluid, j boundary), and pairs with
0 < r <= 2h.  Each particle gathers and sums its own candidates, so the
result is deterministic (the reference scatter-adds with atomics).

Unidyn variant (FluidGPU-unidyn.cu:249-446), in two passes over the
same pairs: pass A sums the mass-weighted density and pressure
gradient, the diffusion (colour) gradient, the mixfactor-gated
velocity gradient, the granular stress acceleration, the drift
velocities of both phases, the pair count and, with merging enabled,
the nearest eligible merge partner; pass B reads every candidate's
drift velocity from pass A and sums the mixture acceleration and the
phase transport rates.  Then the per-particle granular pass and the
split trigger (``accum_from_sums``) make the ``ForceAccum``.

The pool is never permuted.  ``pack_rows`` / ``pack_unidyn_rows``
gather the fields the pair passes read into sorted order with one row
gather; the sums come back to pool order through the permutation.  The
candidates are the 9 neighbour runs of ``binning.run_table`` (uncapped,
or capped for the column family; whole columns masked by current cells
for the stale passes), padded to the longest run present (reading that
length is this plain path's one host sync), and the home rows go in
chunks so a 524288-particle pool fits in memory.  The CUDA kernels of
``tpufluids_torch.sph_kernels`` compute the same sums on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from tpufluids_torch.binning import (RUN_OFFSETS, BinTable, cell_trunc,
                                     run_table)
from tpufluids_torch.config import SPHConfig
from tpufluids_torch.kernels import grad_w_spiky, w_cubic
from tpufluids_torch.state import ParticleState

# packed row: pos 0:3, vel 3:6, dens 6, press 7, boundary 8, alive 9 (as
# 0/1, and 0 outside the domain), press / dens^2 10 (the base kernels'
# per-row pressure term), then zeros to 12 columns, so that a row is
# three 16-byte loads for the CUDA kernels
ROW_WIDTH = 12
_X, _V, _DENS, _PRESS, _BND, _ALIVE = 0, 3, 6, 7, 8, 9
# candidate slots per chunk of home rows in the plain pass
CHUNK_SLOTS = 1 << 21


# unidyn row: the base columns 0:10, then mass 10, solid 11, fluid 12 and
# merge eligibility 13 (0/1; 0 with merging off), zeros to 16 columns:
# the 14 fields pass A reads of a candidate, as four 16-byte loads
UNIDYN_ROW_WIDTH = 16
_MASS, _SOLID, _FLUID, _ELIG = 10, 11, 12, 13
# pass-A sums, in sorted or pool order (the vel_grad and stress_accel
# sums before their division by dens and dens^2)
A_SUMW, A_DP, A_DIFF, A_VG, A_SA, A_SDV, A_FDV, A_CNT = (
    0, 1, 4, 7, 16, 19, 22, 25)
A_COLS = 26
# pass-B sums: mixture_accel 0:3, delsolid 3, delfluid 4
B_COLS = 5


class ForceAccum(NamedTuple):
    """Per-step accumulators (the reference's ``new*`` fields plus the
    unidyn extras), in pool order, as ``tpufluids.forces.ForceAccum``.
    The base variant fills ``sum_w`` and ``dpress`` only."""
    sum_w: torch.Tensor                             # (N,)
    dpress: torch.Tensor                            # (N, 3)
    diffusion: Optional[torch.Tensor] = None        # (N, 3)
    vel_grad: Optional[torch.Tensor] = None         # (N, 3, 3)
    stress_accel: Optional[torch.Tensor] = None     # (N, 3)
    solid_drift: Optional[torch.Tensor] = None      # (N, 3)
    fluid_drift: Optional[torch.Tensor] = None      # (N, 3)
    mixture_accel: Optional[torch.Tensor] = None    # (N, 3)
    delsolid: Optional[torch.Tensor] = None         # (N,)
    delfluid: Optional[torch.Tensor] = None         # (N,)
    stress_scaled: Optional[torch.Tensor] = None    # (N, 3, 3)
    stress_rate: Optional[torch.Tensor] = None      # (N, 3, 3)
    split_trigger: Optional[torch.Tensor] = None    # (N,) bool
    merge_partner: Optional[torch.Tensor] = None    # (N,) int64 pool row


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
        (state.press / (state.dens * state.dens))[:, None],
        torch.zeros((n, ROW_WIDTH - 11), dtype=f32, device=state.pos.device),
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


def near_cells(cells_i: torch.Tensor, cells_j: torch.Tensor) -> torch.Tensor:
    """The stale passes' pair mask: the current truncated cells
    (``binning.cell_trunc``) of home rows (c, 3) and their candidates
    (c, M, 3) differ by at most one on x, y and z."""
    return (torch.abs(cells_i[:, None, :] - cells_j) <= 1.0).all(dim=-1)


def column_shift(rows: torch.Tensor, bt: BinTable,
                 cfg: SPHConfig) -> torch.Tensor:
    """(g*g,) int32: for each (x, y) column of the stale tables ``bt``,
    the largest |current - stale| z-cell of its rows, capped at g (0 for
    an empty column).  Rows count that are in the column, alive in
    ``rows`` (pack_rows) and whose current z-cell (``cell_trunc``) is not
    NaN: a dead or NaN row keeps no pair.  The stale force kernels walk
    ``binning.stale_window`` of each column by it; their pack kernel
    computes it with integer atomicMax."""
    g = cfg.grid_size
    cid = bt.cid.to(torch.int64)
    cz = cell_trunc(rows[:, _X:_X + 3], cfg)[:, 2]
    d = torch.clamp(torch.abs(cz - (cid % g).to(cz.dtype)), max=float(g))
    keep = (cid < g ** 3) & (rows[:, _ALIVE] > 0.5) & ~torch.isnan(cz)
    d = torch.where(keep, d, 0.0).to(torch.int32)
    return torch.zeros(g * g, dtype=torch.int32, device=rows.device
                       ).scatter_reduce(0, torch.clamp(cid // g,
                                                       max=g * g - 1),
                                        d, "amax")


def pair_sums(rows: torch.Tensor, bt: BinTable, cfg: SPHConfig, caps=None,
              stale: bool = False):
    """(sum_w (N,), dpress (N, 3)) of the sorted ``rows`` (pack_rows),
    over the uncapped 27-cell stencil runs; rows outside the domain get
    zeros.  ``caps`` = (b, w_cap): the column family's capped pair set
    (``binning.run_table``).  ``stale``: ``bt`` was built on earlier
    positions; the candidates are the whole neighbour columns, masked by
    the rows' current cells (``near_cells``).  The kernels walk only each
    column's ``binning.stale_window`` (``column_shift``), which holds
    every candidate this mask keeps: this whole-column walk is the
    independent reference of their pair set."""
    n = rows.shape[0]
    run_start, run_len = run_table(bt, cfg, caps, whole=stale)
    k = int(run_len.max()) if n else 0       # the plain path's host sync
    sum_w = rows.new_zeros(n)
    dpress = rows.new_zeros((n, 3))
    if k == 0:
        return sum_w, dpress
    cells = cell_trunc(rows[:, _X:_X + 3], cfg) if stale else None
    slot = torch.arange(k, device=rows.device)
    step = max(1, CHUNK_SLOTS // (9 * k))
    for a in range(0, n, step):
        b = min(n, a + step)
        idx = run_start[a:b, :, None] + slot                   # (c, 9, k)
        valid = (slot < run_len[a:b, :, None]).reshape(b - a, -1)
        idx = torch.clamp(idx, 0, n - 1).reshape(b - a, -1)
        if stale:
            valid = valid & near_cells(cells[a:b], cells[idx])
        sum_w[a:b], dpress[a:b] = _chunk_sums(rows[a:b], rows[idx], valid,
                                              cfg)
    return sum_w, dpress


def merge_eligible(state: ParticleState, cfg: SPHConfig) -> torch.Tensor:
    """(N,) bool merge eligibility (FluidGPU-unidyn.cu:261), as the JAX
    package's: an alive fluid particle of mass in (0, 2) whose last
    diffusion is below ``merge_diffusion_max``."""
    prev_diff2 = torch.sum(state.diffusion * state.diffusion, dim=-1)
    return ((state.mass > 0) & (state.mass < 2) & (~state.boundary)
            & (prev_diff2 < cfg.merge_diffusion_max) & state.alive)


def pack_unidyn_rows(state: ParticleState, order: torch.Tensor,
                     in_dom: torch.Tensor, cfg: SPHConfig) -> torch.Tensor:
    """(N, UNIDYN_ROW_WIDTH) float32 rows in sorted order, one gather by
    ``order``: the fields pass A reads of a candidate.  The home-only
    fields (delpress, stress) are read in pool order instead."""
    f32 = torch.float32
    n = state.capacity
    elig = (merge_eligible(state, cfg).to(f32)[:, None] if cfg.merge_dist > 0
            else torch.zeros((n, 1), dtype=f32, device=state.pos.device))
    cols = torch.cat([
        state.pos, state.vel, state.dens[:, None], state.press[:, None],
        state.boundary.to(f32)[:, None], state.alive.to(f32)[:, None],
        state.mass[:, None], state.solid[:, None], state.fluid[:, None], elig,
        torch.zeros((n, UNIDYN_ROW_WIDTH - 14), dtype=f32,
                    device=state.pos.device),
    ], dim=1)
    rows = cols[order]
    rows[:, _ALIVE] *= in_dom
    return rows


def _pair_geometry(home, cand, valid, h: float):
    """Pair geometry of c home rows (c, W) and their candidates (c, M, W):
    (rab, vab, ds, mask, dkf, dk), with rab, vab and dk lists of three
    (c, M) components and ds made safe (1) where it is 0."""
    rab = [home[:, _X + a, None] - cand[..., _X + a] for a in range(3)]
    ds = torch.sqrt(rab[0] * rab[0] + rab[1] * rab[1] + rab[2] * rab[2])
    # ds > 0 excludes self and exact-coincident pairs (FluidGPU.cu:236)
    mask = valid & (cand[..., _ALIVE] > 0.5) & (ds > 0) & (ds <= 2 * h)
    ds = torch.where(ds > 0, ds, 1.0)
    vab = [home[:, _V + a, None] - cand[..., _V + a] for a in range(3)]
    dkf = grad_w_spiky(ds, h) / ds
    return rab, vab, ds, mask, dkf, [dkf * r for r in rab]


def _unidyn_a_chunk(home, hx, cand, valid, cfg: SPHConfig):
    """Pass-A sums (c, A_COLS) of c home rows (c, UNIDYN_ROW_WIDTH), with
    their delpress and stress (hx, (c, 12)), over their M candidates
    (c, M, UNIDYN_ROW_WIDTH) where ``valid`` (c, M); and the candidate
    slot of the nearest merge partner (c,), -1 if none or merging is off.
    The operations of ``tpufluids.forces.compute_forces`` (unidyn)."""
    h = cfg.cutoff
    rab, vab, ds, mask, dkf, dk = _pair_geometry(home, cand, valid, h)

    def hcol(c):
        return home[:, c, None]

    def msum(x, m=mask):
        return torch.where(m, x, 0.0).sum(dim=1)

    bi, bj = hcol(_BND) > 0.5, cand[..., _BND] > 0.5
    nb_bnd = (~bi) & bj
    both_fluid = (~bi) & (~bj)
    di, pi, mi = hcol(_DENS), hcol(_PRESS), hcol(_MASS)
    si, fi = hcol(_SOLID), hcol(_FLUID)
    dj, pj, mj = cand[..., _DENS], cand[..., _PRESS], cand[..., _MASS]
    sj, fj = cand[..., _SOLID], cand[..., _FLUID]

    # unidyn viscosity with the particle's own mass (FluidGPU-unidyn.cu:307;
    # PARITY.md deviation #7)
    d = vab[0] * rab[0] + vab[1] * rab[1] + vab[2] * rab[2]
    mu = h * (d / (ds * ds + 0.01 * h * h))
    rho_bar = (di + dj) / 2.0
    alpha_i = (si * 9.0 + 1.0) * cfg.alpha_fluid
    bfac = 1.0 + nb_bnd * ((1.0 + 3.0 * (fi * fi)) * cfg.alpha_sand_boundary)
    s = (alpha_i * cfg.sound
         * (mi * mu + cfg.visc_quadratic / cfg.sound * mu * mu)
         / rho_bar * (d < 0) * bfac)
    p_term = pj / (dj * dj) + pi / (di * di) + s
    sums = [msum(w_cubic(ds, h) * (1.0 + nb_bnd * cfg.bdensfactor) * mj)]
    sums += [msum(p_term * dk[a] * mj) for a in range(3)]
    # diffusion / colour gradient (FluidGPU-unidyn.cu:364-366)
    sums += [msum(mj / dj * dk[a], mask & both_fluid) for a in range(3)]
    # mixfactor-gated velocity gradient and granular stress acceleration
    # (FluidGPU-unidyn.cu:368-381), divided by dens and dens^2 after the sum
    mixfactor = torch.where(both_fluid & (si > 0) & (sj > 0),
                            2.0 * si * sj / (si + sj + cfg.mixfactor_reg), 0.0)
    sums += [msum(mixfactor * dk[a] * vab[b])
             for a in range(3) for b in range(3)]
    t = [(1.0 + mixfactor) * dk[b] for b in range(3)]
    sums += [msum(hx[:, 3 + 3 * a, None] * t[0] + hx[:, 4 + 3 * a, None] * t[1]
                  + hx[:, 5 + 3 * a, None] * t[2]) for a in range(3)]

    # drift velocities (FluidGPU-unidyn.cu:314-356)
    denom = cfg.rho0_sand * si + cfg.rho0 * fi
    denom = torch.where(denom == 0, 1.0, denom)
    msf = si * cfg.rho0_sand / denom
    mff = fi * cfg.rho0 / denom
    gate_i = ((msf > cfg.mix_frac_min) & (msf < cfg.mix_frac_max)
              & (mff > cfg.mix_frac_min) & (mff < cfg.mix_frac_max))
    g3 = mask & both_fluid & gate_i
    s_safe = torch.where(si == 0, 1.0, si)
    f_safe = torch.where(fi == 0, 1.0, fi)
    v_dk = hcol(_V) * dk[0] + hcol(_V + 1) * dk[1] + hcol(_V + 2) * dk[2]
    s_pref = di * (si - msf * si - mff * fi)
    f_pref = di * (fi - msf * si - mff * fi)
    grav = (0.0, 0.0, cfg.gravity)
    sdv, fdv = [], []
    for a in range(3):
        sg = (sj - si) * dk[a]
        fg = (fj - fi) * dk[a]
        sbrown = sg / s_safe * (1 - msf) - mff * fg / f_safe
        fbrown = fg / f_safe * (1 - mff) - msf * sg / s_safe
        a_slip = (si * pi - sj * pj) * dk[a]
        b_slip = (fi * pi - fj * pj) * dk[a]
        sslip = a_slip * (1 - msf) - mff * b_slip
        fslip = b_slip * (1 - mff) - msf * a_slip
        # the literal 150 of FluidGPU-unidyn.cu:342-348, not the
        # integrator's 220 - 70 solid
        body = 150.0 / di * hx[:, a, None] + grav[a] - v_dk * vab[a]
        sdv.append(msum(cfg.mixpressure * (s_pref * body + sslip)
                        - cfg.mixbrownian * sbrown, g3))
        fdv.append(msum(cfg.mixpressure * (f_pref * body + fslip)
                        - cfg.mixbrownian * fbrown, g3))
    sums += sdv + fdv + [mask.sum(dim=1).to(home.dtype)]

    best = torch.full((home.shape[0],), -1, dtype=torch.int64,
                      device=home.device)
    if cfg.merge_dist > 0:
        # nearest eligible partner within merge_dist, first of equals in
        # run order (the XLA argmin; FluidGPU-unidyn.cu:261-275)
        elig = (mask & (ds <= cfg.merge_dist) & (hcol(_ELIG) > 0.5)
                & (cand[..., _ELIG] > 0.5))
        nearest = torch.argmin(torch.where(elig, ds, math.inf), dim=1)
        best = torch.where(elig.any(dim=1), nearest, -1)
    return torch.stack(sums, dim=1), best


def _unidyn_b_chunk(home, hdrift, cand, cdrift, valid, cfg: SPHConfig):
    """Pass-B sums (c, B_COLS) of c home rows over their candidates, with
    the drift velocities (solid 0:3, fluid 3:6) of the home rows (c, 6)
    and of the candidates (c, M, 6) from pass A."""
    rab, vab, ds, mask, dkf, dk = _pair_geometry(home, cand, valid,
                                                 cfg.cutoff)

    def msum(x):
        return torch.where(mask, x, 0.0).sum(dim=1)

    bi, bj = home[:, _BND, None] > 0.5, cand[..., _BND] > 0.5
    both_fluid = (~bi) & (~bj)
    di, si, fi = (home[:, c, None] for c in (_DENS, _SOLID, _FLUID))
    dj, sj, fj = (cand[..., c] for c in (_DENS, _SOLID, _FLUID))
    sdi = [hdrift[:, a, None] for a in range(3)]
    fdi = [hdrift[:, 3 + a, None] for a in range(3)]
    sdj = [cdrift[..., a] for a in range(3)]
    fdj = [cdrift[..., 3 + a] for a in range(3)]

    def dot(v):
        return v[0] * dk[0] + v[1] * dk[1] + v[2] * dk[2]

    ds_i, ds_j, df_i, df_j = dot(sdi), dot(sdj), dot(fdi), dot(fdj)
    # mixture acceleration (FluidGPU-unidyn.cu:391-398)
    sums = []
    for a in range(3):
        term = ((sj * dj) * (sj * sdj[a] * ds_j + si * sdi[a] * ds_i)
                + (fj * dj) * (fj * fdj[a] * df_j + fi * fdi[a] * df_i))
        sums.append(msum(-term / (di * dj)))
    # phase transport (FluidGPU-unidyn.cu:400-401): the divergence part is
    # boundary-gated, the drift part is not (the reference's precedence)
    dk_vab = dk[0] * vab[0] + dk[1] * vab[1] + dk[2] * vab[2]
    drift_s = dot([si * sdi[a] + sj * sdj[a] for a in range(3)])
    drift_f = dot([fi * fdi[a] + fj * fdj[a] for a in range(3)])
    sums.append(msum(both_fluid * (-0.5 / dj) * (si + sj) * dk_vab
                     + (-drift_s) / dj))
    sums.append(msum(both_fluid * (-0.5 / dj) * (fi + fj) * dk_vab
                     + (-drift_f) / dj))
    return torch.stack(sums, dim=1)


def _subbin_ok(bt: BinTable, cfg: SPHConfig, a: int, b: int, idx, threshold):
    """(c, 9, k) octant sub-bin predicate of home rows a:b on their
    candidate slots ``idx`` (parity with mykernel3's 8-cell stencil,
    FluidGPU-unidyn.cu:579-583): a home row whose cell holds more than
    ``threshold`` rows keeps the per-axis cell offsets {0, dir} only,
    dir being its octant's half-cell direction.  Cells come from the
    sorted ids (``tpufluids.binning.neighbor_candidates``)."""
    g = cfg.grid_size
    n = bt.cid.shape[0]
    cz_i = (bt.cid[a:b].to(torch.int64) % g)[:, None, None]
    dz = bt.cid[torch.clamp(idx, 0, n - 1)].to(torch.int64) % g - cz_i
    off = torch.tensor(RUN_OFFSETS, dtype=torch.int64, device=idx.device)
    dx, dy = off[None, :, 0, None], off[None, :, 1, None]
    o = bt.octant[a:b][:, None, None]
    dirx = torch.where((o & 1) != 0, 1, -1)
    diry = torch.where((o & 2) != 0, 1, -1)
    dirz = torch.where((o & 4) != 0, -1, 1)
    ok = (((dx == 0) | (dx == dirx)) & ((dy == 0) | (dy == diry))
          & ((dz == 0) | (dz == dirz)))
    return (bt.home_count[a:b] <= threshold)[:, None, None] | ok


def unidyn_result(res_a, res_b, merge_partner, dens, solid_drift,
                  fluid_drift) -> dict:
    """The result dict of the JAX package's unidyn force passes, from the
    pass-A (N, A_COLS) and pass-B (N, B_COLS) sums in pool order: the
    velocity gradient and the stress acceleration are divided by dens
    and dens^2 after the sum.  ``overflow`` is 0: the runs are uncapped
    (the column family's wrapper puts its own count there)."""
    n = res_a.shape[0]
    return dict(
        sum_w=res_a[:, A_SUMW],
        dpress=res_a[:, A_DP:A_DP + 3],
        diffusion=res_a[:, A_DIFF:A_DIFF + 3],
        vel_grad=(res_a[:, A_VG:A_VG + 9]
                  * (-1.0 / dens)[:, None]).reshape(n, 3, 3),
        stress_accel=res_a[:, A_SA:A_SA + 3] / (dens * dens)[:, None],
        solid_drift=solid_drift,
        fluid_drift=fluid_drift,
        mixture_accel=res_b[:, 0:3],
        delsolid=res_b[:, 3],
        delfluid=res_b[:, 4],
        has_pair=res_a[:, A_CNT] > 0,
        merge_partner=merge_partner,
        overflow=torch.zeros((), dtype=torch.int32, device=res_a.device),
    )


def unidyn_pair_pass(state: ParticleState, bt: BinTable, cfg: SPHConfig,
                     subbin_threshold=None, drift_fix=None,
                     caps=None) -> dict:
    """Both unidyn pair passes in plain PyTorch, on any device: ``state``
    in pool order, ``bt`` from ``binning.sort_tables`` (unidyn); returns
    the result dict of ``unidyn_result`` in pool order.
    ``subbin_threshold``: the two-level binning's threshold, None for the
    full stencil.  ``drift_fix`` maps (solid_drift, fluid_drift), in pool
    order, to the arrays pass B reads.  ``caps`` = (b, w_cap): the column
    family's capped pair set (``binning.run_table``); a row over the home
    cap gets zeros, so pass B reads zero drift for it."""
    n = state.capacity
    order = bt.order
    rows = pack_unidyn_rows(state, order, bt.in_dom, cfg)
    hx = torch.cat([state.delpress, state.stress.reshape(n, 9)],
                   dim=1)[order]
    run_start, run_len = run_table(bt, cfg, caps)
    k = int(run_len.max()) if n else 0       # the plain path's host sync
    out_a = rows.new_zeros((n, A_COLS))
    out_b = rows.new_zeros((n, B_COLS))
    partner = torch.full((n,), -1, dtype=torch.int64, device=rows.device)
    slot = torch.arange(k, device=rows.device)
    step = max(1, CHUNK_SLOTS // (9 * max(k, 1)))
    chunks = [(a, min(n, a + step)) for a in range(0, n, step)] if k else []

    def candidates(a, b):
        idx = run_start[a:b, :, None] + slot                   # (c, 9, k)
        valid = slot < run_len[a:b, :, None]
        if subbin_threshold is not None:
            valid = valid & _subbin_ok(bt, cfg, a, b, idx, subbin_threshold)
        return (torch.clamp(idx, 0, n - 1).reshape(b - a, -1),
                valid.reshape(b - a, -1))

    for a, b in chunks:
        idx, valid = candidates(a, b)
        out_a[a:b], best = _unidyn_a_chunk(rows[a:b], hx[a:b], rows[idx],
                                           valid, cfg)
        partner[a:b] = torch.where(
            best >= 0, order[idx.gather(1, best.clamp(min=0)[:, None])[:, 0]],
            -1)
    res_a = to_pool(out_a, order)
    sdv = res_a[:, A_SDV:A_SDV + 3]
    fdv = res_a[:, A_FDV:A_FDV + 3]
    if drift_fix is not None:
        sdv, fdv = drift_fix(sdv, fdv)
    drift = torch.cat([sdv, fdv], dim=1)[order]
    for a, b in chunks:
        idx, valid = candidates(a, b)
        out_b[a:b] = _unidyn_b_chunk(rows[a:b], drift[a:b], rows[idx],
                                     drift[idx], valid, cfg)
    return unidyn_result(res_a, to_pool(out_b, order),
                         to_pool(partner, order), state.dens, sdv, fdv)


# --- the CUDA passes' lane schedule, emulated -----------------------------


def _lane_slot_chunks(bt: BinTable, cfg: SPHConfig, lanes: int,
                      subbin_threshold=None, caps=None, runs=None):
    """``lane_slots`` in chunks of home rows: (row, j, lane, q) of each."""
    n = bt.cid.shape[0]
    run_start, run_len = runs if runs is not None else run_table(bt, cfg,
                                                                 caps)
    k = int(run_len.max()) if n else 0
    if k == 0:
        return
    slot = torch.arange(k, device=bt.cid.device)
    step = max(1, CHUNK_SLOTS // (9 * k))
    for a in range(0, n, step):
        b = min(n, a + step)
        idx = run_start[a:b, :, None] + slot                   # (c, 9, k)
        walked = slot < run_len[a:b, :, None]
        if subbin_threshold is not None:
            walked = walked & _subbin_ok(bt, cfg, a, b, idx,
                                         subbin_threshold)
        walked = walked.reshape(b - a, -1)
        t = torch.cumsum(walked, dim=1) - 1
        r, s = walked.nonzero(as_tuple=True)
        if r.numel():
            ts = t[r, s]
            yield (r + a, idx.reshape(b - a, -1)[r, s], ts % lanes,
                   ts // lanes)


def lane_slots(bt: BinTable, cfg: SPHConfig, lanes: int,
               subbin_threshold=None, caps=None, runs=None):
    """The dealing of candidate slots to the ``lanes`` lanes of a home row
    in the SPH force kernels (csrc/sph_unidyn.cu, csrc/sph_forces.cu):
    (row, j, lane, q), each (S,) int64, one entry per walked slot, where
    ``row`` is the sorted home row, ``j`` the sorted candidate row, and
    the slot is the t-th that the row walks (its 9 runs in RUN_OFFSETS
    order, every slot of the walked cells counted, pair or not;
    sub-binned and capped runs walk only their cells and rows), lane = t
    mod lanes and q = t div lanes its place in its lane.  The entries go
    by row, then t.  ``runs``: (run_start, run_len) of another walk than
    ``binning.run_table(bt, cfg, caps)``, such as the stale window's."""
    chunks = list(_lane_slot_chunks(bt, cfg, lanes, subbin_threshold, caps,
                                    runs))
    if not chunks:
        none = torch.zeros(0, dtype=torch.int64, device=bt.cid.device)
        return none, none, none, none
    return tuple(torch.cat(x) for x in zip(*chunks))


def lane_butterfly(v: torch.Tensor) -> torch.Tensor:
    """(n, lanes, ...) per-lane sums -> (n, ...): the kernels' shuffle
    butterfly, each lane adding its partner's value at lane offsets
    lanes/2, ..., 2, 1 (``x += __shfl_xor_sync(.., x, off)``), read at
    lane 0."""
    ids = torch.arange(v.shape[1], device=v.device)
    off = v.shape[1] // 2
    while off:
        v = v + v[:, ids ^ off]
        off //= 2
    return v[:, 0]


def nearer(d, j, bd, bj):
    """The kernels' merge-partner order: nearer, or as near and earlier
    in run order (the smaller sorted row), which is the plain version's
    first of equals."""
    return (d < bd) | ((d == bd) & (j < bj))


def _by_place(q):
    """Index sets of the slots at each place q in their lanes, in order:
    one slot per (row, lane) in each."""
    by_q = torch.argsort(q, stable=True)
    return torch.split(by_q, torch.bincount(q).tolist())


def _sum_by_lane(row, lane, q, terms, n: int, lanes: int, acc=None):
    """(n, lanes, cols): each lane's sum of its slots' ``terms`` (S, cols),
    added one by one in its slot order (into ``acc``, when given)."""
    if acc is None:
        acc = terms.new_zeros((n, lanes, terms.shape[1]))
    for sel in _by_place(q):
        acc[row[sel], lane[sel]] += terms[sel]
    return acc


def _lane_partner(row, lane, q, j, d, n: int, lanes: int):
    """(n,) sorted partner row of each home row (n: none): each lane keeps
    the ``nearer`` of its eligible slots (d < inf) in its slot order, then
    the butterfly keeps the ``nearer`` of each pair of lanes."""
    bd = d.new_full((n, lanes), math.inf)
    bj = torch.full((n, lanes), n, dtype=torch.int64, device=d.device)
    j = torch.where(d < math.inf, j, n)
    for sel in _by_place(q):
        r, ln = row[sel], lane[sel]
        take = nearer(d[sel], j[sel], bd[r, ln], bj[r, ln])
        bd[r, ln] = torch.where(take, d[sel], bd[r, ln])
        bj[r, ln] = torch.where(take, j[sel], bj[r, ln])
    ids = torch.arange(lanes, device=d.device)
    off = lanes // 2
    while off:
        od, oj = bd[:, ids ^ off], bj[:, ids ^ off]
        take = nearer(od, oj, bd, bj)
        bd, bj = torch.where(take, od, bd), torch.where(take, oj, bj)
        off //= 2
    return bj[:, 0]


def lane_sums(state: ParticleState, bt: BinTable, cfg: SPHConfig,
              lanes: int, subbin_threshold=None, drift_fix=None, caps=None):
    """The two unidyn passes in the kernels' lane schedule: (out_a (N,
    A_COLS), out_b (N, B_COLS), partner (N,) sorted rows or N for none),
    in sorted order, and the drifts pass B read, (solid, fluid) in pool
    order.  The terms of a pair are the plain version's
    (``_unidyn_a_chunk`` and ``_unidyn_b_chunk`` on one candidate),
    summed lane by lane in ``lane_slots`` order, the lanes combined by
    ``lane_butterfly``."""
    n = state.capacity
    order = bt.order
    rows = pack_unidyn_rows(state, order, bt.in_dom, cfg)
    hx = torch.cat([state.delpress, state.stress.reshape(n, 9)],
                   dim=1)[order]
    row, j, lane, q = lane_slots(bt, cfg, lanes, subbin_threshold, caps)
    chunks = [(a, min(row.shape[0], a + CHUNK_SLOTS))
              for a in range(0, row.shape[0], CHUNK_SLOTS)]
    one = torch.ones((min(row.shape[0], CHUNK_SLOTS), 1), dtype=torch.bool,
                     device=rows.device)
    terms_a, dist = [rows.new_zeros((0, A_COLS))], [rows.new_zeros(0)]
    for a, b in chunks:
        home, cand = rows[row[a:b]], rows[j[a:b]]
        t, best = _unidyn_a_chunk(home, hx[row[a:b]], cand[:, None],
                                  one[:b - a], cfg)
        rab = [home[:, _X + c] - cand[:, _X + c] for c in range(3)]
        ds = torch.sqrt(rab[0] * rab[0] + rab[1] * rab[1] + rab[2] * rab[2])
        terms_a.append(t)
        dist.append(torch.where(best == 0, ds, math.inf))
    out_a = lane_butterfly(_sum_by_lane(row, lane, q, torch.cat(terms_a), n,
                                      lanes))
    partner = _lane_partner(row, lane, q, j, torch.cat(dist), n, lanes)
    res_a = to_pool(out_a, order)
    sdv = res_a[:, A_SDV:A_SDV + 3]
    fdv = res_a[:, A_FDV:A_FDV + 3]
    if drift_fix is not None:
        sdv, fdv = drift_fix(sdv, fdv)
    drift = torch.cat([sdv, fdv], dim=1)[order]
    terms_b = [rows.new_zeros((0, B_COLS))] + [
        _unidyn_b_chunk(rows[row[a:b]], drift[row[a:b]],
                        rows[j[a:b]][:, None], drift[j[a:b]][:, None],
                        one[:b - a], cfg) for a, b in chunks]
    out_b = lane_butterfly(_sum_by_lane(row, lane, q, torch.cat(terms_b), n,
                                      lanes))
    return out_a, out_b, partner, sdv, fdv


def unidyn_lane_pass(state: ParticleState, bt: BinTable, cfg: SPHConfig,
                     lanes: int, subbin_threshold=None, drift_fix=None,
                     caps=None) -> dict:
    """``unidyn_pair_pass`` summed in the CUDA kernels' order, ``lanes``
    lanes a home row (``lane_sums``): the result dict of
    ``unidyn_result`` in pool order.  The emulation the kernels are held
    against on the card."""
    n = state.capacity
    order = bt.order
    out_a, out_b, partner, sdv, fdv = lane_sums(
        state, bt, cfg, lanes, subbin_threshold, drift_fix, caps)
    partner = torch.where(partner < n, order[partner.clamp(max=n - 1)], -1)
    return unidyn_result(to_pool(out_a, order), to_pool(out_b, order),
                         to_pool(partner, order), state.dens, sdv, fdv)


def base_lane_sums(rows: torch.Tensor, bt: BinTable, cfg: SPHConfig,
                   lanes: int, runs, cells=None):
    """The base pair pass in the CUDA kernels' lane schedule over the
    walk ``runs`` (``binning.run_table``): (sums (N, 4) sum_w and dpress
    in sorted order, pairs, an int64 device scalar).  The terms of a
    slot are ``_chunk_sums``' on one candidate, masked by ``near_cells``
    of ``cells`` (the current cells, stale) when given, summed lane by
    lane in ``lane_slots`` order and joined by ``lane_butterfly``; the
    home rows go in chunks."""
    n = rows.shape[0]
    acc = rows.new_zeros((n, lanes, 4))
    pairs = torch.zeros((), dtype=torch.int64, device=rows.device)
    for row, j, lane, q in _lane_slot_chunks(bt, cfg, lanes, runs=runs):
        home, cand = rows[row], rows[j][:, None]
        valid = (near_cells(cells[row], cells[j][:, None]) if cells is not None
                 else torch.ones_like(row, dtype=torch.bool)[:, None])
        sum_w, dpress = _chunk_sums(home, cand, valid, cfg)
        _sum_by_lane(row, lane, q, torch.cat([sum_w[:, None], dpress], 1),
                     n, lanes, acc)
        rab = home[:, _X:_X + 3] - cand[:, 0, _X:_X + 3]
        ds = torch.sqrt(torch.sum(rab * rab, dim=-1))
        pairs += (valid[:, 0] & (cand[:, 0, _ALIVE] > 0.5) & (ds > 0)
                  & (ds <= 2 * cfg.cutoff)).sum()
    return lane_butterfly(acc), pairs


def base_lane_pass(state: ParticleState, bt: BinTable, cfg: SPHConfig,
                   lanes: int, caps=None, stale: bool = False):
    """``pair_sums`` summed in the base CUDA kernels' order, ``lanes``
    lanes a home row (csrc/sph_forces.cu): (sum_w (N,), dpress (N, 3)) in
    pool order and the pairs summed (an int64 device scalar).  ``caps``:
    the column family's caps; ``stale``: ``bt`` is an earlier step's, and
    the walk is each stale column's ``binning.stale_window`` by
    ``column_shift``, as the kernels walk it.  The emulation the kernels
    are held against on the card."""
    order = bt.order
    rows = pack_rows(state, order, bt.in_dom)
    cells = window = None
    if stale:
        cells = cell_trunc(rows[:, _X:_X + 3], cfg)
        window = (cells[:, 2], column_shift(rows, bt, cfg))
    sums, pairs = base_lane_sums(rows, bt, cfg, lanes,
                                 run_table(bt, cfg, caps, window=window),
                                 cells)
    return to_pool(sums[:, 0], order), to_pool(sums[:, 1:], order), pairs


def granular_pass(state: ParticleState, vel_grad: torch.Tensor,
                  cfg: SPHConfig):
    """Per-particle granular pass (FluidGPU-unidyn.cu:410-446), as
    ``tpufluids.forces.granular_pass``: strain rate from the velocity
    gradient, Drucker-Prager yield scaling of sigma and the stress rate.
    Returns (stress_scaled, stress_rate)."""
    press, solid, stress = state.press, state.solid, state.stress
    sr = 0.5 * (vel_grad + vel_grad.transpose(1, 2))
    tr = sr[:, 0, 0] + sr[:, 1, 1] + sr[:, 2, 2]
    tr3 = 0.5 * torch.sum(stress * stress, dim=(1, 2))
    tr5 = torch.sum(sr * sr, dim=(1, 2))
    tr4 = torch.sum(stress * sr.transpose(1, 2), dim=(1, 2))
    ppos = press * (press > 0)
    ylim = (3.0 * math.tan(cfg.phi) / cfg.yield_denom * ppos
            + cfg.kc / cfg.yield_denom)
    scale = torch.where((ylim < tr3) & (tr3 != 0),
                        ylim / torch.where(tr3 == 0, 1.0, tr3), 1.0)
    active = (solid != 0)[:, None, None]
    sig = torch.where(active, stress * scale[:, None, None], stress)
    eye = torch.eye(3, dtype=stress.dtype, device=stress.device)
    rate = (3.0 * cfg.c1 * press[:, None, None]
            * (sr - tr[:, None, None] / 3.0 * eye)
            + cfg.c1 * cfg.c2 * ((tr4 + tr * ppos)
                                 / (press * press + cfg.stress_rate_reg)
                                 )[:, None, None] * sig
            - cfg.c1 * cfg.c3 * torch.sqrt(tr5)[:, None, None] * sig)
    return sig, torch.where(active, rate, 0.0)


def compute_split_trigger(state: ParticleState, diffusion: torch.Tensor,
                          has_pair: torch.Tensor, cfg: SPHConfig):
    """Adaptive-resolution split trigger (FluidGPU-unidyn.cu:261-285)."""
    diff2 = torch.sum(diffusion * diffusion, dim=-1)
    return (has_pair & (state.mass > cfg.split_mass_min)
            & (~state.boundary) & state.alive
            & ((diff2 > cfg.split_diffusion_min)
               | (state.dens < cfg.split_dens_max)))


def accum_from_sums(state: ParticleState, r: dict,
                    cfg: SPHConfig) -> ForceAccum:
    """A full unidyn ForceAccum from the pair passes' result dict (the
    kernels' or ``unidyn_pair_pass``'s), with the per-particle granular
    pass and split trigger: ``tpufluids.forces.accum_from_pallas``."""
    sig, rate = granular_pass(state, r["vel_grad"], cfg)
    return ForceAccum(
        sum_w=r["sum_w"], dpress=r["dpress"], diffusion=r["diffusion"],
        vel_grad=r["vel_grad"], stress_accel=r["stress_accel"],
        solid_drift=r["solid_drift"], fluid_drift=r["fluid_drift"],
        mixture_accel=r["mixture_accel"], delsolid=r["delsolid"],
        delfluid=r["delfluid"], stress_scaled=sig, stress_rate=rate,
        split_trigger=compute_split_trigger(state, r["diffusion"],
                                            r["has_pair"], cfg),
        merge_partner=r["merge_partner"])


def compute_forces(state: ParticleState, bt: BinTable, cfg: SPHConfig,
                   subbin_parity: bool = False, subbin_threshold: int = 6,
                   drift_fix=None) -> ForceAccum:
    """The pair passes in plain PyTorch, on any device, as
    ``tpufluids.forces.compute_forces``: ``state`` in pool order, ``bt``
    from ``binning.sort_tables``; returns the sums in pool order.
    ``subbin_parity`` (unidyn) restricts the stencil of overfull cells to
    their octant; ``drift_fix`` (unidyn) maps the drift velocities
    between the passes."""
    if cfg.variant != "base":
        return accum_from_sums(state, unidyn_pair_pass(
            state, bt, cfg, subbin_threshold if subbin_parity else None,
            drift_fix), cfg)
    if subbin_parity:
        raise NotImplementedError(
            "the base variant with subbin_parity is not ported to "
            "tpufluids_torch yet (ROADMAP.md Queue 1 item 4)")
    rows = pack_rows(state, bt.order, bt.in_dom)
    sum_w, dpress = pair_sums(rows, bt, cfg)
    return ForceAccum(to_pool(sum_w, bt.order), to_pool(dpress, bt.order))
