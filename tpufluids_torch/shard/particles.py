"""Sharded SPH: the x-slab domain decomposition of
``tpufluids.shard.particles`` over the port's ``shard.Mesh``, one
particle pool a rank.

The reference's multi-GPU path splits the cell grid along x with a
one-cell-plane halo (``buffer = GRIDSIZE^2``, solver-unidyn.cu:187-195),
copies halo particles each step and migrates particles that cross a cut
(``find_idx``, host-staged cudaMemcpy and ``mem_shift``,
solver-unidyn.cu:396-470).  Here each rank owns a pool of fixed capacity
for its slab of ``grid_size / world`` x planes, and a step is:

1. halo exchange: the alive rows of the slab's first and last owned
   x plane, packed into buffers of ``halo_capacity`` rows, go to the
   neighbouring ranks (``Mesh.shift``; what wraps around the ring is
   invalidated: the domain is not periodic);
2. the pool and the halo rows are sorted on the local slab grid
   (``binning.GridSpec(g, gpd + 2, lo - 1)``), and the force pass of the
   single-device step runs on them (``step.dispatch_forces``: the slab
   instances of the force kernels on the card, their plain versions on
   the CPU, or the XLA pair path).  For the unidyn variant the drift
   velocities of the halo rows are replaced by their owners' between
   pass A and pass B (the ``drift_fix`` hook): a halo row's own
   neighbourhood reaches past the exchanged plane, its owner's does not;
3. with merging on, the halo rows' merge picks are replaced by their
   owners' in the same way, and ``adapt.resolve_merges`` resolves the
   mutual picks by pid;
4. the update; the halo rows are dropped (a stable partition of the
   owned rows to the front);
5. migration: rows whose new x cell left the slab go to the neighbour in
   buffers of ``migrate_capacity`` rows and are inserted into its free
   slots; then splits.

Every capacity is static and every overflow is counted, never silent
(``ShardedMetrics``).  The stencil reaches one cell, so one halo plane
suffices and the physics is the single-device step's; a world of 1 runs
exactly the single-device pipeline (``step.sph_step``).

A world above 1 runs its ranks as processes (``shard.spawn``); each
builds its pool with ``distribute`` from the same dense state, steps it,
and ``collect`` gathers the pools on rank 0.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tpufluids_torch import adapt, binning, step
from tpufluids_torch.binning import GridSpec, cell_coords
from tpufluids_torch.config import SPHConfig
from tpufluids_torch.convert import state_from_numpy
from tpufluids_torch.integrate import update
from tpufluids_torch.shard.mesh import Mesh
from tpufluids_torch.state import FIELDS, ParticleState

# the flat float32 row layout of the exchange buffers, 33 columns:
# (field, width)
_FIELDS = [
    ("pos", 3), ("vel", 3), ("acc", 3), ("mass", 1), ("dens", 1),
    ("press", 1), ("delpress", 3), ("diffusion", 3), ("solid", 1),
    ("fluid", 1), ("stress", 9), ("boundary", 1), ("alive", 1),
    ("split", 1), ("pid", 1),
]


def _pack_rows(state: ParticleState, mask: torch.Tensor, cap: int):
    """The masked rows compacted in row order into a (cap, 33) float32
    buffer: (buffer, valid (cap,), source rows (cap,), overflow), the
    overflow the masked rows beyond ``cap`` (int32)."""
    n = state.capacity
    dev = state.pos.device
    rows = torch.arange(n, device=dev)
    rank = torch.cumsum(mask, 0) - 1
    src = adapt.scatter_drop(torch.full((n,), n, device=dev),
                             torch.where(mask, rank, n), rows)
    total = mask.sum()
    if cap > n:
        src = torch.cat([src, src.new_full((cap - n,), n)])
    valid = torch.arange(cap, device=dev) < total
    gsrc = torch.clamp(src[:cap], 0, n - 1)
    table = torch.cat([getattr(state, f).to(torch.float32).reshape(n, -1)
                       for f, _ in _FIELDS], dim=1)
    buf = torch.where(valid[:, None], table[gsrc], 0.0)
    return (buf, valid, gsrc,
            torch.clamp(total - cap, min=0).to(torch.int32))


def _unpack_rows(buf: torch.Tensor, valid: torch.Tensor) -> ParticleState:
    """The inverse of ``_pack_rows``: (cap, 33) rows to a pool of
    ``cap`` rows, alive where valid."""
    cap = buf.shape[0]
    out, off = {}, 0
    for name, w in _FIELDS:
        col = buf[:, off:off + w]
        off += w
        if name == "stress":
            out[name] = col.reshape(cap, 3, 3)
        elif name in ("boundary", "split"):
            out[name] = col[:, 0] > 0.5
        elif name == "alive":
            out[name] = (col[:, 0] > 0.5) & valid
        elif name == "pid":
            out[name] = col[:, 0].to(torch.int32)
        else:
            out[name] = col if w == 3 else col[:, 0]
    return ParticleState(**out)


def _shift(buf: torch.Tensor, valid: torch.Tensor, direction: int,
           mesh: Mesh):
    """``buf`` and ``valid`` sent one rank along the ring (+1: to the
    right neighbour, so this rank receives its left neighbour's), in one
    exchange; the rows that wrap around the ring's ends are invalidated,
    as the domain is not periodic."""
    if mesh.size == 1:
        return buf, torch.zeros_like(valid)
    got = mesh.shift(torch.cat([buf, valid[:, None].to(buf.dtype)], dim=1),
                     direction)
    edge = mesh.rank > 0 if direction == 1 else mesh.rank < mesh.size - 1
    return got[:, :-1], (got[:, -1] > 0.5) & edge


def _insert(state: ParticleState, incoming: ParticleState):
    """Incoming alive rows into the free slots, the k-th incoming row to
    the k-th free slot, as ``adapt.apply_splits`` matches them.  Returns
    (state, dropped): rows that find no free slot are dropped and
    counted (int32), the receiver's half of the migration overflow."""
    n, m = state.capacity, incoming.capacity
    dev = state.pos.device
    free = ~state.alive
    free_rank = torch.cumsum(free, 0) - 1
    slot_of_rank = adapt.scatter_drop(torch.full((n,), n, device=dev),
                                      torch.where(free, free_rank, n),
                                      torch.arange(n, device=dev))
    inc = incoming.alive
    inc_rank = torch.cumsum(inc, 0) - 1
    served = inc & (inc_rank < free.sum())
    dst = torch.where(served, slot_of_rank[torch.clamp(inc_rank, 0, n - 1)],
                      n)
    out = {}
    for name in FIELDS:
        b = getattr(incoming, name)
        keep = served.reshape((m,) + (1,) * (b.dim() - 1))
        out[name] = adapt.scatter_drop(
            getattr(state, name), dst,
            torch.where(keep, b, torch.zeros_like(b)))
    out["alive"] = adapt.scatter_drop(state.alive, dst, served)
    return ParticleState(**out), (inc & ~served).sum().to(torch.int32)


class ShardedMetrics(NamedTuple):
    """Over the ranks: the alive rows and the fastest fluid row after the
    last step, and the overflow counters summed over every step (a drop
    in any step shows), as 0-dim tensors."""
    n_alive: torch.Tensor
    halo_overflow: torch.Tensor      # edge rows beyond halo_capacity
    migrate_overflow: torch.Tensor   # migrants beyond migrate_capacity,
                                     # or finding no free slot
    bin_overflow: torch.Tensor       # the force pass's overflow
    max_speed: torch.Tensor


def make_sharded_step(mesh: Mesh, cfg: SPHConfig, halo_capacity: int = 512,
                      migrate_capacity: int = 256, n_steps: int = 1,
                      subbin_parity=None):
    """The sharded SPH step of ``n_steps`` steps on this rank's pool (from
    ``distribute``): a function of the pool that returns (pool,
    ShardedMetrics).  Every rank of ``mesh`` calls it together."""
    sp = step.resolve_subbin(cfg, subbin_parity)
    g = cfg.grid_size
    if g % mesh.size:
        raise ValueError(f"grid_size={g} must divide over {mesh.size} "
                         f"ranks")
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    gpd = g // mesh.size
    halo, migrate = halo_capacity, migrate_capacity
    unidyn = cfg.variant != "base"
    zero = torch.zeros((), dtype=torch.int32, device=mesh.device)

    def one_step_single_device(local: ParticleState):
        """A world of 1: no cut, so nothing to exchange, drop or migrate;
        the single-device step itself (solver-unidyn.cu:193-195, 396)."""
        local, m = step.sph_step(local, cfg, sp)
        return local, (m.n_alive, zero, zero, m.bin_overflow, m.max_speed)

    def one_step(local: ParticleState):
        lo = mesh.rank * gpd
        hi = lo + gpd
        cap0 = local.capacity
        cx = cell_coords(local.pos, cfg)[:, 0]

        # halo exchange: one owned edge plane each way
        buf_r, val_r, src_r, ovf_r = _pack_rows(
            local, local.alive & (cx == hi - 1), halo)
        buf_l, val_l, src_l, ovf_l = _pack_rows(
            local, local.alive & (cx == lo), halo)
        halo_l, hval_l = _shift(buf_r, val_r, +1, mesh)   # from the left
        halo_r, hval_r = _shift(buf_l, val_l, -1, mesh)   # from the right
        got = _unpack_rows(torch.cat([halo_l, halo_r]),
                           torch.cat([hval_l, hval_r]))
        comb = ParticleState(**{f: torch.cat([getattr(local, f),
                                              getattr(got, f)])
                                for f in FIELDS})
        owned = torch.arange(comb.capacity, device=mesh.device) < cap0
        grid = GridSpec(g=g, x_planes=gpd + 2, x_offset=lo - 1)
        comb, bt, perm = binning.sort_by_cell(comb, cfg, grid, subbin=sp)
        owned = owned[perm]

        def owners(v):
            """``v`` (rows, k), in sorted order, with each halo row's
            values replaced by its owner's, which sent them in the order
            of its halo buffers."""
            pre = torch.empty_like(v).index_copy_(0, perm, v)
            recv_l, rval_l = _shift(pre[src_r], val_r, +1, mesh)
            recv_r, rval_r = _shift(pre[src_l], val_l, -1, mesh)
            rval = torch.cat([rval_l, rval_r])[:, None]
            pre[cap0:] = torch.where(rval, torch.cat([recv_l, recv_r]),
                                     pre[cap0:])
            return pre[perm]

        def drift_fix(sdv, fdv):
            fixed = owners(torch.cat([sdv, fdv], dim=1))
            return fixed[:, :3], fixed[:, 3:]

        acc, bin_ovf = step.dispatch_forces(
            comb, bt, cfg, sp, drift_fix=drift_fix if unidyn else None)

        if unidyn and cfg.merge_dist > 0:
            # merge across the cut (solver-unidyn.cu:339-349): the halo
            # rows' picks are incomplete here, so take their owners'; picks
            # are pids, so the mutual resolution is the same on each side
            mp = acc.merge_partner
            pick = torch.where(
                mp >= 0, comb.pid[torch.clamp(mp, 0, comb.capacity - 1)], -1)
            pick = owners(pick.to(torch.float32)[:, None])[:, 0]
            comb = adapt.resolve_merges(comb, mp, pick.to(torch.int32), cfg)

        comb = update(comb, acc, cfg)

        # drop the halo rows: the owned rows, in their sorted order, to
        # the front; exactly cap0 rows are owned
        keep = torch.argsort((~owned).to(torch.int32), stable=True)[:cap0]
        local = binning.permute_pool(comb, keep)

        # migration across the cut
        cx = cell_coords(local.pos, cfg)[:, 0]
        go_r = local.alive & (cx >= hi) & (cx < g)
        go_l = local.alive & (cx < lo) & (cx >= 0)
        mbuf_r, mval_r, _, movf_r = _pack_rows(local, go_r, migrate)
        mbuf_l, mval_l, _, movf_l = _pack_rows(local, go_l, migrate)
        in_l, ival_l = _shift(mbuf_r, mval_r, +1, mesh)
        in_r, ival_r = _shift(mbuf_l, mval_l, -1, mesh)
        local = local.replace(alive=local.alive & ~(go_r | go_l))
        local, dropped = _insert(local, _unpack_rows(
            torch.cat([in_l, in_r]), torch.cat([ival_l, ival_r])))

        if unidyn and cfg.split_reinjection:
            local = adapt.apply_splits(local, cfg)
        fluid = local.alive & ~local.boundary
        return local, (adapt.count_alive(local), ovf_r + ovf_l,
                       movf_r + movf_l + dropped, bin_ovf,
                       torch.max(torch.where(
                           fluid, torch.linalg.vector_norm(local.vel, dim=-1),
                           0.0)))

    one = one_step_single_device if mesh.size == 1 else one_step

    def run(local: ParticleState):
        counts = None
        for _ in range(n_steps):
            local, (alive, ovf_h, ovf_m, ovf_b, speed) = one(local)
            c = torch.stack([ovf_h, ovf_m, ovf_b]).to(torch.int32)
            counts = c if counts is None else counts + c
        totals = mesh.sum(torch.cat([alive.reshape(1).to(torch.int32),
                                     counts]))
        return local, ShardedMetrics(
            n_alive=totals[0], halo_overflow=totals[1],
            migrate_overflow=totals[2], bin_overflow=totals[3],
            max_speed=mesh.max(speed))

    return run


def distribute(state: ParticleState, mesh: Mesh, cfg: SPHConfig,
               capacity_per_device: Optional[int] = None) -> ParticleState:
    """This rank's pool of the dense ``state`` (the same on every rank):
    its alive rows whose x cell lies in its slab (out-of-range cells go
    to the end ranks), padded with dead rows (pid -1) to
    ``capacity_per_device``, on ``mesh.device``; the analog of the
    reference's per-device particle erase (solver-unidyn.cu:198-210).
    The default capacity is 1.5 times the fullest slab's population,
    rounded up to a multiple of 8.  Raises, on every rank alike, when a
    slab needs more slots."""
    n_dev = mesh.size
    gpd = cfg.grid_size // n_dev
    dense = {f: getattr(state, f).cpu().numpy() for f in FIELDS}
    cx = np.trunc((dense["pos"][:, 0] - cfg.xmin)
                  / cfg.cell_size).astype(np.int64)
    owner = np.clip(cx // gpd, 0, n_dev - 1)
    members = [np.where(dense["alive"] & (owner == d))[0]
               for d in range(n_dev)]
    if capacity_per_device is None:
        peak = max(sel.size for sel in members)
        capacity_per_device = -(-max(int(peak * 1.5), 8) // 8) * 8
    for d, sel in enumerate(members):
        if sel.size > capacity_per_device:
            raise ValueError(f"rank {d} needs {sel.size} slots > "
                             f"{capacity_per_device}")
    sel = members[mesh.rank]
    pool = {}
    for name, a in dense.items():
        fill = np.zeros((capacity_per_device - sel.size,) + a.shape[1:],
                        a.dtype)
        pool[name] = np.concatenate([a[sel], fill])
    pool["alive"][sel.size:] = False
    pool["pid"][sel.size:] = -1
    return state_from_numpy(pool, device=mesh.device)


def collect(state: ParticleState, mesh: Mesh) -> Optional[ParticleState]:
    """Every rank's pool on rank 0, concatenated in rank order (dead slots
    included); None on the other ranks."""
    parts = {}
    for f in FIELDS:
        t = getattr(state, f)
        got = mesh.gather(t.to(torch.uint8) if t.dtype == torch.bool else t)
        if got is not None:
            parts[f] = torch.cat(got).to(t.dtype)
    return ParticleState(**parts) if parts else None
