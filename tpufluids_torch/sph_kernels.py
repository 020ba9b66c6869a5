"""The hand-written CUDA kernels of the SPH step, beside their plain
PyTorch versions: the counterpart of ``tpufluids/sph_pallas.py``.

* ``base_forces_rowblock`` replaces the Pallas kernel of the same name
  (``_base_rowblock_kernel``): ``sum_w`` and ``dpress`` of every particle
  over its exact 27-cell stencil, with no capacity cap, in pool order.
  The wrapper makes two launches of ``csrc/sph_forces.cu``: the pack
  kernel (``base_pack``: the sorted rows of ``forces.pack_rows``, one
  gather by ``order``, and in stale mode the rows' current cells and
  each column's z-cell shift),
  then the force kernel, ``BASE_LANES`` lanes of one warp a sorted row,
  whose lane 0 writes the row's results at its pool index
  (``forces.base_lane_pass`` emulates their order of sums).  Its stale
  mode serves the sort cadence: a row walks only the cells of each stale
  column that its shift leaves within reach (``binning.stale_window``),
  a set that holds the whole column's pairs.
* ``base_forces_column`` replaces ``base_forces_pallas``: the same
  pairs, capped per (x, y) column as the column family caps them
  (``config.column_caps``), fresh or stale, with the overflow count:
  the same kernels, capped.
* ``unidyn_forces_resident`` and ``unidyn_forces_rowblock`` replace the
  Pallas kernels of the same names: the two unidyn pair passes, as the
  pair of kernels of ``csrc/sph_unidyn.cu``, ``UNIDYN_LANES`` lanes a
  home row (``forces.unidyn_lane_pass`` emulates their order of sums).
  The resident wrapper
  launches pass B right after pass A, which leaves the drift velocities
  in sorted order for it; the row-block wrapper runs the ``drift_fix``
  hook on pass A's drifts in pool order and gathers them by ``order``
  for pass B, as ``tpufluids/sph_pallas.py:1674-1684`` does.
* ``unidyn_forces_column`` replaces ``unidyn_forces_pallas``: the
  resident passes, capped as the column family caps them.

Each wrapper counts its launches in ``<wrapper>.launches``.  It runs the
plain version when its tensors lie on the CPU; any other device raises,
and so does a failed build or launch: nothing falls back from the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpufluids_torch import _build, binning, forces
from tpufluids_torch.binning import BinTable
from tpufluids_torch.config import PI_REF, SPHConfig, column_caps
from tpufluids_torch.state import ParticleState


def _on_cuda(state: ParticleState, bt: BinTable, order: torch.Tensor,
             cfg: SPHConfig, extra=()) -> bool:
    """Validate the arguments (and the (name, tensor, dtype, shape) of
    ``extra``); True for CUDA tensors, False for CPU tensors (the plain
    version runs)."""
    n = state.capacity
    dev = state.pos.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for {dev}")
    for name, t, dtype, shape in (
            ("pos", state.pos, torch.float32, (n, 3)),
            ("order", order, torch.int64, (n,)),
            ("bt.cid", bt.cid, torch.int32, (n,)),
            ("bt.in_dom", bt.in_dom, torch.bool, (n,)),
            ("bt.cell_start", bt.cell_start, torch.int32,
             (cfg.num_cells + 2,)), *extra):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, the pool on {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type == "cuda" and 4 * n >= 2 ** 31:
        raise ValueError("the kernels index rows with int32: the pool "
                         "must hold fewer than 2^31 / 4 rows")
    return dev.type == "cuda"


def _base_plain(state: ParticleState, bt: BinTable, cfg: SPHConfig,
                order: torch.Tensor, caps=None, stale=False):
    """(sum_w, dpress) in pool order from ``forces.pair_sums``."""
    rows = forces.pack_rows(state, order, bt.in_dom)
    sum_w, dpress = forces.pair_sums(rows, bt, cfg, caps, stale)
    return forces.to_pool(sum_w, order), forces.to_pool(dpress, order)


# lanes a home row in the base force kernels (kLanes of csrc/sph_forces.cu,
# which ``base_info`` reports), chosen by a probe on the card (PERF.md)
BASE_LANES = 4


@functools.cache
def base_info(device_index: int) -> dict:
    """The base force kernels' launch shape on CUDA device
    ``device_index``: lanes a home row, threads a block, and the blocks a
    multiprocessor keeps resident."""
    lib = _build.load()
    vals = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device_index):
        rc = lib.tf_sph_base_info(*map(ctypes.byref, vals))
    if rc:
        raise RuntimeError(f"tf_sph_base_info: CUDA error {rc} "
                           f"({lib.tf_error_string(rc).decode()})")
    return dict(zip(("lanes", "threads", "resident"),
                    (v.value for v in vals)))


def _base_on_cuda(state: ParticleState, bt: BinTable, order: torch.Tensor,
                  cfg: SPHConfig) -> bool:
    """``_on_cuda`` with the fields the pack kernel reads."""
    n = state.capacity
    return _on_cuda(state, bt, order, cfg, [
        ("vel", state.vel, torch.float32, (n, 3)),
        ("dens", state.dens, torch.float32, (n,)),
        ("press", state.press, torch.float32, (n,)),
        ("boundary", state.boundary, torch.bool, (n,)),
        ("alive", state.alive, torch.bool, (n,))])


def _pack_launch(state: ParticleState, bt: BinTable, cfg: SPHConfig,
                 order: torch.Tensor, stale: bool):
    n = state.capacity
    g = cfg.grid_size
    dev = state.pos.device
    rows = torch.empty((n, forces.ROW_WIDTH), dtype=torch.float32,
                       device=dev)
    cells = shift = None
    if stale:
        cells = torch.empty((n, 4), dtype=torch.float32, device=dev)
        shift = torch.zeros(g * g, dtype=torch.int32, device=dev)
    _build.launch("tf_sph_base_pack", state.pos, state.vel, state.dens,
                  state.press, state.boundary, state.alive, order, bt.in_dom,
                  bt.cid, rows, cells, shift, n, g, cfg.xmin, cfg.ymin,
                  cfg.zmin, cfg.cell_size)
    return rows, cells, shift


def base_pack(state: ParticleState, bt: BinTable, cfg: SPHConfig,
              order: torch.Tensor, stale: bool = False):
    """(rows, cells, shift): the sorted rows the base force kernels read
    (``forces.pack_rows``) and, ``stale``, the rows' current cells ((N,
    4): ``binning.cell_trunc`` and a zero) and each stale column's z-cell
    shift (``forces.column_shift``); None for both when fresh.  On the
    card one launch of the pack kernel of csrc/sph_forces.cu, equal to
    the plain versions bit for bit; the plain versions on CPU tensors.
    The two base wrappers launch it, and their launch counts cover it."""
    if _base_on_cuda(state, bt, order, cfg):
        return _pack_launch(state, bt, cfg, order, stale)
    rows = forces.pack_rows(state, order, bt.in_dom)
    if not stale:
        return rows, None, None
    cells = torch.nn.functional.pad(
        binning.cell_trunc(rows[:, 0:3], cfg), (0, 1))
    return rows, cells, forces.column_shift(rows, bt, cfg)


def _base_launch(entry: str, state: ParticleState, bt: BinTable,
                 cfg: SPHConfig, order: torch.Tensor, stale: bool, caps=()):
    """Launch the pack kernel and a base force kernel of
    csrc/sph_forces.cu; returns (sum_w, dpress) in pool order."""
    n = state.capacity
    h = cfg.cutoff
    rows, cells, shift = _pack_launch(state, bt, cfg, order, stale)
    sum_w = torch.empty(n, dtype=torch.float32, device=rows.device)
    dpress = torch.empty((n, 3), dtype=torch.float32, device=rows.device)
    _build.launch(entry, rows, cells, bt.cid, bt.cell_start, shift, order,
                  sum_w, dpress, n, cfg.grid_size, *caps, h, 2 * h,
                  PI_REF * h ** 3, -45.0 / (PI_REF * h ** 6), 0.01 * h * h,
                  cfg.alpha_fluid * cfg.sound,
                  cfg.visc_quadratic / cfg.sound, cfg.alpha_boundary,
                  cfg.bdensfactor)
    return sum_w, dpress


def base_forces_rowblock_plain(state: ParticleState, bt: BinTable,
                               cfg: SPHConfig, order: torch.Tensor,
                               stale: bool = False):
    """The plain version: ``forces.pair_sums`` on the tables of
    ``order``; returns (sum_w (N,), dpress (N, 3), overflow = 0)."""
    return (*_base_plain(state, bt, cfg, order, stale=stale),
            torch.zeros((), dtype=torch.int32, device=state.pos.device))


def base_forces_rowblock(state: ParticleState, bt: BinTable,
                         cfg: SPHConfig, order: torch.Tensor,
                         stale: bool = False):
    """Base-variant forces over the exact 27-cell stencil, as the JAX
    package's ``base_forces_rowblock``: ``state`` in pool order, ``bt``
    and ``order`` from ``binning.sort_tables``; returns (sum_w (N,),
    dpress (N, 3), overflow = 0) in pool order, zero for rows that are
    dead or outside the domain.  ``stale``: ``bt`` is an earlier step's
    (``binning.sort_by_cell``, the sort cadence); every row then keeps
    the candidates of its stale neighbour columns whose current cells are
    within one of its own.

    Replaces base_forces_rowblock (tpufluids/sph_pallas.py).  The TPU
    kernel's 128-row home blocks, DMA double buffer and chunk knobs are
    VMEM plumbing; on the card the pack kernel gathers the sorted rows
    (and, stale, their current cells and each column's z-cell shift),
    and ``BASE_LANES`` lanes of
    one warp own each sorted row, dealing its walked candidates round
    robin and joining their sums by a fixed shuffle butterfly
    (csrc/sph_forces.cu; ``forces.base_lane_pass`` emulates the order).
    The stale walk reads only each column's ``binning.stale_window``,
    which holds the whole column's pairs."""
    if cfg.variant != "base":
        raise ValueError("base_forces_rowblock takes the base variant")
    if not _base_on_cuda(state, bt, order, cfg):
        return base_forces_rowblock_plain(state, bt, cfg, order, stale)
    sum_w, dpress = _base_launch("tf_sph_base_forces", state, bt, cfg, order,
                                 stale)
    base_forces_rowblock.launches += 1
    return sum_w, dpress, torch.zeros((), dtype=torch.int32,
                                      device=sum_w.device)


def base_forces_column_plain(state: ParticleState, bt: BinTable,
                             cfg: SPHConfig, order: torch.Tensor,
                             stale: bool = False):
    """The plain version: ``forces.pair_sums`` over the capped column
    pair set; returns (sum_w (N,), dpress (N, 3), overflow)."""
    caps = column_caps(cfg)
    return (*_base_plain(state, bt, cfg, order, caps, stale),
            binning.column_overflow(bt, cfg, caps[0]))


def base_forces_column(state: ParticleState, bt: BinTable, cfg: SPHConfig,
                       order: torch.Tensor, stale: bool = False):
    """Base-variant forces of the column family, as the JAX package's
    ``base_forces_pallas``: the pairs of ``base_forces_rowblock`` (fresh
    or ``stale``), capped by ``config.column_caps``.  A row at rank b or
    more in its (x, y) column gets zeros, and only the first w_cap rows
    of each neighbour column are candidates.  Returns (sum_w (N,),
    dpress (N, 3), overflow), the overflow an int32 device scalar: the
    rows over the home cap, summed over the columns.

    Replaces base_forces_pallas (tpufluids/sph_pallas.py), one program
    per (x, y) column over capped VMEM window tiles.  On the card the
    row-block kernel's lanes and walk with the caps (csrc/sph_forces.cu):
    the TPU kernel's tiles, home chunks, z-skip and banded sweep leave its
    results unchanged and are not carried over."""
    if cfg.variant != "base":
        raise ValueError("base_forces_column takes the base variant")
    if not _base_on_cuda(state, bt, order, cfg):
        return base_forces_column_plain(state, bt, cfg, order, stale)
    caps = column_caps(cfg)
    sum_w, dpress = _base_launch("tf_sph_base_column", state, bt, cfg,
                                 order, stale, caps)
    base_forces_column.launches += 1
    return sum_w, dpress, binning.column_overflow(bt, cfg, caps[0])


# lanes a home row in the unidyn passes (kLanes of csrc/sph_unidyn.cu,
# which ``unidyn_info`` reports), chosen by a probe on the card (PERF.md)
UNIDYN_LANES = 32


@functools.cache
def unidyn_info(device_index: int) -> dict:
    """The unidyn passes' launch shape on CUDA device ``device_index``:
    lanes a home row, threads a block, and the blocks of pass A and of
    pass B a multiprocessor keeps resident."""
    lib = _build.load()
    vals = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device_index):
        rc = lib.tf_unidyn_info(*map(ctypes.byref, vals))
    if rc:
        raise RuntimeError(f"tf_unidyn_info: CUDA error {rc} "
                           f"({lib.tf_error_string(rc).decode()})")
    return dict(zip(("lanes", "threads", "resident_a", "resident_b"),
                    (v.value for v in vals)))


def _unidyn_on_cuda(state: ParticleState, bt: BinTable, order, cfg,
                    subbin_threshold) -> bool:
    if cfg.variant == "base":
        raise ValueError("the unidyn force kernels take the unidyn variant")
    n = state.capacity
    extra = [("delpress", state.delpress, torch.float32, (n, 3)),
             ("stress", state.stress, torch.float32, (n, 3, 3))]
    if subbin_threshold is not None:
        if bt.octant is None:
            raise ValueError("sub-binning needs the unidyn tables of "
                             "binning.sort_tables (bt.octant)")
        extra.append(("bt.octant", bt.octant, torch.int32, (n,)))
    return _on_cuda(state, bt, order, cfg, extra)


def _unidyn_pass_a(state: ParticleState, bt: BinTable, cfg: SPHConfig,
                   order, subbin_threshold, drift_sorted, caps=()):
    """Launch pass A; returns (rows, out_a (N, A_COLS) in pool order,
    merge partner (N,) pool rows or -1).  ``drift_sorted`` (N, 8) or None
    receives the drift velocities in sorted order.  ``caps`` (b, w_cap):
    the column family's pass."""
    n = state.capacity
    dev = state.pos.device
    h = cfg.cutoff
    rows = forces.pack_unidyn_rows(state, order, bt.in_dom, cfg)
    out_a = torch.empty((n, forces.A_COLS), dtype=torch.float32, device=dev)
    merge = cfg.merge_dist > 0
    partner = (torch.empty(n, dtype=torch.int64, device=dev) if merge
               else torch.full((n,), -1, dtype=torch.int64, device=dev))
    sub = subbin_threshold is not None
    _build.launch(
        "tf_unidyn_column_a" if caps else "tf_unidyn_pass_a", rows,
        state.delpress, state.stress, bt.cid, bt.cell_start, order,
        bt.octant if sub else None, out_a, partner if merge else None,
        drift_sorted, n, cfg.grid_size, subbin_threshold if sub else -1,
        *caps, h, 2 * h, PI_REF * h ** 3,
        -45.0 / (PI_REF * h ** 6), 0.01 * h * h, cfg.alpha_fluid, cfg.sound,
        cfg.visc_quadratic / cfg.sound, cfg.alpha_sand_boundary,
        cfg.bdensfactor, cfg.mixfactor_reg, cfg.rho0, cfg.rho0_sand,
        cfg.mix_frac_min, cfg.mix_frac_max, cfg.mixpressure,
        cfg.mixbrownian, cfg.gravity, cfg.merge_dist)
    return rows, out_a, partner


def _unidyn_pass_b(rows, drift_sorted, bt: BinTable, cfg: SPHConfig, order,
                   subbin_threshold, caps=()):
    """Launch pass B; returns out_b (N, B_COLS) in pool order."""
    n = rows.shape[0]
    h = cfg.cutoff
    sub = subbin_threshold is not None
    out_b = torch.empty((n, forces.B_COLS), dtype=torch.float32,
                        device=rows.device)
    _build.launch("tf_unidyn_column_b" if caps else "tf_unidyn_pass_b", rows,
                  drift_sorted, bt.cid, bt.cell_start, order,
                  bt.octant if sub else None, out_b, n, cfg.grid_size,
                  subbin_threshold if sub else -1, *caps, h, 2 * h,
                  -45.0 / (PI_REF * h ** 6))
    return out_b


def unidyn_forces_resident_plain(state: ParticleState, bt: BinTable,
                                 cfg: SPHConfig, order: torch.Tensor,
                                 subbin_threshold=None) -> dict:
    """The plain version: ``forces.unidyn_pair_pass`` on the tables of
    ``order``."""
    return forces.unidyn_pair_pass(state, bt._replace(order=order), cfg,
                                   subbin_threshold)


def unidyn_forces_resident(state: ParticleState, bt: BinTable,
                           cfg: SPHConfig, order: torch.Tensor,
                           subbin_threshold=None) -> dict:
    """Both unidyn pair passes, as the JAX package's
    ``unidyn_forces_resident``: ``state`` in pool order, ``bt`` and
    ``order`` from ``binning.sort_tables`` (unidyn); returns the result
    dict of ``forces.unidyn_result`` in pool order (overflow 0).

    Replaces unidyn_forces_resident (tpufluids/sph_pallas.py), which
    keeps the whole pool in VMEM and splices pass A's drifts into it for
    pass B.  On the card pass A (``UNIDYN_LANES`` lanes a sorted row)
    writes the drifts in sorted order and pass B, launched right after it
    on the same stream, reads them there (csrc/sph_unidyn.cu)."""
    if not _unidyn_on_cuda(state, bt, order, cfg, subbin_threshold):
        return unidyn_forces_resident_plain(state, bt, cfg, order,
                                            subbin_threshold)
    drift = torch.empty((state.capacity, 8), dtype=torch.float32,
                        device=state.pos.device)
    rows, out_a, partner = _unidyn_pass_a(state, bt, cfg, order,
                                          subbin_threshold, drift)
    out_b = _unidyn_pass_b(rows, drift, bt, cfg, order, subbin_threshold)
    unidyn_forces_resident.launches += 1
    return forces.unidyn_result(
        out_a, out_b, partner, state.dens,
        out_a[:, forces.A_SDV:forces.A_SDV + 3],
        out_a[:, forces.A_FDV:forces.A_FDV + 3])


def unidyn_forces_rowblock_plain(state: ParticleState, bt: BinTable,
                                 cfg: SPHConfig, order: torch.Tensor,
                                 drift_fix=None,
                                 subbin_threshold=None) -> dict:
    """The plain version: ``forces.unidyn_pair_pass`` on the tables of
    ``order``, with ``drift_fix`` between the passes."""
    return forces.unidyn_pair_pass(state, bt._replace(order=order), cfg,
                                   subbin_threshold, drift_fix)


def unidyn_forces_rowblock(state: ParticleState, bt: BinTable,
                           cfg: SPHConfig, order: torch.Tensor,
                           drift_fix=None, subbin_threshold=None) -> dict:
    """The unidyn pair passes as two calls with ``drift_fix`` between
    them, as the JAX package's ``unidyn_forces_rowblock``: ``drift_fix``
    maps (solid_drift, fluid_drift), (N, 3) each in pool order, to the
    drifts pass B reads.  Returns what ``unidyn_forces_resident`` does.

    Replaces unidyn_forces_rowblock (tpufluids/sph_pallas.py): the same
    two kernels of csrc/sph_unidyn.cu, with the drifts taken back to pool
    order for the hook and gathered by ``order`` for pass B."""
    if not _unidyn_on_cuda(state, bt, order, cfg, subbin_threshold):
        return unidyn_forces_rowblock_plain(state, bt, cfg, order, drift_fix,
                                            subbin_threshold)
    n = state.capacity
    rows, out_a, partner = _unidyn_pass_a(state, bt, cfg, order,
                                          subbin_threshold, None)
    sdv = out_a[:, forces.A_SDV:forces.A_SDV + 3]
    fdv = out_a[:, forces.A_FDV:forces.A_FDV + 3]
    if drift_fix is not None:
        sdv, fdv = drift_fix(sdv, fdv)
    drift = torch.cat([sdv, fdv, sdv.new_zeros((n, 2))], dim=1)[order]
    out_b = _unidyn_pass_b(rows, drift, bt, cfg, order, subbin_threshold)
    unidyn_forces_rowblock.launches += 1
    return forces.unidyn_result(out_a, out_b, partner, state.dens, sdv, fdv)


def unidyn_forces_column_plain(state: ParticleState, bt: BinTable,
                               cfg: SPHConfig, order: torch.Tensor,
                               subbin_threshold=None) -> dict:
    """The plain version: ``forces.unidyn_pair_pass`` over the capped
    column pair set, with the column overflow."""
    caps = column_caps(cfg)
    r = forces.unidyn_pair_pass(state, bt._replace(order=order), cfg,
                                subbin_threshold, caps=caps)
    r["overflow"] = binning.column_overflow(bt, cfg, caps[0])
    return r


def unidyn_forces_column(state: ParticleState, bt: BinTable,
                         cfg: SPHConfig, order: torch.Tensor,
                         subbin_threshold=None) -> dict:
    """Both unidyn pair passes of the column family, as the JAX package's
    ``unidyn_forces_pallas``: the pairs of ``unidyn_forces_resident``
    capped by ``config.column_caps``.  A row at rank b or more in its
    (x, y) column gets zeros (and pass B reads zero drift for it), and
    only the first w_cap rows of each neighbour column are candidates.
    Returns the result dict of ``forces.unidyn_result`` in pool order,
    with the overflow (rows over the home cap, summed over the columns)
    as an int32 device scalar.

    Replaces unidyn_forces_pallas (tpufluids/sph_pallas.py), whose two
    column kernels sweep capped VMEM window tiles and splice pass A's
    drifts into the packed pool for pass B.  On the card pass A
    (``UNIDYN_LANES`` lanes a sorted row) writes the drifts in sorted
    order and pass B, launched right after it, reads them there
    (csrc/sph_unidyn.cu, the resident passes with the caps)."""
    if not _unidyn_on_cuda(state, bt, order, cfg, subbin_threshold):
        return unidyn_forces_column_plain(state, bt, cfg, order,
                                          subbin_threshold)
    caps = column_caps(cfg)
    drift = torch.empty((state.capacity, 8), dtype=torch.float32,
                        device=state.pos.device)
    rows, out_a, partner = _unidyn_pass_a(state, bt, cfg, order,
                                          subbin_threshold, drift, caps)
    out_b = _unidyn_pass_b(rows, drift, bt, cfg, order, subbin_threshold,
                           caps)
    unidyn_forces_column.launches += 1
    r = forces.unidyn_result(
        out_a, out_b, partner, state.dens,
        out_a[:, forces.A_SDV:forces.A_SDV + 3],
        out_a[:, forces.A_FDV:forces.A_FDV + 3])
    r["overflow"] = binning.column_overflow(bt, cfg, caps[0])
    return r


KERNELS = (base_forces_rowblock, base_forces_column, unidyn_forces_resident,
           unidyn_forces_rowblock, unidyn_forces_column)


def reset_launches():
    for fn in KERNELS:
        fn.launches = 0


reset_launches()


def launch_counts(*names) -> dict:
    """Launch counts of the named wrappers (all of them by default)."""
    return {fn.__name__: fn.launches for fn in KERNELS
            if not names or fn.__name__ in names}
