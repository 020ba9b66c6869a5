"""Cell-grid neighbour binning: the sort tables of ``tpufluids.binning``
in PyTorch.

Per step the pool is sorted by linear cell id (z fastest).  The pool
itself is not permuted: ``sort_tables`` returns the permutation
``order`` and the sorted tables, and the force pass gathers what it
needs by ``order``.  ``sort_by_cell`` permutes it: the sort cadence
(``sort_every > 1``), so that the steps between two sorts read the pool
in the sorted order of their stale tables, the XLA pair path and the
sharded step, as the JAX package's do.  Dead
and out-of-domain particles get the sentinel id ``num_cells`` and sort
to the end, so no neighbour run holds them.

One (x, y) column of the grid, g consecutive cells, is one contiguous
range of sorted rows from ``column_start``; the column force family
caps the rows it takes of each column (``config.column_caps``).

The grid is the full cube or, under x-slab sharding
(``shard.particles``), a ``GridSpec`` of ``x_planes`` planes from global
plane ``x_offset``: cell ids are local to it, and rows outside it take
the sentinel.  The tables carry their grid (``BinTable.grid``), so the
neighbour runs and the force kernels read its extent from them.

Cell coordinates truncate toward zero, like the reference's ``int()``
cast (FluidGPU.cu:419) and the JAX package's binning.  (The JAX
row-block Pallas kernel floors instead; the two differ only in the
one-cell band just below a low face, ROADMAP Queue 3.)  A NaN
coordinate becomes cell 0, as XLA's and CUDA's float-to-int casts make
it.

The unidyn variant, and the base variant when sub-binning is asked for,
also get each sorted row's home-cell population and sub-bin octant
(``home_count``, ``octant``), which the two-level binning reads; the
base step computes neither.

Nothing here synchronises the host with the device: the tables stay
device tensors of static shape.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tpufluids_torch.config import SPHConfig
from tpufluids_torch.state import FIELDS, ParticleState

# The 9 (dx, dy) run offsets of the 27-cell stencil.
RUN_OFFSETS = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]


class GridSpec(NamedTuple):
    """Binning-grid extent: the full cube, or a local x-slab (its owned
    planes and one halo plane a side) under the domain decomposition of
    ``shard.particles``."""
    g: int          # y/z extent (= cfg.grid_size)
    x_planes: int   # number of x planes covered
    x_offset: int   # global cx of local plane 0

    @property
    def num_cells(self) -> int:
        return self.x_planes * self.g * self.g


def full_grid(cfg: SPHConfig) -> GridSpec:
    return GridSpec(g=cfg.grid_size, x_planes=cfg.grid_size, x_offset=0)


def _check_grid(cfg: SPHConfig, grid: Optional[GridSpec]) -> GridSpec:
    """``grid``, or the full cube for None; a slab's y/z extent must be
    the configuration's."""
    if grid is None:
        return full_grid(cfg)
    if grid.g != cfg.grid_size or grid.x_planes < 1:
        raise ValueError(f"{grid}: a slab of grid_size {cfg.grid_size} "
                         f"needs g = {cfg.grid_size} and x_planes >= 1")
    return grid


def _shifted(pos: torch.Tensor, cfg: SPHConfig):
    """(pos - domain minimum, the cell size as a device scalar).  Divide
    by the device scalar: on CUDA, torch turns a division by a Python
    number into a multiplication by its reciprocal, which can move a
    particle on a cell face into the next cell."""
    shifted = torch.stack([pos[:, 0] - cfg.xmin, pos[:, 1] - cfg.ymin,
                           pos[:, 2] - cfg.zmin], dim=1)
    return shifted, torch.full((), cfg.cell_size, dtype=pos.dtype,
                               device=pos.device)


def cell_trunc(pos: torch.Tensor, cfg: SPHConfig) -> torch.Tensor:
    """(N, 3) float cell coordinates, truncated toward zero; NaN stays
    NaN.  The stale force passes compare these per pair."""
    shifted, cs = _shifted(pos, cfg)
    return torch.trunc(shifted / cs)


def cell_coords(pos: torch.Tensor, cfg: SPHConfig) -> torch.Tensor:
    """(N, 3) int32 cell coordinates, truncated toward zero like
    ``int((x - XMIN)/CELLSIZE)`` (FluidGPU.cu:419)."""
    c = cell_trunc(pos, cfg)
    if c.device.type == "cpu":
        # torch's CPU cast turns NaN into INT_MIN; XLA's, and CUDA's
        # (so the card's step, with no op added), turn it into 0
        c = torch.nan_to_num(c, nan=0.0)
    return c.to(torch.int32)


def octant(pos: torch.Tensor, cfg: SPHConfig) -> torch.Tensor:
    """(N,) int32 sub-bin octant id (FluidGPU-unidyn.cu:182-184), as
    ``tpufluids.binning.octant``: bit0 = x in the upper half of its cell,
    bit1 = y upper half, bit2 = z *lower* half (the reference's inverted
    z test).  Divides, like ``cell_coords``, and adds the float32 half
    cell, as the JAX package does op by op."""
    shifted, cs = _shifted(pos, cfg)
    upper = torch.trunc(shifted / cs) != torch.trunc((shifted + cs / 2) / cs)
    return (upper[:, 0].to(torch.int32) + 2 * upper[:, 1].to(torch.int32)
            + 4 * (~upper[:, 2]).to(torch.int32))


def cell_id(pos: torch.Tensor, alive: torch.Tensor, cfg: SPHConfig,
            grid: Optional[GridSpec] = None):
    """(linear cell id, in_dom): int32 ids local to ``grid``, z fastest;
    dead particles and those outside the grid get the sentinel
    ``num_cells``."""
    grid = _check_grid(cfg, grid)
    g = grid.g
    c = cell_coords(pos, cfg)
    lx = c[:, 0] - grid.x_offset
    in_dom = ((lx >= 0) & (lx < grid.x_planes)
              & ((c[:, 1:] >= 0) & (c[:, 1:] < g)).all(dim=1))
    lin = (lx * g + c[:, 1]) * g + c[:, 2]
    return torch.where(in_dom & alive, lin, grid.num_cells), in_dom


class BinTable(NamedTuple):
    """Sorted-order binning tables for one step."""
    order: torch.Tensor       # (N,) int64: pool row of each sorted row
    cid: torch.Tensor         # (N,) int32 sorted ids (sentinel num_cells)
    in_dom: torch.Tensor      # (N,) bool, sorted: alive and in the domain
    cell_start: torch.Tensor  # (num_cells + 2,) int32 first row of cell c
    grid: GridSpec            # the extent the ids are local to
    # unidyn or sub-binned only (else None), sorted:
    home_count: Optional[torch.Tensor] = None  # (N,) int32 own-cell rows
    octant: Optional[torch.Tensor] = None      # (N,) int32, see octant()


def sort_tables(state: ParticleState, cfg: SPHConfig,
                grid: Optional[GridSpec] = None, subbin: bool = False):
    """Sorted-order binning tables without permuting the pool; returns
    (order, BinTable), as ``tpufluids.binning.sort_tables``.

    The sort key is the int64 ``cid * n + row``: keys are unique, so the
    order is the stable order by cell id, which both branches of the JAX
    package give (its int32 packed key below 33554 rows, its stable
    argsort above).  ``cell_start[c]`` is the number of sorted ids
    below c, from a binary search of the sorted ids (equal to the JAX
    package's histogram and cumsum; ``torch.bincount`` would synchronise
    the host on a CUDA device).  ``home_count`` and ``octant`` are
    filled for the unidyn variant, and for the base variant with
    ``subbin`` (its sub-binned pair pass)."""
    grid = _check_grid(cfg, grid)
    cid, _ = cell_id(state.pos, state.alive, cfg, grid)
    n = cid.shape[0]
    rows = torch.arange(n, dtype=torch.int64, device=cid.device)
    _, order = torch.sort(cid.to(torch.int64) * n + rows)
    scid = cid[order]
    cells = torch.arange(grid.num_cells + 2, dtype=torch.int32,
                         device=cid.device)
    cell_start = torch.searchsorted(scid, cells, out_int32=True)
    in_dom = scid < grid.num_cells
    bt = BinTable(order=order, cid=scid, in_dom=in_dom,
                  cell_start=cell_start, grid=grid)
    if cfg.variant != "base" or subbin:
        cc = torch.clamp(scid, max=grid.num_cells).to(torch.int64)
        home_count = torch.where(in_dom, cell_start[cc + 1] - cell_start[cc],
                                 0)
        bt = bt._replace(home_count=home_count,
                         octant=octant(state.pos, cfg)[order])
    return order, bt


def sort_by_cell(state: ParticleState, cfg: SPHConfig,
                 grid: Optional[GridSpec] = None, subbin: bool = False):
    """The pool permuted into cell order, its tables and the permutation:
    (state, BinTable, perm), as ``tpufluids.binning.sort_by_cell``.  The
    tables are those of ``sort_tables`` (the port builds neighbour runs
    on demand, ``run_table``, or clipped as the JAX package builds them,
    ``clipped_runs``), with ``order`` the identity: pool row and sorted
    row are now one.  ``perm`` (int64) is the sort's own order, row r of
    the new pool being row perm[r] of ``state``: the sharded step takes
    values back to its pre-sort rows by it."""
    perm, bt = sort_tables(state, cfg, grid, subbin)
    return permute_pool(state, perm), bt._replace(
        order=torch.arange(state.capacity, dtype=torch.int64,
                           device=perm.device)), perm


def permute_pool(state: ParticleState, order: torch.Tensor) -> ParticleState:
    """Every field of the pool gathered by ``order`` (row r of the result
    is row order[r] of ``state``)."""
    return state.replace(**{f: getattr(state, f)[order] for f in FIELDS})


def column_start(bt: BinTable, cfg: SPHConfig) -> torch.Tensor:
    """(x_planes*g + 1,) first sorted row of each (x, y) column of the
    tables' grid, and the end."""
    return bt.cell_start[0:bt.grid.num_cells + 1:bt.grid.g]


def column_overflow(bt: BinTable, cfg: SPHConfig, b: int) -> torch.Tensor:
    """() int32: the rows beyond the home cap ``b``, summed over the
    columns; the column family gives them no forces."""
    cs = column_start(bt, cfg)
    return torch.clamp(cs[1:] - cs[:-1] - b, min=0).sum().to(torch.int32)


def suggest_col_cap(state: ParticleState, cfg: SPHConfig,
                    headroom: float = 1.25, minimum: int = 64) -> int:
    """A static ``pallas_col_cap`` for a scene, as
    ``tpufluids.binning.suggest_col_cap``: the smallest multiple of 8 at
    or above ``headroom`` times the fullest column's population, and at
    least ``minimum``.  Host-side (it reads the state back): call it once
    on the initial state."""
    cid, _ = cell_id(state.pos, state.alive, cfg)
    g = cfg.grid_size
    col = cid.cpu().numpy() // g
    col = col[state.alive.cpu().numpy()]
    col = col[col < g * g]
    occ = (np.bincount(col.astype(np.int64), minlength=g * g).max()
           if col.size else 0)
    want = int(np.ceil(occ * headroom / 8.0) * 8)
    return max(minimum, want)


def stale_window(cz: torch.Tensor, d: torch.Tensor, g: int):
    """(z0, z1) int64: the cells of a stale neighbour column that the
    stale force kernels walk (``tf_sph::stale_window``,
    csrc/sph_common.cuh), for a home row now at z-cell ``cz`` (float,
    ``cell_trunc``) and a column whose rows moved at most ``d`` z-cells
    (int, ``forces.column_shift``; d >= g: the whole column).  A kept
    candidate's stale z-cell lies in [cz - 1 - d, cz + 1 + d].  cz is
    clamped to [-2g - 2, 2g + 2] before it becomes an int, and NaN (a
    home that keeps no pair) goes to the low end.  Empty where z0 > z1."""
    edge = 2.0 * g + 2.0
    c = torch.clamp(torch.where(torch.isnan(cz), -edge, cz), -edge,
                    edge).to(torch.int64)
    whole = d >= g
    return (torch.where(whole, 0, torch.clamp(c - 1 - d, min=0)),
            torch.where(whole, g - 1, torch.clamp(c + 1 + d, max=g - 1)))


def run_table(bt: BinTable, cfg: SPHConfig, caps=None, whole=False,
              window=None):
    """(run_start, run_len), each (N, 9) int64 in sorted order: the 9
    (dx, dy) neighbour runs of cells (z-1, z, z+1) of every sorted row,
    in RUN_OFFSETS order, as ``tpufluids.binning.build_bins`` builds
    them but without its ``3 * max_per_cell`` clip (``clipped_runs``
    adds it), over the tables' grid (a slab's runs end at its x
    planes).  Rows outside the grid have runs of length 0.  Used by the
    plain force versions.

    ``whole``: each run is the whole neighbour column (the stale
    passes, which mask pairs by their current cells instead).
    ``window`` = (cz (N,) the sorted rows' current z-cells, shift
    (x_planes*g,) each column's z-cell shift): each run is the
    ``stale_window`` of its column, the stale force kernels' walk.
    ``caps`` = (b, w_cap): the column family's pair set.  A row at rank b
    or more in its column gets no runs, and a run ends at rank w_cap of
    its column."""
    g, gx, num_cells = bt.grid.g, bt.grid.x_planes, bt.grid.num_cells
    cid = bt.cid.to(torch.int64)
    valid_home = cid < num_cells
    cc = torch.clamp(cid, max=num_cells - 1)
    cz = cc % g
    cy = (cc // g) % g
    cx = cc // (g * g)
    cs = bt.cell_start.to(torch.int64)
    if caps is not None:
        rank = torch.arange(cid.shape[0], device=cid.device) - cs[cc - cz]
        valid_home = valid_home & (rank < caps[0])
    off = torch.tensor(RUN_OFFSETS, dtype=torch.int64, device=cid.device)
    nx = cx[:, None] + off[:, 0]
    ny = cy[:, None] + off[:, 1]
    valid = ((nx >= 0) & (nx < gx) & (ny >= 0) & (ny < g)
             & valid_home[:, None])
    base = nx * (g * g) + ny * g
    if whole:
        lo_cell, hi_cell = base, base + g
    elif window is not None:
        col = torch.clamp(nx * g + ny, 0, gx * g - 1)
        z0, z1 = stale_window(window[0][:, None],
                              window[1].to(torch.int64)[col], g)
        valid = valid & (z0 <= z1)
        lo_cell, hi_cell = base + z0, base + z1 + 1
    else:
        lo_cell = base + torch.clamp(cz - 1, min=0)[:, None]
        hi_cell = base + torch.clamp(cz + 1, max=g - 1)[:, None] + 1
    lo = cs[torch.clamp(lo_cell, 0, num_cells)]
    hi = cs[torch.clamp(hi_cell, 0, num_cells + 1)]
    if caps is not None:
        end = cs[torch.clamp(base, 0, num_cells)] + caps[1]
        lo, hi = torch.minimum(lo, end), torch.minimum(hi, end)
    return lo, torch.where(valid, hi - lo, 0)


def clipped_runs(bt: BinTable, cfg: SPHConfig):
    """(run_start, run_len, overflow): the runs of ``run_table`` with the
    clip of ``tpufluids.binning.build_bins``, each run cut to its first
    ``3 * max_per_cell`` rows (the highest sorted rows dropped), and the
    slots dropped, summed over the runs, as an int32 device scalar.  The
    XLA pair path reads these."""
    k3 = 3 * cfg.max_per_cell
    run_start, run_len = run_table(bt, cfg)
    overflow = torch.clamp(run_len - k3, min=0).sum().to(torch.int32)
    return run_start, torch.clamp(run_len, max=k3), overflow
