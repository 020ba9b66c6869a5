"""The hand-written CUDA kernel of the SPH base step, beside its plain
PyTorch version: the counterpart of ``tpufluids/sph_pallas.py`` for the
row-block family.

``base_forces_rowblock`` replaces the Pallas kernel of the same name
(``_base_rowblock_kernel``): ``sum_w`` and ``dpress`` of every particle
over its exact 27-cell stencil, with no capacity cap, in pool order.
The wrapper packs the sorted rows with one gather by ``order``
(``forces.pack_rows``), launches ``csrc/sph_forces.cu`` (one thread per
sorted row, which writes its results at its pool index) and counts the
launch in ``base_forces_rowblock.launches``.  It runs the plain version
when its tensors lie on the CPU; any other device raises, and so does a
failed build or launch: nothing falls back from the kernel.
"""

from __future__ import annotations

import torch

from tpufluids_torch import _build, forces
from tpufluids_torch.binning import BinTable
from tpufluids_torch.config import PI_REF, SPHConfig
from tpufluids_torch.state import ParticleState


def _on_cuda(state: ParticleState, bt: BinTable, order: torch.Tensor,
             cfg: SPHConfig) -> bool:
    """Validate the arguments; True for CUDA tensors, False for CPU
    tensors (the plain version runs)."""
    if cfg.variant != "base":
        raise ValueError("base_forces_rowblock takes the base variant")
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
             (cfg.num_cells + 2,))):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, the pool on {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type == "cuda" and 3 * n >= 2 ** 31:
        raise ValueError("the kernel indexes rows with int32: the pool "
                         "must hold fewer than 2^31 / 3 rows")
    return dev.type == "cuda"


def base_forces_rowblock_plain(state: ParticleState, bt: BinTable,
                               cfg: SPHConfig, order: torch.Tensor):
    """The plain version: ``forces.compute_forces`` on the tables of
    ``order``; returns (sum_w (N,), dpress (N, 3), overflow = 0)."""
    acc = forces.compute_forces(state, bt._replace(order=order), cfg)
    return acc.sum_w, acc.dpress, torch.zeros((), dtype=torch.int32,
                                              device=state.pos.device)


def base_forces_rowblock(state: ParticleState, bt: BinTable,
                         cfg: SPHConfig, order: torch.Tensor):
    """Base-variant forces over the exact 27-cell stencil, as the JAX
    package's ``base_forces_rowblock``: ``state`` in pool order, ``bt``
    and ``order`` from ``binning.sort_tables``; returns (sum_w (N,),
    dpress (N, 3), overflow = 0) in pool order, zero for rows that are
    dead or outside the domain.

    Replaces base_forces_rowblock (tpufluids/sph_pallas.py).  The TPU
    kernel's 128-row home blocks, DMA double buffer and chunk knobs are
    VMEM plumbing; on the card one thread per sorted row loops over its
    9 neighbour runs from device memory, and the loads of neighbouring
    threads, which share most of their candidates, hit the caches
    (csrc/sph_forces.cu)."""
    if not _on_cuda(state, bt, order, cfg):
        return base_forces_rowblock_plain(state, bt, cfg, order)
    n = state.capacity
    h = cfg.cutoff
    rows = forces.pack_rows(state, order, bt.in_dom)
    sum_w = torch.empty(n, dtype=torch.float32, device=rows.device)
    dpress = torch.empty((n, 3), dtype=torch.float32, device=rows.device)
    _build.launch("tf_sph_base_forces", rows, bt.cid, bt.cell_start, order,
                  sum_w, dpress, n, cfg.grid_size, h, 2 * h,
                  PI_REF * h ** 3, -45.0 / (PI_REF * h ** 6), 0.01 * h * h,
                  cfg.alpha_fluid * cfg.sound,
                  cfg.visc_quadratic / cfg.sound, cfg.alpha_boundary,
                  cfg.bdensfactor)
    base_forces_rowblock.launches += 1
    return sum_w, dpress, torch.zeros((), dtype=torch.int32,
                                      device=rows.device)


base_forces_rowblock.launches = 0

KERNELS = (base_forces_rowblock,)


def reset_launches():
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
