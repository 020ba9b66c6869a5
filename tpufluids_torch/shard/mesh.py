"""A 1-D mesh of ranks over torch.distributed: the port's counterpart of
``tpufluids.shard.mesh.make_mesh`` and of the collectives the sharded
grid and SPH steps call inside ``shard_map`` (``ppermute``,
``psum_scatter``, ``psum``, ``pmax``).

A world of 1 needs no process group: its collectives are the identity,
as JAX's 1-device mesh skips them.  A larger world needs an initialised
group (``spawn`` makes one), whose backend is the caller's choice:

- ``nccl``: device tensors go to the collectives directly; one card a
  rank, so a world larger than the card count raises.
- ``gloo``: a CUDA tensor is copied to host memory, exchanged and copied
  back, explicitly (the reference's own halo exchange, host-staged
  ``cudaMemcpy`` of one plane, solver-unidyn.cu:187-212).  Several ranks
  may then share one card.  ``Mesh.staged_bytes`` counts the bytes
  copied between card and host.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist
import torch.multiprocessing

# how long a rank waits for the others in a collective before it fails
TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass
class Mesh:
    """One rank's view of the 1-D mesh: its rank, the world size, the
    process group (None for a world of 1), and the device its slabs live
    on."""
    rank: int
    size: int
    group: Optional[object]
    device: torch.device
    staged_bytes: int = 0

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the backend takes it: a host copy of a CUDA tensor
        for gloo, else ``t`` itself (contiguous)."""
        t = t.contiguous()
        if t.is_cuda and self.backend == "gloo":
            self.staged_bytes += t.nbytes
            return t.cpu()
        return t

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        if t.device != self.device:
            self.staged_bytes += t.nbytes
            return t.to(self.device)
        return t

    def _empty_like(self, t, shape=None):
        dev = torch.device("cpu") if (t.is_cuda and self.backend == "gloo") \
            else t.device
        return torch.empty(t.shape if shape is None else shape,
                           dtype=t.dtype, device=dev)

    def shift(self, t: torch.Tensor, direction: int) -> torch.Tensor:
        """Send ``t`` to rank + direction along the ring and return what
        rank - direction sent (``jax.lax.ppermute`` with the ring's
        permutation)."""
        if self.size == 1:
            return t
        send = self._out(t)
        recv = self._empty_like(t)
        ops = [dist.P2POp(dist.isend, send,
                          (self.rank + direction) % self.size, self.group),
               dist.P2POp(dist.irecv, recv,
                          (self.rank - direction) % self.size, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return self._back(recv)

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks and return this rank's block of rows
        (``jax.lax.psum_scatter(..., scatter_dimension=0, tiled=True)``)."""
        if self.size == 1:
            return t
        if t.shape[0] % self.size:
            raise ValueError(f"{t.shape[0]} rows do not split over "
                             f"{self.size} ranks")
        send = self._out(t)
        recv = self._empty_like(t, (t.shape[0] // self.size,) + t.shape[1:])
        dist.reduce_scatter_tensor(recv, send, op=dist.ReduceOp.SUM,
                                   group=self.group)
        return self._back(recv)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``t`` over the ranks (``pmax``)."""
        return self._all_reduce(t, dist.ReduceOp.MAX)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of ``t`` over the ranks (``psum``)."""
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.size == 1:
            return t
        buf = self._out(t)
        if buf is t:                    # not staged: reduce into a copy
            buf = t.clone()
        dist.all_reduce(buf, op=op, group=self.group)
        return self._back(buf)

    def gather(self, t: torch.Tensor) -> Optional[list]:
        """Every rank's ``t`` on rank 0, in rank order (None elsewhere)."""
        if self.size == 1:
            return [t]
        send = self._out(t)
        bufs = ([self._empty_like(t) for _ in range(self.size)]
                if self.rank == 0 else None)
        dist.gather(send, bufs, dst=0, group=self.group)
        return None if bufs is None else [self._back(b) for b in bufs]


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The 1-D mesh of this process: a world of 1 without a process group,
    or the initialised default group's world (``n_devices``, if given,
    must match it).  ``device`` "cuda" puts a rank on card rank % count
    (nccl: one card a rank); "cpu" keeps its slabs in host memory."""
    if dist.is_available() and dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        group = dist.group.WORLD
        backend = dist.get_backend(group)
    else:
        size, rank, group, backend = 1, 0, None, None
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"need a world of {n_devices}, have {size}: a world above 1 "
            f"runs in the processes of an initialised group (spawn)")
    device = torch.device(device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device: pass device='cpu'")
        if backend == "nccl" and size > count:
            raise ValueError(f"nccl runs one rank a card: {size} ranks, "
                             f"{count} cards (gloo shares a card)")
        device = torch.device("cuda", rank % count)
    elif device.type != "cpu":
        raise ValueError(f"slabs live on 'cuda' or 'cpu', not {device}")
    elif backend == "nccl":
        raise ValueError("nccl exchanges CUDA tensors only")
    return Mesh(rank=rank, size=size, group=group, device=device)


def _rank_main(rank, world, backend, store_path, fn, args):
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn(world: int, fn, *args, backend: str):
    """Run ``fn(*args)`` in ``world`` new processes (torch.multiprocessing,
    start method spawn), each inside an initialised process group of
    that world over ``backend``, its rank from ``dist.get_rank()``.  The
    ranks meet through a FileStore in a fresh temporary directory, not a
    TCP port.  ``fn`` must be importable by name.  Returns when every
    rank has returned; a rank's exception raises here."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    with tempfile.TemporaryDirectory(prefix="tpufluids_mesh_") as tmp:
        torch.multiprocessing.start_processes(
            _rank_main, args=(world, backend, os.path.join(tmp, "store"), fn,
                              args),
            nprocs=world, join=True, start_method="spawn")
