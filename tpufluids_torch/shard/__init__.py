"""The x-slab sharding of ``tpufluids.shard`` over torch.distributed:
``make_mesh`` and ``spawn`` give the ranks, ``grid_sharded`` the grid
step's layout and ``make_sharded_step``, and ``particles`` the sharded
SPH step (``particles.make_sharded_step``, ``distribute``,
``collect``)."""

from tpufluids_torch.shard import particles
from tpufluids_torch.shard.grid_sharded import (collect, from_sharded_layout,
                                                make_sharded_step,
                                                shard_state,
                                                to_sharded_layout)
from tpufluids_torch.shard.mesh import Mesh, make_mesh, spawn

__all__ = ["Mesh", "collect", "from_sharded_layout", "make_mesh",
           "make_sharded_step", "particles", "shard_state", "spawn",
           "to_sharded_layout"]
