"""The x-slab sharded grid step over torch.distributed: the port of
``tpufluids.shard`` (its grid half; the sharded SPH step is not ported
yet).  ``make_mesh`` and ``spawn`` give the ranks, ``grid_sharded`` the
layout and ``make_sharded_step``."""

from tpufluids_torch.shard.grid_sharded import (collect, from_sharded_layout,
                                                make_sharded_step,
                                                shard_state,
                                                to_sharded_layout)
from tpufluids_torch.shard.mesh import Mesh, make_mesh, spawn

__all__ = ["Mesh", "collect", "from_sharded_layout", "make_mesh",
           "make_sharded_step", "shard_state", "spawn", "to_sharded_layout"]
