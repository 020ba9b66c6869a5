"""Inputs of the base force kernels' lane schedule and stale window,
shared by the CPU tests (tests/test_torch_base_lanes.py) and the GPU
tests (tests/test_torch_sph_gpu.py); torch and numpy only, so that the
GPU tests run without JAX.

* ``blob_state``: 800 particles in [-0.2, 0.2]^3, 24 more outside the
  domain and 32 dead rows, about a sixth of them boundary, with dens,
  press and vel drawn from a seed;
* ``sorted_and_moved``: a pool sorted into cell order, its tables, and
  the pool moved since, by up to 0.4 of a cell on each axis; ``far``
  adds what the stale window must survive: a tenth of the rows moved by
  2-4 cells in z, one row by 12 cells, five rows out of the domain, one
  row to z = +inf and one to x = NaN.
"""

import numpy as np
import torch

from torch_unidyn_inputs import blob_positions
from tpufluids_torch import binning, state
from tpufluids_torch.config import BASE_CONFIG


def randomised(st, seed):
    """dens, press and vel drawn from ``seed``: at a scene's first step
    press = 0 and dpress would be 0."""
    n = st.capacity
    rng = np.random.default_rng(seed)
    dev = st.pos.device

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    return st.replace(dens=t(rng.uniform(9300.0, 9900.0, n)),
                      press=t(rng.normal(0.0, 3e4, n)),
                      vel=t(rng.normal(0.0, 0.5, (n, 3))))


def blob_state(device, seed=3):
    pos = blob_positions(seed)
    rng = np.random.default_rng(seed + 1)
    st = state.make_state(pos, boundary=rng.uniform(size=len(pos)) < 0.15,
                          cfg=BASE_CONFIG, capacity=len(pos) + 32,
                          device=device)
    return randomised(st, seed + 2)


def sorted_and_moved(st, cfg, seed, far=False):
    """(the pool sorted into cell order, its tables, the pool moved since):
    a stale step's inputs."""
    st, bt, _ = binning.sort_by_cell(st, cfg)
    n = st.capacity
    rng = np.random.default_rng(seed)
    shift = rng.uniform(-0.02, 0.02, (n, 3))
    if far:
        rows = rng.permutation(np.flatnonzero(bt.in_dom.cpu().numpy()))
        k = len(rows) // 10
        shift[rows[:k], 2] += (rng.choice([-1.0, 1.0], k)
                               * rng.uniform(0.1, 0.2, k))
        shift[rows[k], 2] += 0.6
        shift[rows[k + 1:k + 6], 0] += 2.5
        shift[rows[k + 6], 2] = np.inf
        shift[rows[k + 7], 0] = np.nan
    moved = st.pos + torch.from_numpy(shift.astype(np.float32)).to(
        st.pos.device)
    return st, bt, st.replace(pos=moved)
