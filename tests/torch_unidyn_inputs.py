"""Mixed-phase inputs of the unidyn pair passes, shared by the lane
schedule's CPU tests (tests/test_torch_unidyn_lanes.py) and the kernels'
GPU tests (tests/test_torch_unidyn_gpu.py); torch and numpy only, so that
the GPU tests run without JAX.

Each input is (state, cfg, subbin_threshold, caps, drift_fix):

* ``tank``: the reference tank cut to 2808 particles, sub-binned, no
  merging;
* ``blob``: 800 particles in a 0.4 cube, 24 more outside the domain and
  32 dead rows, sub-binned, merging on;
* ``blob-full``: the blob over the full 27-cell stencil;
* ``blob-fix``: the blob with a drift fix between the passes;
* ``capped``: the blob in the column family at a cap of 24 rows, over
  which its columns run;
* ``lattice``: an 8^3 lattice at spacing 0.025 with merge_dist 0.03,
  where most rows have several nearest partners at one distance (its
  cells hold up to 125 rows, and a row walks up to 512 slots).
"""

import numpy as np
import torch

from tpufluids_torch import scenes, state
from tpufluids_torch.config import UNIDYN_CONFIG, column_caps

NAMES = ("tank", "blob", "blob-full", "blob-fix", "capped", "lattice")
MERGE = 0.03


def drift_fix(s, f):
    return s * 0.5, f * 2.0


def blob_positions(seed=3, n=800, outside=24):
    """``n`` positions in [-0.2, 0.2]^3 and ``outside`` out of the domain:
    |coordinate| in (1.2, 1.3), beyond the faces of [-1, 1.04]^3 and the
    band of one cell below the low faces that truncation bins in."""
    rng = np.random.default_rng(seed)
    out = rng.uniform(1.2, 1.3, (outside, 3)) * rng.choice([-1.0, 1.0],
                                                           (outside, 3))
    return np.concatenate([rng.uniform(-0.2, 0.2, (n, 3)), out]).astype(
        np.float32)


def lattice_positions(m=8, spacing=0.025, origin=-0.11):
    k = np.arange(m)
    grid = np.stack(np.meshgrid(k, k, k, indexing="ij"), -1).reshape(-1, 3)
    return (origin + spacing * grid).astype(np.float32)


def unidyn_input(name, device):
    """(state, cfg, subbin_threshold, caps, drift_fix) of input ``name``."""
    cfg = UNIDYN_CONFIG.replace(merge_dist=MERGE)
    if name == "tank":
        cfg = UNIDYN_CONFIG
        st = scenes.unidyn_tank(cfg, nf=2000, nb=808, device=device)
        return scenes.mixed_phase(st, 1), cfg, 6, None, None
    if name == "lattice":
        st = state.make_state(lattice_positions(), cfg=cfg, device=device)
        return scenes.mixed_phase(st, 4), cfg, 6, None, None
    pos = blob_positions()
    rng = np.random.default_rng(5)
    st = state.make_state(pos, rng.normal(0.0, 0.5, pos.shape),
                          boundary=rng.uniform(size=len(pos)) < 0.15,
                          cfg=cfg, capacity=len(pos) + 32, device=device)
    st = scenes.mixed_phase(st, 2)
    if name == "capped":
        cfg = cfg.replace(pallas_col_cap=24)
        return st, cfg, 6, column_caps(cfg), None
    return (st, cfg, None if name == "blob-full" else 6, None,
            drift_fix if name == "blob-fix" else None)


def columns(r, fields):
    """Every output column of the result dict ``r``, (N,) each."""
    return [c for k in fields for c in r[k].reshape(r[k].shape[0], -1).T]


def held(got, want, fields, tol):
    """(worst column error over max|want| on the rows where ``want`` is
    finite, columns equal bit for bit, columns); NaN rows (dead rows'
    dens is 0) must match.  Fails on a column of ``want`` that is 0."""
    worst, same, cols = 0.0, 0, 0
    for g, w in zip(columns(got, fields), columns(want, fields)):
        ok = torch.isfinite(w)
        assert torch.equal(ok, torch.isfinite(g))
        scale = float(w[ok].abs().max())
        assert scale > 0.0
        worst = max(worst, float((g[ok] - w[ok]).abs().max()) / scale)
        same += int(torch.equal(g[ok], w[ok]))
        cols += 1
    assert worst <= tol, worst
    return worst, same, cols
