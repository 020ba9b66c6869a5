"""Times the port's SPH force kernels on the full cube for one checkout
on one NVIDIA GPU, so that two commits can be compared on one card in
one call:

    python3 ab_sph.py <checkout>

run from the root of this repository, with <checkout> a directory that
holds a tree of the repository (this one, ".", or another commit
unpacked by `git archive`, e.g. into build/parent).  The kernels and the
timing helpers (chip_smoke.py's) are the checkout's.  Alternate the
trees (parent, change, change, parent) to see the spread.

It prints one line: the device time of the force kernels alone
(torch.profiler) of the row-block base kernel at the 262144-particle
fill and of the resident unidyn passes on the mixed-phase tank; a digest
of the outputs of every cube instance on seeded inputs (base row-block
and column, fresh and stale, at base_dam; the unidyn resident, row-block
with a drift fix, and column passes on the mixed tank), equal between
two checkouts exactly when their results are bit for bit; and the
card's name and power limit."""

import hashlib
import json
import os
import sys

import numpy as np
import torch

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)

import chip_smoke as cs  # noqa: E402
from tpufluids_torch import (binning, config, scenes,  # noqa: E402
                             sph_kernels, state)

FILL = 262144


def _randomised(st, seed):
    rng = np.random.default_rng(seed)
    n = st.capacity

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(st.pos.device)

    return st.replace(dens=t(rng.uniform(9300.0, 9900.0, n)),
                      press=t(rng.normal(0.0, 3e4, n)),
                      vel=t(rng.normal(0.0, 0.5, (n, 3))))


def _digest(h, out):
    tensors = out.values() if isinstance(out, dict) else out
    for t in tensors:
        if isinstance(t, torch.Tensor):
            h.update(t.detach().contiguous().cpu().numpy().tobytes())


def main():
    if not torch.cuda.is_available():
        print("ab_sph: no CUDA device", file=sys.stderr)
        return 2
    if not sph_kernels.__file__.startswith(root):
        raise RuntimeError(f"{sph_kernels.__file__} is not under {root}")
    dev = torch.device("cuda")
    base = config.BASE_CONFIG
    h = hashlib.sha256()
    out = {}

    dam = _randomised(scenes.base_dam(base, device=dev), 3)
    for cfg in (base, base.replace(pallas_col_cap=32)):
        order, bt = binning.sort_tables(dam, cfg)
        sorted_, bt_s = binning.sort_by_cell(dam, cfg)[:2]
        moved = sorted_.replace(pos=sorted_.pos + 0.01)
        for fn in (sph_kernels.base_forces_rowblock,
                   sph_kernels.base_forces_column):
            _digest(h, fn(dam, bt, cfg, order))
            _digest(h, fn(moved, bt_s, cfg, bt_s.order, True))

    pos = np.random.default_rng(0).uniform(-0.9, 0.9, (FILL, 3))
    fill = _randomised(state.make_state(pos.astype(np.float32), cfg=base,
                                        device=dev), 4)
    order, bt = binning.sort_tables(fill, base)

    def call():
        return sph_kernels.base_forces_rowblock(fill, bt, base, order)

    _digest(h, call())
    out["base_forces_rowblock, fill, alone"] = cs.kernel_alone_ms(call)

    ucfg = config.UNIDYN_CONFIG
    tank = scenes.mixed_phase(scenes.unidyn_tank(ucfg, device=dev), 5)
    order, bt = binning.sort_tables(tank, ucfg)
    th = ucfg.subbin_threshold

    def fix(s, f):
        return 0.5 * s, -f

    def resident():
        return sph_kernels.unidyn_forces_resident(tank, bt, ucfg, order,
                                                  subbin_threshold=th)

    _digest(h, resident())
    _digest(h, sph_kernels.unidyn_forces_rowblock(
        tank, bt, ucfg, order, drift_fix=fix, subbin_threshold=th))
    _digest(h, sph_kernels.unidyn_forces_column(tank, bt, ucfg, order,
                                                subbin_threshold=th))
    out["unidyn_forces_resident, tank, alone"] = cs.kernel_alone_ms(resident)
    torch.cuda.synchronize()
    out["digest"] = h.hexdigest()[:16]
    out["card"] = cs.card_line()
    out["tree"] = sys.argv[1]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
