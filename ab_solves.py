"""Times the port's dense and whole-tier solves of one checkout on one
NVIDIA GPU, so that two commits can be compared in one session on one
card:

    python3 ab_solves.py <checkout>

run from the root of this repository, with <checkout> a directory that
holds a tree of the repository (this one, ".", or another commit
unpacked by `git archive`, e.g. into build/parent).  The kernels and the
timing helpers (chip_smoke.py's) are the checkout's.  Alternate the
trees (parent, change, change, parent) to see the spread.

It prints one line: the float32 Jacobi solve (#11) at 256^3 and the
bfloat16 Jacobi solve at 512^3, 20 sweeps from a zero guess, the
three-field diffusion (#5) at 64^3, 20 sweeps, and the fused projection
(#6) at 64^3 and 96^3, 20 red-black iterations or Jacobi sweeps, each in
ms a call by CUDA events around the wrapper and by the device time of
its kernels alone (torch.profiler); whether the bfloat16 Jacobi solve
equals its plain version bit for bit at 257^3, where the middle
128-wide tile ends one cell before the face; a digest of the outputs of
the whole tier on seeded inputs (the whole step #7 at config 4, the
diffusion #5, the whole solve in its four modes, the fused projection in
both modes), equal between two checkouts exactly when their results are
bit for bit; and the card's name and power limit."""

import hashlib
import os
import sys

import numpy as np
import torch

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)

import chip_smoke as cs  # noqa: E402
from tpufluids_torch.grid import kernels, stam  # noqa: E402

# the solves' kernels by the names torch.profiler gives them, before and
# after the blocked float32 Jacobi pass
JACOBI = ("jacobi_kernel", "jacobi_blocked_kernel")


def main():
    if not torch.cuda.is_available():
        print("ab_solves: no CUDA device", file=sys.stderr)
        return 2
    if not kernels.__file__.startswith(root):
        raise RuntimeError(f"{kernels.__file__} is not under {root}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)

    def field(n):
        return stam.set_bnd3d(0, torch.from_numpy(rng.uniform(
            0.0, 1.0, (n + 2,) * 3).astype(np.float32)).to(dev))

    def timed(name, fn, names):
        out[f"{name} events"] = cs.time_ms(fn)
        out[f"{name} alone"] = cs.kernel_alone_ms(fn, names)

    out = {}
    p = field(256)
    timed("lin_solve3d 256", lambda: kernels.lin_solve3d(
        0, None, p, 1.0, 6.0, 20), JACOBI)
    p = field(512)
    timed("bf16 512", lambda: kernels.lin_solve3d_bf16(
        0, None, p, 1.0, 6.0, 20), JACOBI)
    del p
    xs = [field(64) for _ in range(3)]
    a = 0.1 * 1e-5 * 64 ** 2
    params = tuple((b, a, 1 + 6 * a) for b in (1, 2, 3))
    timed("diffuse 64", lambda: kernels.diffuse3d_multi(xs, params, 20),
          ("diffuse_multi_kernel",))
    for n in (64, 96):
        u, v, w = (field(n) for _ in range(3))
        for rb in (True, False):
            timed(f"project {n} {'rb' if rb else 'jacobi'}",
                  lambda: kernels.project3d_whole(u, v, w, 20, rb),
                  ("project_whole_kernel",))
    del u, v, w
    digest = hashlib.sha256()

    def fold(outs):
        for t in outs if isinstance(outs, tuple) else (outs,):
            digest.update(t.contiguous().view(torch.int32).cpu().numpy()
                          .tobytes())

    c4 = cs.grid_config(stam, "config 4")
    fold(kernels.step3d_whole(*(field(64) for _ in range(5)), c4))
    fold(kernels.diffuse3d_multi(xs, params, 20))
    p = field(64)
    for dt in (torch.float32, torch.bfloat16):
        for rb in (False, True):
            fold(kernels.lin_solve3d_whole(0, None, p, 1.0, 6.0, 20, rb, dt))
    u, v, w = (field(64) for _ in range(3))
    for rb in (True, False):
        fold(kernels.project3d_whole(u, v, w, 20, rb))
    x0 = field(257)
    bf16_257 = torch.equal(
        kernels.lin_solve3d_bf16(0, None, x0, 1.0, 6.0, 2),
        kernels.lin_solve3d_bf16_plain(0, None, x0, 1.0, 6.0, 2))
    print(sys.argv[1], {k: round(v, 4) for k, v in out.items()},
          f"bf16 Jacobi at 257^3 bit for bit: {bf16_257}",
          f"whole tier digest {digest.hexdigest()[:16]}", cs.card_line(),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
