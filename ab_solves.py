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
float32 red-black solve (#10) at 256^3 and 64^3, multigrid's
smoothers (#10 at 2 iterations at 256^3, 128^3, 64^3, 32^3 and 16^3, 20
at 8^3) and its whole solve (config 3 with multigrid, 256^3, two
V-cycles; its kernels alone are the smoothers' passes and ghost
passes), the bfloat16 red-black solve at 512^3 and the sharded red-black solve (#12) on a world of 1 at
512^3 (config 5's pressure solve, fuse 4), 20 iterations from a zero
guess, the three-field diffusion (#5) at 64^3, 20 sweeps, and the fused
projection (#6) at 64^3 and 96^3, 20 red-black iterations or Jacobi
sweeps, each in ms a call by CUDA events around the wrapper and by the
device time of its kernels alone (torch.profiler); whether the bfloat16
Jacobi solve equals its plain version bit for bit at 257^3, where the
middle 128-wide tile ends one cell before the face; a digest of the
outputs of the whole tier on seeded inputs (the whole step #7 at config
4, the diffusion #5, the whole solve in its four modes, the fused
projection in both modes) and one of the red-black solves' outputs (the
four timed calls, the smoothers and the multigrid solve, and #10 at
256^3 and 77^3 from a raw guess at 5 iterations, every b), each equal between two checkouts exactly when
their results are bit for bit; and the card's name and power limit."""

import functools
import hashlib
import os
import sys

import numpy as np
import torch

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)

import chip_smoke as cs  # noqa: E402
from tpufluids_torch import shard  # noqa: E402
from tpufluids_torch.grid import kernels, stam  # noqa: E402

# the solves' kernels by the names torch.profiler gives them, before and
# after the blocked float32 Jacobi pass; the red-black solves' passes and
# their ghost or finish pass
JACOBI = ("jacobi_kernel", "jacobi_blocked_kernel")
RB = ("rb_blocked_kernel", "ghost_kernel", "rb_shard_finish_kernel")


def fold(digest, outs):
    """Adds the bits of a tensor, or of a tuple of them, to ``digest``."""
    for t in outs if isinstance(outs, tuple) else (outs,):
        digest.update(t.contiguous().view(torch.int32).cpu().numpy()
                      .tobytes())


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
    rb_digest = hashlib.sha256()
    p = field(256)
    timed("lin_solve3d 256", lambda: kernels.lin_solve3d(
        0, None, p, 1.0, 6.0, 20), JACOBI)
    for n in (256, 64):
        p = field(n)
        timed(f"rb {n}", lambda: kernels.lin_solve3d_rb(
            0, None, p, 1.0, 6.0, 20), RB)
        fold(rb_digest, kernels.lin_solve3d_rb(0, None, p, 1.0, 6.0, 20))
    # multigrid's smoothers, as config 3 with multigrid calls them at
    # 256^3: 2 iterations at each level above the coarsest, 20 at 8^3;
    # then its whole solve (two V(2,2) cycles)
    for n, it in ((256, 2), (128, 2), (64, 2), (32, 2), (16, 2), (8, 20)):
        p = field(n)
        timed(f"rb {n} x{it}", lambda: kernels.lin_solve3d_rb(
            0, None, p, 1.0, 6.0, it), RB)
        fold(rb_digest, kernels.lin_solve3d_rb(0, None, p, 1.0, 6.0, it))
    mg = cs.grid_config(stam, "config 3, multigrid")
    p = field(mg.n)
    timed(f"mg {mg.n}", lambda: stam.mg_solve3d(p, mg), RB)
    fold(rb_digest, stam.mg_solve3d(p, mg))
    for n in (256, 77):
        x, x0 = field(n), field(n)
        x[1:-1] -= 0.5        # ghosts that set_bnd3d would change
        for b in range(4):
            fold(rb_digest, kernels.lin_solve3d_rb(b, x, x0, 1.0, 6.0, 5))
    del x, x0
    p = field(512)
    timed("bf16 512", lambda: kernels.lin_solve3d_bf16(
        0, None, p, 1.0, 6.0, 20), JACOBI)
    timed("rb bf16 512", lambda: kernels.lin_solve3d_rb_bf16(
        0, None, p, 1.0, 6.0, 20), RB)
    fold(rb_digest, kernels.lin_solve3d_rb_bf16(0, None, p, 1.0, 6.0, 20))
    # config 5's pressure solve on a world of 1 (chip_smoke.py's call)
    mesh = shard.make_mesh(device="cuda")
    fuse = kernels.rb_shard_plan(512, 20)
    halo = 2 * fuse
    x0p = shard.grid_sharded._refresh_pad_(
        shard.grid_sharded._padded(p[1:-1].contiguous(), halo), halo, 0,
        mesh)
    del p
    kw = dict(gx0=1 - halo, fuse=fuse, exchange=functools.partial(
        shard.grid_sharded._refresh_pad_, halo=halo, b=0, mesh=mesh))
    timed("rb shard 512", lambda: kernels.lin_solve3d_rb_shard(
        0, None, x0p, 1.0, 6.0, 20, **kw), RB)
    fold(rb_digest, kernels.lin_solve3d_rb_shard(0, None, x0p, 1.0, 6.0, 20,
                                                 **kw))
    del x0p
    torch.cuda.empty_cache()
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
    c4 = cs.grid_config(stam, "config 4")
    fold(digest, kernels.step3d_whole(*(field(64) for _ in range(5)), c4))
    fold(digest, kernels.diffuse3d_multi(xs, params, 20))
    p = field(64)
    for dt in (torch.float32, torch.bfloat16):
        for rb in (False, True):
            fold(digest, kernels.lin_solve3d_whole(0, None, p, 1.0, 6.0, 20,
                                                   rb, dt))
    u, v, w = (field(64) for _ in range(3))
    for rb in (True, False):
        fold(digest, kernels.project3d_whole(u, v, w, 20, rb))
    x0 = field(257)
    bf16_257 = torch.equal(
        kernels.lin_solve3d_bf16(0, None, x0, 1.0, 6.0, 2),
        kernels.lin_solve3d_bf16_plain(0, None, x0, 1.0, 6.0, 2))
    print(sys.argv[1], {k: round(v, 4) for k, v in out.items()},
          f"bf16 Jacobi at 257^3 bit for bit: {bf16_257}",
          f"whole tier digest {digest.hexdigest()[:16]}",
          f"red-black digest {rb_digest.hexdigest()[:16]}", cs.card_line(),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
