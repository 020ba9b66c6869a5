"""Probe of the blocked red-black kernel's float32 shapes on one NVIDIA
GPU:

    python3 rb_probe.py [<parent checkout>]

run from the root of this repository.  Each variant is
tpufluids_torch/csrc/rb_blocked.cu built alone into its own library
under build/rb_probe/: the source as it is (the shipped shapes, picked
by n), the source with both float32 shapes replaced by one probed tile
(TILES), and, given a checkout of another commit (e.g. unpacked by `git
archive` into build/parent), that commit's source.  Each is held bit for
bit against the plain solve, with the shipped ghost pass, at the timed
sizes and at 77^3 and 33^3 (5 iterations, every b, zero and raw
guesses), then timed by its passes' device time alone (torch.profiler)
for a solve from a zero guess at each size of SIZES: 20 iterations at
256^3 (the main path), 2 at multigrid's levels 128^3 .. 16^3 and 20 at
its coarsest, 8^3, in two rounds over the variants, the second in
reverse order.  It prints ptxas's registers and stack frame or spills of
each instance, the resident blocks and shared memory of each variant,
and the times."""

import ctypes
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from tpufluids_torch import _build
from tpufluids_torch.grid import kernels

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "rb_probe"
# (k, ty, tz, threads) of the probed float32 tiles
TILES = [(4, 32, 64, 768), (4, 16, 64, 512), (4, 16, 32, 256),
         (4, 8, 32, 160), (4, 8, 64, 288)]
SIZES = [(256, 20), (128, 2), (64, 2), (32, 2), (16, 2), (8, 20)]
FLOAT_TILE = r"Tile<(\d+), (\d+), (\d+), (\d+), float>"


def variants():
    """(label, source tree, float32 tile or None for the source's own)."""
    out = [("shipped", ROOT, None)]
    out += [(f"{ty} x {tz}, {nt} threads", ROOT, (k, ty, tz, nt))
            for k, ty, tz, nt in TILES]
    if len(sys.argv) > 1:
        out.append(("parent", Path(sys.argv[1]).resolve(), None))
    return out


def build_all(vs):
    if OUT.exists():
        shutil.rmtree(OUT)
    cmds, libs = [], []
    for i, (label, tree, tile) in enumerate(vs):
        d = OUT / str(i)
        shutil.copytree(tree / "tpufluids_torch" / "csrc", d)
        src = (d / "rb_blocked.cu").read_text()
        if tile:
            src, count = re.subn(FLOAT_TILE, "Tile<{}, {}, {}, {}, float>"
                                 .format(*tile), src)
            assert count >= 1, label
        (d / "rb_blocked.cu").write_text(src)
        lib = d / "librb.so"
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                     str(lib), str(d / "rb_blocked.cu")])
        libs.append((lib, shapes_of(src)))
    t0 = time.perf_counter()
    outs = _build._run_all(cmds)
    print(f"built {len(cmds)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return libs, outs


def shapes_of(src):
    """(large, small, n up to which the small one runs, whether the info
    entry takes n) of a source's float32 shapes, as kernels.RbTile; a
    source of one float32 shape gives it for every n."""
    tiles = [kernels.RbTile(*map(int, m.groups()[:3]))
             for m in re.finditer(FLOAT_TILE, src)]
    m = re.search(r"constexpr int SMALL_N = (\d+);", src)
    takes_n = "tf_rb_blocked_info(int bf16_storage, int n," in src
    return tiles[0], tiles[-1], int(m.group(1)) if m else 0, takes_n


def ptxas_summary(out):
    """(float32 shape, H, registers, stack frame and spills) of each
    float32 rb_blocked_kernel instance in ptxas's output."""
    rows, entry = [], None
    for line in out.splitlines():
        if "Compiling entry function" in line:
            e = line.split("'")[1]
            entry = (e if "rb_blocked_kernel" in e and "bfloat16" not in e
                     else None)
            if entry:
                m = re.search(r"ILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)Ef", e)
                rows.append([f"{m.group(2)}x{m.group(3)}/{m.group(4)}",
                             cs.rb_levels(e), None, None])
        elif entry and "stack frame" in line:
            rows[-1][3] = [int(w) for w in line.replace(",", " ").split()
                           if w.isdigit()]
        elif entry and "registers" in line:
            rows[-1][2] = int(line.split("Used ")[1].split()[0])
    return rows


class Variant:
    """One built library and its float32 shapes (shapes_of)."""

    def __init__(self, label, lib, shapes):
        self.label, self.lib, self.ms = label, lib, {}
        self.large, self.small, self.small_n, self.takes_n = shapes
        lib.tf_rb_blocked_pass.argtypes = _build.SIGNATURES[
            "tf_rb_blocked_pass"]
        lib.tf_rb_blocked_pass.restype = ctypes.c_int
        lib.tf_rb_blocked_info.argtypes = [ctypes.c_int] * (
            1 + self.takes_n) + [ctypes.POINTER(ctypes.c_int)] * 2
        lib.tf_rb_blocked_info.restype = ctypes.c_int

    def info(self, n):
        """(resident blocks, shared memory) of the shape for n."""
        slots, smem = ctypes.c_int(0), ctypes.c_int(0)
        rc = self.lib.tf_rb_blocked_info(
            0, *((n,) if self.takes_n else ()), ctypes.byref(slots),
            ctypes.byref(smem))
        assert rc == 0, (self.label, rc)
        return slots.value, smem.value

    def shape(self, n):
        return self.small if n <= self.small_n else self.large

    def solve(self, b, x, x0, a, c_inv, it, bufs, ghosts):
        n = x0.shape[1] - 2
        tile = self.shape(n)
        chunks = kernels.rb_chunks(n + 2, 0, n, tile, self.info(n)[0])
        passes = kernels.rb_passes(2 * it, tile.k)
        src = x
        for i, ps in enumerate(passes):
            dst = bufs[0] if kernels.rb_lands_in_out(i, len(passes)) \
                else bufs[1]
            rc = self.lib.tf_rb_blocked_pass(
                None if src is None else src.data_ptr(), x0.data_ptr(),
                dst.data_ptr(), n + 2, 0, n, chunks.r_lo, chunks.r_hi,
                chunks.length, chunks.count, ps.half_sweeps, ps.parity,
                int(ps.first), b, 0, a, c_inv,
                torch.cuda.current_stream().cuda_stream)
            assert rc == 0, (self.label, rc)
            src = dst
        ghosts(src, n, b)
        return src


def main():
    if not torch.cuda.is_available():
        print("rb_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    vs = variants()
    libs, outs = build_all(vs)
    main_lib = _build.load()

    def ghosts(t, n, b):
        main_lib.tf_rb_ghosts(t.data_ptr(), n, b, 0,
                              torch.cuda.current_stream().cuda_stream)

    print("card:", cs.card_line(), flush=True)
    runs = []
    for (label, _, _), (lib, shapes), out in zip(vs, libs, outs):
        v = Variant(label, ctypes.CDLL(str(lib)), shapes)
        runs.append(v)
        print(f"{label}: (resident blocks, shared memory) at "
              + ", ".join(f"{n}^3 {v.info(n)}" for n, _ in SIZES)
              + f"; ptxas (shape, H, registers, stack/spill) "
              f"{ptxas_summary(out)}", flush=True)
    rng = np.random.default_rng(17)
    fields = {}
    for n, it in SIZES + [(77, 5), (33, 5)]:
        x, x0 = (torch.from_numpy(rng.normal(0, 1, (n + 2,) * 3).astype(
            np.float32)).to(dev) for _ in range(2))
        fields[n] = (x, x0, it, (torch.empty_like(x0),
                                 torch.empty_like(x0)))
    for v in runs:
        ok = True
        for n, (x, x0, it, bufs) in fields.items():
            for b in range(4):
                for guess in (None, x):
                    want = kernels.lin_solve3d_rb_plain(b, guess, x0, 0.3,
                                                        2.8, it)
                    got = v.solve(b, guess, x0, 0.3, 1 / 2.8, it, bufs,
                                  ghosts)
                    ok = ok and torch.equal(got, want)
        print(f"{v.label}: bit for bit at {list(fields)}: {ok}", flush=True)
    for r in range(2):
        print("round", r, smi(), flush=True)
        for v in (runs if r % 2 == 0 else runs[::-1]):
            for n, it in SIZES:
                _, x0, _, bufs = fields[n]
                v.ms.setdefault(n, []).append(cs.kernel_alone_ms(
                    lambda: v.solve(0, None, x0, 1.0, 1 / 6, it, bufs,
                                    ghosts), ("rb_blocked_kernel",)))
    for v in runs:
        print(f"{v.label}: passes alone, ms a solve: "
              + ", ".join(f"{n}^3 x{it} {min(v.ms[n]):.4f} ("
                          + "/".join(f"{t:.4f}" for t in v.ms[n]) + ")"
                          for n, it in SIZES), flush=True)
    print("now", smi(), flush=True)
    return 0


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


if __name__ == "__main__":
    sys.exit(main())
