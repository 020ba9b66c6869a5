"""Build and load the CUDA kernels of ``tpufluids_torch/csrc``.

The ``*.cu`` sources have a plain C interface (no PyTorch headers), so
one ``nvcc`` call compiles them in seconds into a shared library that
``ctypes`` loads.  The library goes to ``build/kernels/`` beside the
package, named by a hash of the sources and flags, and is built on the
first call of :func:`load` in a checkout that lacks it.  ``nvcc``'s own
output (``-Xptxas -v``: registers, spills, shared memory per kernel) is
kept beside it as ``<library>.log``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "kernels"

# -fmad=false: no contraction into FMA, so each kernel rounds exactly
# as its plain PyTorch version (one rounding per operation) does.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path        # the shared library
    seconds: float    # nvcc wall time; 0.0 when an earlier build was reused
    log: str          # nvcc's output for the build that made ``path``


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built")


@functools.cache
def build() -> Build:
    """Compile ``csrc/*.cu`` unless a library of the same hash exists."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    lib = BUILD_DIR / f"libtpufluids_torch_{digest.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if lib.is_file():
        return Build(lib, 0.0, log.read_text() if log.is_file() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    text = proc.stdout + proc.stderr
    log.write_text(text)
    os.replace(tmp, lib)
    return Build(lib, seconds, text)


@functools.cache
def load() -> ctypes.CDLL:
    """The kernels' shared library, built first if needed."""
    return ctypes.CDLL(str(build().path))
