"""Build, load and call the CUDA kernels of ``tpufluids_torch/csrc``.

The ``*.cu`` sources have a plain C interface (no PyTorch headers).
Each is compiled by its own ``nvcc`` process, all started together, and
one more ``nvcc`` call links the objects into a shared library that
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

import torch

from tpufluids_torch.diagnostics import span

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "kernels"

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# -fmad=false: no contraction into FMA, so each kernel rounds exactly
# as its plain PyTorch version (one rounding per operation) does.
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")

_P, _INT, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry -> argument types; every entry takes the stream last and
# returns a cudaError_t as int
SIGNATURES = {
    "tf_advect3d": [_P] * 9 + [_INT] * 7 + [_F, _P],
    "tf_forcing3d": [_P] * 8 + [_INT] * 5 + [_F] * 6 + [_P],
    "tf_div3d": [_P] * 4 + [_INT] * 3 + [_F, _P],
    "tf_gradsub3d": [_P] * 7 + [_INT] * 3 + [_F, _P],
    "tf_rb_blocked_pass": [_P] * 3 + [_INT] * 12 + [_F] * 2 + [_P],
    "tf_rb_ghosts": [_P] + [_INT] * 3 + [_P],
    "tf_jacobi_blocked_pass": [_P] * 3 + [_INT] * 8 + [_F] * 2 + [_P],
    "tf_jacobi_probe_pass": [_INT] + [_P] * 3 + [_INT] * 7 + [_F] * 2 + [_P],
    "tf_rb_shard_finish": [_P] * 2 + [_INT] * 4 + [_P],
    "tf_lin_solve3d_whole": [_P] * 4 + [_INT] * 12 + [_F] * 2 + [_P],
    "tf_diffuse3d_multi": [_P] * 9 + [_INT] * 13 + [_F] * 6 + [_P],
    "tf_project3d_whole": [_P] * 8 + [_INT] * 10 + [_F] * 3 + [_P],
    "tf_step3d_whole": [_P] * 11 + [_INT] * 18 + [_F] * 15 + [_P],
    "tf_barrier_probe": [_INT] * 3 + [_P],
    "tf_lin_solve2d": [_P] * 4 + [_INT] * 9 + [_F] * 2 + [_P],
    "tf_step2d_whole": [_P] * 9 + [_INT] * 14 + [_F] * 15 + [_P],
    "tf_sph_base_forces": [_P] * 8 + [_INT] * 3 + [_F] * 9 + [_P],
    "tf_sph_base_column": [_P] * 8 + [_INT] * 5 + [_F] * 9 + [_P],
    "tf_sph_base_pack": [_P] * 12 + [_INT] * 3 + [_F] * 4 + [_P],
    "tf_unidyn_pass_a": [_P] * 10 + [_INT] * 4 + [_F] * 19 + [_P],
    "tf_unidyn_pass_b": [_P] * 7 + [_INT] * 4 + [_F] * 3 + [_P],
    "tf_unidyn_column_a": [_P] * 10 + [_INT] * 6 + [_F] * 19 + [_P],
    "tf_unidyn_column_b": [_P] * 7 + [_INT] * 6 + [_F] * 3 + [_P],
}


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


def _run_all(cmds) -> list[str]:
    """Run the commands in parallel; return each one's output, or raise
    with the output of the first that failed.  No process outlives the
    call."""
    procs = []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
        outs = [p.communicate()[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {p.returncode}:\n"
                               f"{' '.join(cmd)}\n{out}")
    return outs


@functools.cache
def _library() -> Path:
    """The shared library's path: named by a hash of the sources and
    flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libtpufluids_torch_{digest.hexdigest()[:16]}.so"


@functools.cache
def build() -> Build:
    """Compile ``csrc/*.cu`` unless a library of the same hash exists."""
    sources = sorted(CSRC.glob("*.cu"))
    lib = _library()
    log = lib.with_suffix(".log")
    if lib.is_file():
        return Build(lib, 0.0, log.read_text() if log.is_file() else "")
    work = lib.with_suffix(f".{os.getpid()}.tmp")
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [work / f"{src.stem}.o" for src in sources]
    t0 = time.perf_counter()
    outs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                     for src, obj in zip(sources, objs)])
    outs += _run_all([[nvcc, *ARCH, "-shared", "-o", str(work / lib.name),
                       *map(str, objs)]])
    seconds = time.perf_counter() - t0
    text = "".join(f"== {name}\n{out}" for name, out in
                   zip([s.name for s in sources] + ["link"], outs))
    log.write_text(text)
    os.replace(work / lib.name, lib)
    shutil.rmtree(work)
    return Build(lib, seconds, text)


@functools.cache
def load() -> ctypes.CDLL:
    """The kernels' shared library, built first if needed, with the
    argument types of every C entry set.  Its span, ``kernels.load``
    (detail ``build`` when nvcc runs), opens once a process."""
    with span("kernels.load", "" if _library().is_file() else "build"):
        return _load(build().path)


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tf_rb_blocked_info.argtypes = [_INT] * 2 + [ctypes.POINTER(_INT)] * 2
    lib.tf_rb_blocked_info.restype = ctypes.c_int
    lib.tf_jacobi_blocked_info.argtypes = [_INT] + [ctypes.POINTER(_INT)] * 2
    lib.tf_jacobi_blocked_info.restype = ctypes.c_int
    lib.tf_jacobi_probe_info.argtypes = [_INT] + [ctypes.POINTER(_INT)] * 3
    lib.tf_jacobi_probe_info.restype = ctypes.c_int
    for info in ("tf_lin_solve3d_whole_info", "tf_lin_solve2d_info"):
        getattr(lib, info).argtypes = [ctypes.POINTER(_INT)] * 2
        getattr(lib, info).restype = ctypes.c_int
    lib.tf_step3d_whole_info.argtypes = [ctypes.POINTER(_INT)] * 3
    lib.tf_step3d_whole_info.restype = ctypes.c_int
    lib.tf_step2d_whole_info.argtypes = [ctypes.POINTER(_INT)] * 3
    lib.tf_step2d_whole_info.restype = ctypes.c_int
    lib.tf_sph_base_info.argtypes = [ctypes.POINTER(_INT)] * 3
    lib.tf_sph_base_info.restype = ctypes.c_int
    lib.tf_unidyn_info.argtypes = [ctypes.POINTER(_INT)] * 4
    lib.tf_unidyn_info.restype = ctypes.c_int
    for shape in ("tf_advect3d_shape", "tf_forcing3d_shape"):
        getattr(lib, shape).argtypes = [ctypes.POINTER(_INT)]
        getattr(lib, shape).restype = None
    lib.tf_error_string.argtypes = [ctypes.c_int]
    lib.tf_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args):
    """Call C entry ``name`` on the current stream of the tensors'
    device; tensors pass as their data pointers, None as NULL.  Raises
    if the launch failed."""
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(
            *(a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args), stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} "
                           f"({lib.tf_error_string(rc).decode()})")
