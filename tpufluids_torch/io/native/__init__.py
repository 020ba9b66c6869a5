"""ctypes bindings for the native C++ VTK writer: ``tpufluids.io.native``
with its own build.

``vtkwriter.cc`` (a copy of the JAX package's) is compiled by ``g++``
into ``build/native/`` beside the package, named by a hash of the
source and flags, on the first call of :func:`load`; each process
compiles into a file of its own and moves it into place, so processes
that build at once do not collide.  The package's own directory is
never written.  There is no fallback: when ``g++`` fails, ``load`` and
every writer raise.  Arrays may be numpy arrays or tensors on any
device; the files equal ``tpufluids_torch.io.vtk``'s byte for byte.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from tpufluids_torch.io.vtk import _arr

SRC = Path(__file__).resolve().parent / "vtkwriter.cc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None


def build() -> Path:
    """Compile the shared library unless one of the same hash exists;
    returns its path."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SRC.read_bytes())
    lib = BUILD_DIR / f"libvtkwriter_{digest.hexdigest()[:16]}.so"
    with _lock:
        if lib.is_file():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed with code {proc.returncode}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, lib)
    return lib


def load():
    """Load (building if necessary) the native library, or raise."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        charpp = ctypes.POINTER(ctypes.c_char_p)
        f32pp = ctypes.POINTER(f32p)
        lib.vw_write_point_mesh.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, f32p,
            ctypes.c_int, i32p, charpp, f32pp]
        lib.vw_write_unstructured_mesh.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, f32p,
            ctypes.c_int64, i32p, i32p, ctypes.c_int, i32p, i32p,
            charpp, f32pp]
        lib.vw_write_rectilinear_mesh.argtypes = [
            ctypes.c_char_p, ctypes.c_int, i32p, f32p, f32p, f32p,
            ctypes.c_int, i32p, i32p, charpp, f32pp]
        lib.vw_write_regular_mesh.argtypes = [
            ctypes.c_char_p, ctypes.c_int, i32p, ctypes.c_int, i32p, i32p,
            charpp, f32pp]
        lib.vw_write_curvilinear_mesh.argtypes = [
            ctypes.c_char_p, ctypes.c_int, i32p, f32p, ctypes.c_int, i32p,
            i32p, charpp, f32pp]
        for fn in ("vw_write_point_mesh", "vw_write_unstructured_mesh",
                   "vw_write_rectilinear_mesh", "vw_write_regular_mesh",
                   "vw_write_curvilinear_mesh"):
            getattr(lib, fn).restype = ctypes.c_int
        _lib = lib
    return _lib


def _f32(a):
    return np.ascontiguousarray(_arr(a), np.float32)


def _i32(a):
    return np.ascontiguousarray(_arr(a), np.int32)


def _varargs(vardim, varnames, vars_):
    n = len(varnames)
    dims = _i32(list(vardim))
    names = (ctypes.c_char_p * n)(*[v.encode() for v in varnames])
    arrs = [_f32(_arr(v).reshape(-1)) for v in vars_]
    ptrs = (ctypes.POINTER(ctypes.c_float) * n)(
        *[a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for a in arrs])
    return n, dims, names, ptrs, arrs  # keep arrs alive


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def write_point_mesh(filename, use_binary, npts, pts, nvars=None,
                     vardim=(), varnames=(), vars_=()):
    lib = load()
    pts = _f32(_arr(pts).reshape(-1))
    n, dims, names, ptrs, keep = _varargs(vardim, varnames, vars_)
    rc = lib.vw_write_point_mesh(
        str(filename).encode(), int(use_binary), int(npts), _fp(pts),
        n, _ip(dims), names, ptrs)
    if rc:
        raise IOError(f"native vtk writer failed with code {rc}")


def write_unstructured_mesh(filename, use_binary, npts, pts, ncells,
                            celltypes, conn, nvars=None, vardim=(),
                            centering=(), varnames=(), vars_=()):
    lib = load()
    pts = _f32(_arr(pts).reshape(-1))
    ct = _i32(celltypes)
    cn = _i32(_arr(conn).reshape(-1))
    cent = _i32(list(centering))
    n, dims, names, ptrs, keep = _varargs(vardim, varnames, vars_)
    rc = lib.vw_write_unstructured_mesh(
        str(filename).encode(), int(use_binary), int(npts), _fp(pts),
        int(ncells), _ip(ct), _ip(cn), n, _ip(dims), _ip(cent), names, ptrs)
    if rc:
        raise IOError(f"native vtk writer failed with code {rc}")


def write_rectilinear_mesh(filename, use_binary, dims, x, y, z, nvars=None,
                           vardim=(), centering=(), varnames=(), vars_=()):
    lib = load()
    d = _i32(list(dims))
    x, y, z = _f32(x), _f32(y), _f32(z)
    cent = _i32(list(centering))
    n, vdims, names, ptrs, keep = _varargs(vardim, varnames, vars_)
    rc = lib.vw_write_rectilinear_mesh(
        str(filename).encode(), int(use_binary), _ip(d), _fp(x), _fp(y),
        _fp(z), n, _ip(vdims), _ip(cent), names, ptrs)
    if rc:
        raise IOError(f"native vtk writer failed with code {rc}")


def write_regular_mesh(filename, use_binary, dims, nvars=None, vardim=(),
                       centering=(), varnames=(), vars_=()):
    lib = load()
    d = _i32(list(dims))
    cent = _i32(list(centering))
    n, vdims, names, ptrs, keep = _varargs(vardim, varnames, vars_)
    rc = lib.vw_write_regular_mesh(
        str(filename).encode(), int(use_binary), _ip(d), n, _ip(vdims),
        _ip(cent), names, ptrs)
    if rc:
        raise IOError(f"native vtk writer failed with code {rc}")


def write_curvilinear_mesh(filename, use_binary, dims, pts, nvars=None,
                           vardim=(), centering=(), varnames=(), vars_=()):
    lib = load()
    d = _i32(list(dims))
    pts = _f32(_arr(pts).reshape(-1))
    cent = _i32(list(centering))
    n, vdims, names, ptrs, keep = _varargs(vardim, varnames, vars_)
    rc = lib.vw_write_curvilinear_mesh(
        str(filename).encode(), int(use_binary), _ip(d), _fp(pts), n,
        _ip(vdims), _ip(cent), names, ptrs)
    if rc:
        raise IOError(f"native vtk writer failed with code {rc}")
