"""The hand-written CUDA kernels of the 3D step, each beside its plain
PyTorch version.

Counterpart of ``tpufluids/grid/pallas_kernels.py``: every Pallas
kernel on the step's path has a CUDA kernel here (sources in
``tpufluids_torch/csrc``, built by ``tpufluids_torch._build``).  A
wrapper runs the plain version when its tensors lie on the CPU, and
launches its kernel when they lie on a CUDA device; anything else
raises.  A launch that fails raises too: no wrapper falls back from its
kernel to the plain version.  Each wrapper counts its launches in its
``launches`` attribute.

All four kernels are single passes over a few (n+2)^3 float32 fields,
so device-memory bytes bound them.  They run one thread per output
cell, ghosts included; a ghost output is the interior value at its
clamped index times the set_bnd sign (csrc/grid_common.cuh), so no
second boundary pass is needed.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpufluids_torch import _build
from tpufluids_torch.grid import stam

_P, _INT, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "tf_advect3d": [_P] * 9 + [_INT] * 5 + [_F, _P],
    "tf_forcing_a": [_P] * 7 + [_INT] * 3 + [_F] * 5 + [_P],
    "tf_forcing_b": [_P] * 7 + [_INT] + [_F] * 3 + [_P],
    "tf_div3d": [_P] * 4 + [_INT, _F, _P],
    "tf_gradsub3d": [_P] * 7 + [_INT, _F, _P],
}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load()
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tf_error_string.argtypes = [ctypes.c_int]
    lib.tf_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, *args):
    """Call C entry ``name`` on the current stream of the tensors'
    device; tensors pass as their data pointers, None as NULL."""
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(
            *(a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args), stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} "
                           f"({lib.tf_error_string(rc).decode()})")


def _on_cuda(*tensors) -> bool:
    """Validate a kernel's field arguments; True for CUDA tensors, False
    for CPU tensors (the plain version runs)."""
    ref = tensors[0]
    if ref.dim() != 3 or len(set(ref.shape)) != 1 or ref.shape[0] < 3:
        raise ValueError(f"expected a cubic (n+2)^3 field with n >= 1, "
                         f"got shape {tuple(ref.shape)}")
    for t in tensors:
        if t.device != ref.device:
            raise ValueError(f"fields on {t.device} and {ref.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32 fields, got {t.dtype}")
        if t.shape != ref.shape:
            raise ValueError(f"field shapes {tuple(t.shape)} and "
                             f"{tuple(ref.shape)} differ")
        if not t.is_contiguous():
            raise ValueError("fields must be contiguous")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for {ref.device}")
    if ref.device.type == "cuda" and ref.numel() >= 2 ** 31:
        raise ValueError("the kernels index cells with int32: (n+2)^3 "
                         "must stay below 2^31")
    return ref.device.type == "cuda"


# ---------------------------------------------------------------------------
# advection


def advect3d_multi_plain(fields, bnds, u, v, w, dt0: float):
    return tuple(stam._advect_stencil(fields, bnds, u, v, w, dt0))


def advect3d_multi(fields, bnds, u, v, w, dt0: float):
    """27-tap stencil advection of ``fields`` (1 to 3) by (u, v, w), then
    set_bnd3d(b) per field with b from ``bnds``; as
    stam.advect3d_stencil per field.

    Replaces advect3d_multi_pallas (tpufluids/grid/pallas_kernels.py).
    Bound by bytes: 3 + k fields in, k out.  One thread per output cell
    computes the backtrace weights once and sums the 27 taps of each
    field (csrc/advect.cu)."""
    fields, bnds = tuple(fields), tuple(bnds)
    if not 1 <= len(fields) <= 3 or len(bnds) != len(fields):
        raise ValueError("advect3d_multi takes 1 to 3 fields, one b each")
    if any(b not in (0, 1, 2, 3) for b in bnds):
        raise ValueError(f"set_bnd modes must be 0..3, got {bnds}")
    if not _on_cuda(u, v, w, *fields):
        return advect3d_multi_plain(fields, bnds, u, v, w, dt0)
    k = len(fields)
    outs = tuple(torch.empty_like(u) for _ in fields)
    pad = (None,) * (3 - k)
    _launch("tf_advect3d", u, v, w, *fields, *pad, *outs, *pad, k,
            *bnds, *(0,) * (3 - k), u.shape[0] - 2, dt0)
    advect3d_multi.launches += 1
    return outs


advect3d_multi.launches = 0


# ---------------------------------------------------------------------------
# forcing


def forcing3d_plain(u, v, w, dens, temp, cfg: stam.StamConfig):
    if cfg.buoyancy_alpha or cfg.buoyancy_beta:
        w = stam.buoyancy3d(w, dens, temp, cfg)
    if cfg.vorticity_eps:
        u, v, w = stam.vorticity_confinement3d(u, v, w, cfg)
    return u, v, w


def forcing3d(u, v, w, dens, temp, cfg: stam.StamConfig):
    """Buoyancy on w (if alpha or beta) then vorticity confinement (if
    eps), each with its set_bnd; as stam.buoyancy3d followed by
    stam.vorticity_confinement3d.

    Replaces forcing3d_pallas (tpufluids/grid/pallas_kernels.py).  Bound
    by bytes.  The TPU kernel's halo of 2 is cut into two launches
    through two scratch fields (csrc/forcing.cu): A writes w' and
    |curl|, B the confined u, v, w.  A half whose coefficients are 0 is
    skipped."""
    if not _on_cuda(u, v, w, dens, temp):
        return forcing3d_plain(u, v, w, dens, temp, cfg)
    buoy = bool(cfg.buoyancy_alpha or cfg.buoyancy_beta)
    vort = bool(cfg.vorticity_eps)
    if not (buoy or vort):
        return u, v, w
    n = u.shape[0] - 2
    h = 1.0 / n
    w1 = torch.empty_like(w) if buoy else None
    mag = torch.empty_like(u) if vort else None
    _launch("tf_forcing_a", u, v, w, dens, temp, w1, mag, n, buoy, vort,
            cfg.dt, cfg.buoyancy_alpha, cfg.buoyancy_beta, cfg.ambient_temp,
            h)
    if buoy:
        w = w1
    if vort:
        outs = tuple(torch.empty_like(u) for _ in range(3))
        _launch("tf_forcing_b", u, v, w, mag, *outs, n, cfg.dt,
                cfg.vorticity_eps * h, h)
        u, v, w = outs
    forcing3d.launches += 1
    return u, v, w


forcing3d.launches = 0


# ---------------------------------------------------------------------------
# projection: divergence and gradient subtraction


def div3d_plain(u, v, w):
    div = torch.zeros_like(u)
    div[stam._I] = stam.divergence3d(u, v, w)
    return stam._set_bnd3d_(0, div)


def div3d(u, v, w):
    """set_bnd3d(0, divergence3d(u, v, w) on the interior): the
    right-hand side of the pressure solve.

    Replaces div3d_pallas (tpufluids/grid/pallas_kernels.py).  Bound by
    bytes: 3 fields in, 1 out (csrc/divgrad.cu)."""
    if not _on_cuda(u, v, w):
        return div3d_plain(u, v, w)
    n = u.shape[0] - 2
    out = torch.empty_like(u)
    _launch("tf_div3d", u, v, w, out, n, -0.5 * (1.0 / n))
    div3d.launches += 1
    return out


div3d.launches = 0


def gradsub3d_plain(p, u, v, w):
    n = u.shape[0] - 2
    h = 1.0 / n
    out = []
    for axis, (b, q) in enumerate(((1, u), (2, v), (3, w))):
        hi, lo = [slice(1, -1)] * 3, [slice(1, -1)] * 3
        hi[axis] = slice(2, None)
        lo[axis] = slice(0, -2)
        q = q.clone()
        q[stam._I] += -0.5 * (p[tuple(hi)] - p[tuple(lo)]) / h
        out.append(stam._set_bnd3d_(b, q))
    return tuple(out)


def gradsub3d(p, u, v, w):
    """Subtract the pressure gradient 0.5 (p[+1] - p[-1]) / h from each
    velocity component, then set_bnd3d(1 / 2 / 3): the tail of
    stam.project3d.

    Replaces gradsub3d_pallas (tpufluids/grid/pallas_kernels.py).  Bound
    by bytes: 4 fields in, 3 out (csrc/divgrad.cu)."""
    if not _on_cuda(p, u, v, w):
        return gradsub3d_plain(p, u, v, w)
    n = u.shape[0] - 2
    outs = tuple(torch.empty_like(u) for _ in range(3))
    _launch("tf_gradsub3d", p, u, v, w, *outs, n, 1.0 / n)
    gradsub3d.launches += 1
    return outs


gradsub3d.launches = 0

KERNELS = (advect3d_multi, forcing3d, div3d, gradsub3d)


def reset_launches():
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
