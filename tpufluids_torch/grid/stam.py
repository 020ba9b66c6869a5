"""Stam-style stable-fluids solver in PyTorch: the 2D and 3D steps of
``tpufluids.grid.stam`` with the spectral (DCT), the Jacobi (plain or
red-black) or the multigrid projection, diffusion, stencil or gather
advection, and the float32 or bfloat16 solver.

Fields are dense (n+2)^2 or (n+2)^3 float32 tensors with one ghost
layer, the last axis contiguous, on any device.  The functions are pure:
they return new tensors and never write into their arguments.  The
stencil stages of the 3D step (forcing, divergence, gradient
subtraction, stencil advection), the Jacobi solves of both steps (in
float32 or bfloat16; multigrid smooths with them) and the whole 2D and
3D steps go through ``tpufluids_torch.grid.kernels``, which launches a
CUDA kernel for a CUDA tensor and runs the plain PyTorch version for a
CPU tensor.  The DCT solve is dense matrix products
(``torch.tensordot``); gather advection, multigrid's restriction and
prolongation and the other stages of the multi-call 2D step are torch
ops, as they are XLA ops in the reference.

The port keeps the reference's dense ghosted layout and reads stored
ghosts, so it reproduces the reference's dense XLA path
(``solver_backend="xla"``); its bfloat16 solves are the reference's
Pallas bfloat16 solve, which its dense path does not have.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Optional

import torch

from tpufluids_torch.diagnostics import span
from tpufluids_torch.grid import kernels


@dataclasses.dataclass(frozen=True)
class StamConfig:
    """Same fields and defaults as ``tpufluids.grid.stam.StamConfig``.

    The port runs both advection modes with every projection, with or
    without diffusion, with either ``solver_dtype``; in 2D every
    projection but "dct" is the Jacobi solve and ``solver_dtype``
    changes nothing, as in the reference.  ``solver_backend`` is ignored
    (the device of the fields decides).
    """
    n: int = 128                 # interior cells per axis
    dt: float = 0.1
    diff: float = 0.0            # density diffusion coefficient
    visc: float = 0.0            # kinematic viscosity
    jacobi_iters: int = 20
    red_black: bool = False      # red-black Gauss-Seidel projection
    vorticity_eps: float = 0.0   # vorticity confinement strength
    buoyancy_alpha: float = 0.0  # density weight (pulls smoke down)
    buoyancy_beta: float = 0.0   # temperature weight (pushes plume up)
    ambient_temp: float = 0.0
    temp_diff: float = 0.0
    advect_mode: str = "gather"  # "gather" | "stencil" (27-tap, 1 cell)
    solver_backend: str = "auto"
    solver_dtype: str = "float32"
    projection: str = "jacobi"   # "jacobi" | "multigrid" | "dct"
    mg_cycles: int = 2
    # DCT matmul precision tier: "highest" runs in full float32; on a
    # CUDA device "high" and "default" run in TF32
    dct_precision: str = "highest"
    # radix-2 split for axes of even extent >= this; 0 off, -1 auto
    # (256 at "highest", off otherwise)
    dct_radix_min: int = -1
    # tier of the step's first (pre-advection) solve; "" = dct_precision
    dct_precision_first: str = ""
    dct_radix_levels: int = 1

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class GridState2D:
    u: torch.Tensor      # (n+2, n+2) x-velocity
    v: torch.Tensor      # (n+2, n+2) y-velocity
    dens: torch.Tensor
    temp: torch.Tensor


@dataclasses.dataclass
class GridState3D:
    u: torch.Tensor      # (n+2, n+2, n+2)
    v: torch.Tensor
    w: torch.Tensor
    dens: torch.Tensor
    temp: torch.Tensor


def _make_grid(cfg: StamConfig, ndim: int, device):
    shape = (cfg.n + 2,) * ndim
    zeros = [torch.zeros(shape, dtype=torch.float32, device=device)
             for _ in range(ndim + 1)]
    return zeros + [torch.full(shape, cfg.ambient_temp, dtype=torch.float32,
                               device=device)]


def make_grid2d(cfg: StamConfig, device="cuda") -> GridState2D:
    return GridState2D(*_make_grid(cfg, 2, device))


def make_grid3d(cfg: StamConfig, device="cuda") -> GridState3D:
    return GridState3D(*_make_grid(cfg, 3, device))


# ---------------------------------------------------------------------------
# set_bnd — Stam's boundary enforcement.  b = 0: continuity (copy),
# b = k: negate the component normal to axis k-1 at that face.


def _interior(ndim: int):
    return (slice(1, -1),) * ndim


_I = _interior(3)                 # the interior of a ghosted field
_I2 = _interior(2)


def _bnd_signs(b: int):
    return tuple(-1.0 if b == a + 1 else 1.0 for a in range(3))


def _set_bnd3d_(b: int, x: torch.Tensor) -> torch.Tensor:
    """set_bnd3d in place on a tensor the caller owns.  The z faces are
    written last, so a ghost cell ends up as the product of the signs of
    its out-of-range axes times the value at the clamped interior index
    (the closed form the CUDA kernels use)."""
    sx, sy, sz = _bnd_signs(b)
    x[0] = sx * x[1]
    x[-1] = sx * x[-2]
    x[:, 0] = sy * x[:, 1]
    x[:, -1] = sy * x[:, -2]
    x[:, :, 0] = sz * x[:, :, 1]
    x[:, :, -1] = sz * x[:, :, -2]
    return x


def set_bnd3d(b: int, x: torch.Tensor) -> torch.Tensor:
    return _set_bnd3d_(b, x.clone())


def _set_bnd2d_(b: int, x: torch.Tensor) -> torch.Tensor:
    """set_bnd2d in place, in the reference's order: the x edges over the
    interior columns, then the full y edges, then each corner as the
    average of its two edge neighbours.  A corner thus ends up as 0.5 *
    (sy c + sx c), c the diagonal interior cell: c for b = 0, 0 for b = 1
    or 2 (not the product of the signs, as in 3D)."""
    sx, sy, _ = _bnd_signs(b)
    x[0, 1:-1] = sx * x[1, 1:-1]
    x[-1, 1:-1] = sx * x[-2, 1:-1]
    x[:, 0] = sy * x[:, 1]
    x[:, -1] = sy * x[:, -2]
    x[0, 0] = 0.5 * (x[1, 0] + x[0, 1])
    x[0, -1] = 0.5 * (x[1, -1] + x[0, -2])
    x[-1, 0] = 0.5 * (x[-2, 0] + x[-1, 1])
    x[-1, -1] = 0.5 * (x[-2, -1] + x[-1, -2])
    return x


def set_bnd2d(b: int, x: torch.Tensor) -> torch.Tensor:
    return _set_bnd2d_(b, x.clone())


def _set_bnd_(b: int, x: torch.Tensor) -> torch.Tensor:
    return _set_bnd2d_(b, x) if x.dim() == 2 else _set_bnd3d_(b, x)


# ---------------------------------------------------------------------------
# linear solvers (diffusion and the Jacobi pressure projection)


def _jacobi_new(x, x0, a, c_inv):
    """(x0 + a * sum of the six neighbours) * c_inv on the interior, the
    neighbours summed in the reference's order."""
    nb = (x[:-2, 1:-1, 1:-1] + x[2:, 1:-1, 1:-1]
          + x[1:-1, :-2, 1:-1] + x[1:-1, 2:, 1:-1]
          + x[1:-1, 1:-1, :-2] + x[1:-1, 1:-1, 2:])
    return (x0[_I] + a * nb) * c_inv


def _checker(n: int, parity: int, device) -> torch.Tensor:
    """The red-black mask of the n^3 interior: the reference's _checker
    sums the 0-based interior indices, so cell (1, 1, 1) of the ghosted
    field has parity 0."""
    i = torch.arange(n, device=device)
    return (i[:, None, None] + i[None, :, None] + i[None, None, :]) % 2 \
        == parity


SOLVER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def solver_dtype(name: str) -> torch.dtype:
    """The torch dtype of ``StamConfig.solver_dtype``."""
    if name not in SOLVER_DTYPES:
        raise ValueError(f"unknown solver_dtype {name!r}")
    return SOLVER_DTYPES[name]


def round_scalar(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype`` (through float32, as the reference's
    weak-typed Python scalars are rounded against a bfloat16 array)."""
    return float(torch.tensor(v, dtype=torch.float64).to(dtype))


def lin_solve3d(b, x, x0, a, c, iters, red_black=False,
                dtype=torch.float32):
    """``iters`` Jacobi sweeps of (x0 + a * sum of neighbours) / c on the
    interior, or red-black iterations of two half-sweeps (parity 0, then
    1), each sweep and half-sweep followed by set_bnd3d(b); as the
    reference's lin_solve3d.  ``x`` None is a zero initial guess; the
    first sweep reads the stored ghosts of ``x``.

    ``dtype`` bfloat16 is the reference's bfloat16 solve
    (lin_solve3d_pallas(dtype=bfloat16)): x and x0 are rounded to
    bfloat16, so are ``a`` and 1 / c, every operation rounds to bfloat16
    (the neighbours summed x-1, x+1, y-1, y+1, z-1, z+1, then a * sum,
    then x0 + that, then times 1 / c), and the result is cast back to
    the input's float32."""
    out_dtype = x0.dtype
    c_inv = 1.0 / c
    if dtype != torch.float32:
        # a tensor times a Python float keeps the float in float32:
        # round the scalars first
        a, c_inv = round_scalar(a, dtype), round_scalar(c_inv, dtype)
    x0 = x0.to(dtype)
    x = (torch.zeros_like(x0) if x is None
         else x.to(dtype, copy=True))
    if red_black:
        m0 = _checker(x.shape[0] - 2, 0, x.device)
    for _ in range(iters):
        if not red_black:
            x[_I] = _jacobi_new(x, x0, a, c_inv)
            _set_bnd3d_(b, x)
            continue
        for m in (m0, ~m0):
            x[_I] = torch.where(m, _jacobi_new(x, x0, a, c_inv), x[_I])
            _set_bnd3d_(b, x)
    return x.to(out_dtype)


def _lin_solve3d(b, x, x0, a, c, iters, red_black=False, dtype="float32"):
    """lin_solve3d in ``dtype`` (a StamConfig.solver_dtype) through its
    kernel, as the reference's _lin_solve3d dispatches: float32
    red-black to lin_solve3d_rb; float32 Jacobi to the whole solve
    (lin_solve3d_whole) for fields inside kernels.solve_whole_ok, else
    to lin_solve3d; bfloat16, Jacobi or red-black, to the whole solve
    inside the gate (at 2 B a cell), else to lin_solve3d_bf16 or
    lin_solve3d_rb_bf16."""
    dt = solver_dtype(dtype)
    if dt == torch.float32 and red_black:
        return kernels.lin_solve3d_rb(b, x, x0, a, c, iters)
    if kernels.solve_whole_ok(x0, dt):
        return kernels.lin_solve3d_whole(b, x, x0, a, c, iters, red_black,
                                         dt)
    if dt == torch.float32:
        return kernels.lin_solve3d(b, x, x0, a, c, iters)
    solve = (kernels.lin_solve3d_rb_bf16 if red_black
             else kernels.lin_solve3d_bf16)
    return solve(b, x, x0, a, c, iters)


def lin_solve2d(b, x, x0, a, c, iters):
    """``iters`` Jacobi sweeps of (x0 + a * sum of the four neighbours) /
    c on the interior, the neighbours summed x-1, x+1, y-1, y+1, each
    sweep followed by set_bnd2d(b); as the reference's lin_solve2d.
    ``x`` None is a zero initial guess; the first sweep reads the stored
    ghosts of ``x``."""
    c_inv = 1.0 / c
    x = torch.zeros_like(x0) if x is None else x.clone()
    for _ in range(iters):
        nb = x[:-2, 1:-1] + x[2:, 1:-1] + x[1:-1, :-2] + x[1:-1, 2:]
        x[_I2] = (x0[_I2] + a * nb) * c_inv
        _set_bnd2d_(b, x)
    return x


def _lin_solve2d(b, x, x0, a, c, iters):
    """lin_solve2d through its kernel."""
    return kernels.lin_solve2d(b, x, x0, a, c, iters)


def _diffusion_ac(cfg: StamConfig, coeff: float, n: int, ndim: int = 3):
    """(a, c) of the implicit diffusion solve: a = dt coeff n^2,
    c = 1 + 6a in 3D, 1 + 4a in 2D."""
    a = cfg.dt * coeff * n * n
    return a, 1 + 2 * ndim * a


def diffuse2d(b, x, cfg: StamConfig, coeff, solve=_lin_solve2d):
    """Implicit diffusion of ``x`` by ``coeff``: ``cfg.jacobi_iters``
    Jacobi sweeps through ``solve``, x0 = x."""
    a, c = _diffusion_ac(cfg, coeff, x.shape[0] - 2, 2)
    return solve(b, x, x, a, c, cfg.jacobi_iters)


def diffuse3d(b, x, cfg: StamConfig, coeff):
    """Implicit diffusion of ``x`` by ``coeff``: ``cfg.jacobi_iters``
    plain Jacobi sweeps always (red_black applies to the pressure
    projection only) in ``cfg.solver_dtype``, x0 = x."""
    a, c = _diffusion_ac(cfg, coeff, x.shape[0] - 2)
    return _lin_solve3d(b, x, x, a, c, cfg.jacobi_iters,
                        dtype=cfg.solver_dtype)


def _diffuse_fields(fields, bnds, coeffs, cfg: StamConfig):
    """diffuse3d of each field with its b and coefficient: one whole-tier
    call (float32) for fields that fit it, else one solve per field, as
    the reference, whose multi-field whole diffusion is float32 only."""
    if (cfg.solver_dtype != "float32"
            or not kernels.solve_whole_ok(fields[0], torch.float32)):
        return tuple(diffuse3d(b, q, cfg, coeff)
                     for q, b, coeff in zip(fields, bnds, coeffs))
    n = fields[0].shape[0] - 2
    params = tuple((b, *_diffusion_ac(cfg, coeff, n))
                   for b, coeff in zip(bnds, coeffs))
    return kernels.diffuse3d_multi(fields, params, cfg.jacobi_iters)


# ---------------------------------------------------------------------------
# semi-Lagrangian advection

_SHIFTS = {
    2: [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)],
    3: [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
        for dz in (-1, 0, 1)],
}


def _axis_index(n: int, a: int, ndim: int, device) -> torch.Tensor:
    """The 1-based interior index along axis ``a``, shaped to broadcast
    over the n^ndim interior."""
    idx = torch.arange(n, dtype=torch.float32, device=device) + 1.0
    return idx.reshape([-1 if b == a else 1 for b in range(ndim)])


def _with_interior(q, out, b):
    q = q.clone()
    q[_interior(q.dim())] = out
    return _set_bnd_(b, q)


def _advect_stencil(fields, bnds, vels, dt0: float):
    """9-tap (2D) or 27-tap (3D) stencil semi-Lagrangian advection of
    each field in ``fields`` by the velocity components ``vels``, then
    set_bnd(b) per field.

    The backtrace displacement -dt0 * vel is clamped to one cell and to
    the source range [0.5, n + 0.5]; the source value at offset o is the
    sum over shifts d in {-1, 0, 1}^ndim (the reference's _SHIFTS order)
    of max(0, 1 - |o_a - d_a|) per axis times the shifted field.  The
    weights depend only on the velocity, so they are built once for all
    fields."""
    ndim, u = len(vels), vels[0]
    n = u.shape[0] - 2
    interior = _interior(ndim)
    hats = []
    for a, vel in enumerate(vels):
        ia = _axis_index(n, a, ndim, u.device)
        off = torch.clamp(-dt0 * vel[interior], -1.0, 1.0)
        off = torch.clamp(off, 0.5 - ia, n + 0.5 - ia)
        hats.append([torch.clamp(1.0 - torch.abs(off - d), min=0.0)
                     for d in (-1, 0, 1)])
    outs = [torch.zeros((n,) * ndim, dtype=torch.float32, device=u.device)
            for _ in fields]
    for d in _SHIFTS[ndim]:
        wgt = hats[0][d[0] + 1]
        for a in range(1, ndim):
            wgt = wgt * hats[a][d[a] + 1]
        sl = tuple(slice(1 + da, 1 + da + n) for da in d)
        for out, q in zip(outs, fields):
            out += wgt * q[sl]
    return [_with_interior(q, out, b)
            for out, q, b in zip(outs, fields, bnds)]


def advect2d_stencil(b, q, u, v, cfg: StamConfig):
    n = q.shape[0] - 2
    return _advect_stencil((q,), (b,), (u, v), cfg.dt * n)[0]


def advect3d_stencil(b, q, u, v, w, cfg: StamConfig):
    n = q.shape[0] - 2
    return _advect_stencil((q,), (b,), (u, v, w), cfg.dt * n)[0]


def _advect_gather(b, q, vels, dt0: float):
    """Unbounded semi-Lagrangian advection of ``q`` by ``vels``: the
    backtrace clipped to [0.5, n + 0.5], floored to a cell, and the
    multilinear interpolation of its 2^ndim corners, nested as the
    reference writes it (s0 (t0 g00 + t1 g01) + s1 (t0 g10 + t1 g11) in
    2D); then set_bnd(b)."""
    ndim = len(vels)
    n = q.shape[0] - 2
    interior = _interior(ndim)
    lo, w1 = [], []
    for a, vel in enumerate(vels):
        x = torch.clamp(_axis_index(n, a, ndim, q.device)
                        - dt0 * vel[interior], 0.5, n + 0.5)
        i0 = torch.floor(x).to(torch.int64)
        lo.append(i0)
        w1.append(x - i0)

    def interp(a, corner):
        if a == ndim:
            return q[tuple(i0 + d for i0, d in zip(lo, corner))]
        return ((1 - w1[a]) * interp(a + 1, corner + (0,))
                + w1[a] * interp(a + 1, corner + (1,)))

    return _with_interior(q, interp(0, ()), b)


def advect2d(b, q, u, v, cfg: StamConfig):
    return _advect_gather(b, q, (u, v), cfg.dt * (q.shape[0] - 2))


def advect3d(b, q, u, v, w, cfg: StamConfig):
    return _advect_gather(b, q, (u, v, w), cfg.dt * (q.shape[0] - 2))


def _advect_fields(fields, bnds, vels, cfg: StamConfig):
    """Each field advected by ``vels`` with its b, by ``cfg.advect_mode``:
    the stencil through kernels.advect3d_multi in 3D (one call), else
    torch ops."""
    dt0 = cfg.dt * (vels[0].shape[0] - 2)
    if cfg.advect_mode != "stencil":
        return tuple(_advect_gather(b, q, vels, dt0)
                     for q, b in zip(fields, bnds))
    if len(vels) == 3:
        return kernels.advect3d_multi(fields, bnds, *vels, dt0)
    return tuple(_advect_stencil(fields, bnds, vels, dt0))


# ---------------------------------------------------------------------------
# projection


def divergence2d(u, v):
    n = u.shape[0] - 2
    h = 1.0 / n
    return -0.5 * h * (u[2:, 1:-1] - u[:-2, 1:-1]
                       + v[1:-1, 2:] - v[1:-1, :-2])


def poisson_residual2d(p, div):
    """Max-norm residual of the 5-point Poisson system the projection
    solved."""
    nb = p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
    return torch.max(torch.abs(div[_I2] + nb - 4.0 * p[_I2]))


def divergence3d(u, v, w):
    """-0.5 h (central divergence) on the interior; h = 1 / n from the y
    extent, so an x-slab of the sharded step takes the global h."""
    h = 1.0 / (u.shape[1] - 2)
    return -0.5 * h * (u[2:, 1:-1, 1:-1] - u[:-2, 1:-1, 1:-1]
                       + v[1:-1, 2:, 1:-1] - v[1:-1, :-2, 1:-1]
                       + w[1:-1, 1:-1, 2:] - w[1:-1, 1:-1, :-2])


def poisson_residual3d(p, div):
    nb = (p[:-2, 1:-1, 1:-1] + p[2:, 1:-1, 1:-1]
          + p[1:-1, :-2, 1:-1] + p[1:-1, 2:, 1:-1]
          + p[1:-1, 1:-1, :-2] + p[1:-1, 1:-1, 2:])
    return torch.max(torch.abs(div[_I] + nb - 6.0 * p[_I]))


# ---------------------------------------------------------------------------
# geometric multigrid for the pressure system (the reference's mg_solve3d):
# V(2,2) cycles of red-black smoothing, restriction and prolongation as
# torch ops


def _mg_residual3d(p, x0):
    """x0 + sum of neighbours - 6 p on the interior: the residual of the
    h^2-scaled system lin_solve3d solves at a = 1, c = 6."""
    nb = (p[:-2, 1:-1, 1:-1] + p[2:, 1:-1, 1:-1]
          + p[1:-1, :-2, 1:-1] + p[1:-1, 2:, 1:-1]
          + p[1:-1, 1:-1, :-2] + p[1:-1, 1:-1, 2:])
    return x0[_I] + nb - 6.0 * p[_I]


def _mg_restrict3d(r):
    """The mean of each 2x2x2 block of the interior residual ``r`` (n^3),
    times 4 (the coarse h^2), as a ghosted ((n/2)+2)^3 right-hand side
    with zero ghosts."""
    m = r.shape[0] // 2
    rc = r.reshape(m, 2, m, 2, m, 2).mean(dim=(1, 3, 5))
    return torch.nn.functional.pad(4.0 * rc, (1,) * 6)


def _mg_prolong3d(e):
    """The ghosted coarse correction's interior, each cell repeated onto
    its 2x2x2 fine cells."""
    m = e.shape[0] - 2
    ei = e[_I].reshape(m, 1, m, 1, m, 1)
    return ei.expand(m, 2, m, 2, m, 2).reshape(2 * m, 2 * m, 2 * m)


def _mg_vcycle(p, x0, cfg: StamConfig, nu1=2, nu2=2, coarsest=8):
    """One V(nu1, nu2) cycle of red-black smoothing from guess ``p``.
    Levels of n >= 48 solve in ``cfg.solver_dtype``; smaller ones in
    float32, as the reference sends them to its dense path, which has no
    bfloat16 solve.  The coarsest level (n <= coarsest, or odd n) runs
    20 red-black iterations."""
    n = x0.shape[0] - 2
    dtype = cfg.solver_dtype if n >= 48 else "float32"
    if n <= coarsest or n % 2:
        return _lin_solve3d(0, p, x0, 1.0, 6.0, 20, red_black=True,
                            dtype=dtype)
    p = _lin_solve3d(0, p, x0, 1.0, 6.0, nu1, red_black=True, dtype=dtype)
    ec = _mg_vcycle(None, _mg_restrict3d(_mg_residual3d(p, x0)), cfg, nu1,
                    nu2, coarsest)
    p = p.clone()
    p[_I] += _mg_prolong3d(ec)
    p = _set_bnd3d_(0, p)
    return _lin_solve3d(0, p, x0, 1.0, 6.0, nu2, red_black=True, dtype=dtype)


def mg_solve3d(x0, cfg: StamConfig, cycles: Optional[int] = None):
    """Solve the ghosted pressure system of ``x0`` (lin_solve3d's a = 1,
    c = 6, b = 0) by ``cycles`` (default ``cfg.mg_cycles``) V(2,2)
    multigrid cycles from a zero guess; as the reference's mg_solve3d.
    Multigrid has no whole tier: each smoothing is one solve call."""
    p = None
    for _ in range(cfg.mg_cycles if cycles is None else cycles):
        p = _mg_vcycle(p, x0, cfg)
    return torch.zeros_like(x0) if p is None else p


@contextlib.contextmanager
def _matmul_precision(precision: str, device: torch.device):
    """Float32 matmul mode for one DCT solve: TF32 for the "high" and
    "default" tiers on a CUDA device, full float32 otherwise (always for
    "highest", and on the CPU, where the reference's tiers are float32
    too).  Set explicitly and restored after: the final solve must not
    inherit TF32 from the caller."""
    if precision not in ("highest", "high", "default"):
        raise ValueError(f"unknown DCT precision tier {precision!r}")
    tf32 = precision != "highest" and device.type == "cuda"
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _dct_axis(a, m, ax):
    """Contract matrix m[q, i] against axis ``ax`` of ``a``."""
    return torch.tensordot(m, a, dims=([1], [ax])).movedim(0, ax)


@functools.lru_cache(maxsize=None)
def _dct_mats(n: int, device: torch.device):
    """(forward DCT-II matrix (q,i), inverse DCT matrix (i,q),
    per-axis Neumann-Laplacian eigenvalues) for extent ``n``, built in
    float32 on the CPU by the reference's formulas."""
    i = torch.arange(n, dtype=torch.float32)
    C = torch.cos(math.pi / n * i[:, None] * (i[None, :] + 0.5))
    Ci = C.T * (torch.where(i == 0, 1.0, 2.0) / n)
    lam1 = 2.0 - 2.0 * torch.cos(math.pi * i / n)
    return tuple(t.contiguous().to(device) for t in (C, Ci, lam1))


@functools.lru_cache(maxsize=None)
def _dct4_mat(m: int, device: torch.device):
    """DCT-IV matrix M[q, i] = cos(pi (2q+1)(2i+1) / (4m)); M @ M =
    (m/2) I, so its inverse is (2/m) M."""
    i = torch.arange(m, dtype=torch.float32)
    M = torch.cos(math.pi / (4 * m) * (2 * i[:, None] + 1)
                  * (2 * i[None, :] + 1))
    return M.to(device)


def _radix_lams(n: int, device: torch.device):
    """(even-block, odd-block) eigenvalue vectors of a radix-2-split
    axis of extent n: lam[2q] and lam[2q+1]."""
    lam_full = _dct_mats(n, device)[2]
    return lam_full[0::2], lam_full[1::2]


def _dct2_split_fwd(a, ax, levels):
    """DCT-II along ``ax`` with up to ``levels`` radix-2 fold levels on
    the even branch: x[i] +- x[n-1-i] halves go through a half-size
    DCT-II (recursively) and a half-size DCT-IV.  Returns [(block,
    eigenvalue vector)], deepest even block first (it holds the q=0
    gauge mode)."""
    n = a.shape[ax]
    if levels <= 0 or n % 2 or n < 4:
        C, _, lam1 = _dct_mats(n, a.device)
        return [(_dct_axis(a, C, ax), lam1)]
    m = n // 2
    front = a.narrow(ax, 0, m)
    back = torch.flip(a.narrow(ax, m, m), (ax,))
    g, h = front + back, front - back
    _, lam_o = _radix_lams(n, a.device)
    return (_dct2_split_fwd(g, ax, levels - 1)
            + [(_dct_axis(h, _dct4_mat(m, a.device), ax), lam_o)])


def _dct2_split_nblocks(n, levels):
    """Piece count produced by _dct2_split_fwd."""
    if levels <= 0 or n % 2 or n < 4:
        return 1
    return _dct2_split_nblocks(n // 2, levels - 1) + 1


def _dct2_split_inv(blocks, ax):
    """Inverse of _dct2_split_fwd on its list of coefficient blocks."""
    if len(blocks) == 1:
        n = blocks[0].shape[ax]
        return _dct_axis(blocks[0], _dct_mats(n, blocks[0].device)[1], ax)
    m = blocks[-1].shape[ax]
    g = _dct2_split_inv(blocks[:-1], ax)
    M4i = _dct4_mat(m, g.device) * (2.0 / m)
    h = _dct_axis(blocks[-1], M4i, ax)
    return torch.cat([0.5 * (g + h), torch.flip(0.5 * (g - h), (ax,))],
                     dim=ax)


def _radix_fwd_axis(pieces, ax, levels=1):
    """Radix forward on ``ax`` over (block, per-axis eigenvalue list)
    pieces, keeping inverse-time partners adjacent."""
    nxt = []
    for a, lams in pieces:
        for blk, lamv in _dct2_split_fwd(a, ax, levels):
            nxt.append((blk, lams + [lamv]))
    return nxt


def _radix_inv_axis(pieces, ax, levels=1):
    """Inverse of _radix_fwd_axis: consecutive groups merge back."""
    n = 2 * pieces[-1].shape[ax]
    k = _dct2_split_nblocks(n, levels)
    return [_dct2_split_inv(pieces[j:j + k], ax)
            for j in range(0, len(pieces), k)]


def _dct_solve_interior(xi, precision="highest", radix_min=0,
                        radix_levels=1):
    """Exact Neumann-Poisson solve on an interior array of any rank:
    solves `(2d) x - sum_nb x = xi` with mirror ghosts, whose per-axis
    operator the type-II cosine basis diagonalizes (eigenvalues
    2 - 2 cos(pi q / n)).  Forward DCT, diagonal scale with the q=0
    gauge mode zeroed, inverse DCT.  Axes of even extent >= radix_min
    (0 = none) use the radix-2 split of _dct2_split_fwd."""
    nd = xi.ndim
    radix = [bool(radix_min) and n >= radix_min and n % 2 == 0
             for n in xi.shape]
    with _matmul_precision(precision, xi.device):
        if not any(radix):
            lam = 0.0
            invs = []
            with span("grid.dct", "forward"):
                for ax, n in enumerate(xi.shape):
                    C, Ci, lam1 = _dct_mats(n, xi.device)
                    xi = _dct_axis(xi, C, ax)
                    lam = lam + lam1.reshape((-1,) + (1,) * (nd - 1 - ax))
                    invs.append(Ci)
            with span("grid.dct", "scale"):
                coef = xi / torch.where(lam == 0.0, 1.0, lam)
                coef[(0,) * nd] = 0.0              # pressure gauge
            with span("grid.dct", "inverse"):
                for ax, Ci in enumerate(invs):
                    coef = _dct_axis(coef, Ci, ax)
            return coef

        pieces = [(xi, [])]
        with span("grid.dct", "forward"):
            for ax, n in enumerate(xi.shape):
                if radix[ax]:
                    pieces = _radix_fwd_axis(pieces, ax, radix_levels)
                else:
                    C, _, lam1 = _dct_mats(n, xi.device)
                    pieces = [(_dct_axis(a, C, ax), lams + [lam1])
                              for a, lams in pieces]

        # the all-even piece 0 holds the gauge mode at its origin; every
        # other piece has an odd-block eigenvalue component, all > 0
        solved = []
        with span("grid.dct", "scale"):
            for k, (a, lams) in enumerate(pieces):
                lam = 0.0
                for ax, l1 in enumerate(lams):
                    lam = lam + l1.reshape((-1,) + (1,) * (nd - 1 - ax))
                if k == 0:
                    a = a / torch.where(lam == 0.0, 1.0, lam)
                    a[(0,) * nd] = 0.0             # pressure gauge
                else:
                    a = a / lam
                solved.append(a)
        pieces = solved

        with span("grid.dct", "inverse"):
            for ax in reversed(range(nd)):
                if radix[ax]:
                    pieces = _radix_inv_axis(pieces, ax, radix_levels)
                else:
                    Ci = _dct_mats(xi.shape[ax], xi.device)[1]
                    pieces = [_dct_axis(a, Ci, ax) for a in pieces]
        return pieces[0]


def _dct_params(cfg, final=True):
    """(precision, radix_min, radix_levels) for one projection solve;
    ``final=False`` is the step's first solve, which may run at the
    cheaper ``dct_precision_first`` tier."""
    if cfg is None:
        return "highest", 0, 1
    prec = cfg.dct_precision
    if not final and cfg.dct_precision_first:
        prec = cfg.dct_precision_first
    if cfg.dct_radix_min >= 0:
        rmin = cfg.dct_radix_min
    else:
        rmin = 256 if prec == "highest" else 0
    return prec, rmin, cfg.dct_radix_levels


def dct_solve3d(x0, cfg=None, final=True):
    """Spectral pressure solve on the ghosted 3D array; the result has
    b=0 ghosts."""
    sol = _dct_solve_interior(x0[_I], *_dct_params(cfg, final))
    p = torch.zeros_like(x0)
    p[_I] = sol
    return _set_bnd3d_(0, p)


def dct_solve2d(x0, cfg=None):
    """Spectral solve of the 2D projection's system (lin_solve2d's b = 0,
    c = 4), at the final solve's tier and radix settings; the result has
    b=0 ghosts."""
    p = torch.zeros_like(x0)
    p[_I2] = _dct_solve_interior(x0[_I2], *_dct_params(cfg, final=True))
    return _set_bnd2d_(0, p)


def project2d(u, v, cfg: StamConfig, with_residual: bool = False,
              solve=_lin_solve2d):
    """Pressure projection: the DCT solve, or else (every other
    projection, red_black ignored, as in the reference) ``cfg.jacobi_iters``
    Jacobi sweeps through ``solve`` from a zero guess; ``with_residual``
    also returns the max-norm residual of the Poisson system it solved."""
    h = 1.0 / (u.shape[0] - 2)
    div = torch.zeros_like(u)
    div[_I2] = divergence2d(u, v)
    _set_bnd2d_(0, div)
    if cfg.projection == "dct":
        p = dct_solve2d(div, cfg)
    else:
        p = solve(0, None, div, 1.0, 4.0, cfg.jacobi_iters)
    u, v = u.clone(), v.clone()
    u[_I2] += -0.5 * (p[2:, 1:-1] - p[:-2, 1:-1]) / h
    v[_I2] += -0.5 * (p[1:-1, 2:] - p[1:-1, :-2]) / h
    u, v = _set_bnd2d_(1, u), _set_bnd2d_(2, v)
    if with_residual:
        return u, v, poisson_residual2d(p, div)
    return u, v


def project3d(u, v, w, cfg: StamConfig, with_residual: bool = False,
              final=True):
    """Pressure projection: the DCT solve, the multigrid solve
    (mg_solve3d), or ``cfg.jacobi_iters`` Jacobi or red-black sweeps from
    a zero guess in ``cfg.solver_dtype``; ``with_residual`` also returns
    the max-norm residual of the Poisson system it solved.  A float32
    Jacobi projection of fields inside the whole tier, without the
    residual, is one fused call (kernels.project3d_whole).

    Spans: ``grid.project`` (detail ``fused``, ``first`` or ``final``)
    around the whole projection, ``grid.solve`` (detail ``dct``,
    ``multigrid``, ``rb``, ``jacobi``, ``rb_bf16`` or ``jacobi_bf16``)
    around the solve alone and ``grid.residual`` around the residual."""
    jacobi = cfg.projection not in ("multigrid", "dct")
    if (jacobi and cfg.solver_dtype == "float32" and not with_residual
            and kernels.solve_whole_ok(u, torch.float32)):
        with span("grid.project", "fused"):
            return kernels.project3d_whole(u, v, w, cfg.jacobi_iters,
                                           cfg.red_black)
    with span("grid.project", "final" if final else "first"):
        div = kernels.div3d(u, v, w)
        if cfg.projection == "multigrid":
            with span("grid.solve", "multigrid"):
                p = mg_solve3d(div, cfg)
        elif jacobi:
            kind = "rb" if cfg.red_black else "jacobi"
            if cfg.solver_dtype != "float32":
                kind += "_bf16"
            with span("grid.solve", kind):
                p = _lin_solve3d(0, None, div, 1.0, 6.0, cfg.jacobi_iters,
                                 red_black=cfg.red_black,
                                 dtype=cfg.solver_dtype)
        else:
            with span("grid.solve", "dct"):
                p = dct_solve3d(div, cfg, final=final)
        u, v, w = kernels.gradsub3d(p, u, v, w)
        if with_residual:
            with span("grid.residual"):
                return u, v, w, poisson_residual3d(p, div)
        return u, v, w


# ---------------------------------------------------------------------------
# forcings


def vorticity_confinement3d(u, v, w, cfg: StamConfig):
    n = u.shape[0] - 2
    h = 1.0 / n

    def d(q, axis):
        hi, lo = [slice(1, -1)] * 3, [slice(1, -1)] * 3
        hi[axis] = slice(2, None)
        lo[axis] = slice(0, -2)
        return 0.5 * (q[tuple(hi)] - q[tuple(lo)]) / h

    wx = d(w, 1) - d(v, 2)
    wy = d(u, 2) - d(w, 0)
    wz = d(v, 0) - d(u, 1)
    mag = torch.zeros_like(u)                # ghosts stay 0 (no set_bnd)
    mag[_I] = torch.sqrt(wx * wx + wy * wy + wz * wz)
    gx, gy, gz = d(mag, 0), d(mag, 1), d(mag, 2)
    norm = torch.sqrt(gx * gx + gy * gy + gz * gz) + 1e-5
    gx, gy, gz = gx / norm, gy / norm, gz / norm
    eps_h = cfg.vorticity_eps * h
    out = []
    for b, q, f in ((1, u, gy * wz - gz * wy), (2, v, gz * wx - gx * wz),
                    (3, w, gx * wy - gy * wx)):
        q = q.clone()
        q[_I] += cfg.dt * (eps_h * f)
        out.append(_set_bnd3d_(b, q))
    return tuple(out)


def buoyancy3d(w, dens, temp, cfg: StamConfig):
    """Plume forcing on the vertical (z) velocity:
    f_z = -alpha * dens + beta * (temp - ambient)."""
    f = (-cfg.buoyancy_alpha * dens[_I]
         + cfg.buoyancy_beta * (temp[_I] - cfg.ambient_temp))
    w = w.clone()
    w[_I] += cfg.dt * f
    return _set_bnd3d_(3, w)


def vorticity_confinement2d(u, v, cfg: StamConfig):
    """Confinement force eps h (gy curl, -gx curl) added to (u, v); |curl|
    is 0 on the ghosts (no set_bnd), as in the reference."""
    h = 1.0 / (u.shape[0] - 2)
    curl = 0.5 * ((v[2:, 1:-1] - v[:-2, 1:-1])
                  - (u[1:-1, 2:] - u[1:-1, :-2])) / h
    mag = torch.zeros_like(u)
    mag[_I2] = torch.abs(curl)
    gx = 0.5 * (mag[2:, 1:-1] - mag[:-2, 1:-1]) / h
    gy = 0.5 * (mag[1:-1, 2:] - mag[1:-1, :-2]) / h
    norm = torch.sqrt(gx * gx + gy * gy) + 1e-5
    gx, gy = gx / norm, gy / norm
    fu = cfg.vorticity_eps * h * gy * curl
    fv = -cfg.vorticity_eps * h * gx * curl
    u, v = u.clone(), v.clone()
    u[_I2] += cfg.dt * fu
    v[_I2] += cfg.dt * fv
    return _set_bnd2d_(1, u), _set_bnd2d_(2, v)


def buoyancy2d(v, dens, temp, cfg: StamConfig):
    """f_y = -alpha * dens + beta * (temp - ambient) on v."""
    f = (-cfg.buoyancy_alpha * dens[_I2]
         + cfg.buoyancy_beta * (temp[_I2] - cfg.ambient_temp))
    v = v.clone()
    v[_I2] += cfg.dt * f
    return _set_bnd2d_(2, v)


# ---------------------------------------------------------------------------
# the steps

# state field -> the key of its source
_SOURCE_KEYS = {"u": "fu", "v": "fv", "w": "fw", "dens": "dens",
                "temp": "temp"}


def _with_sources(state, cfg: StamConfig, sources: Optional[dict]):
    """A state of the same rank with ``sources`` (source key -> tensor)
    added times dt, as the reference adds them (0 for a missing key)."""
    if not sources:
        return state
    return type(state)(**{
        f.name: getattr(state, f.name)
        + cfg.dt * sources.get(_SOURCE_KEYS[f.name], 0.0)
        for f in dataclasses.fields(state)})


def step2d(state: GridState2D, cfg: StamConfig,
           sources: Optional[dict] = None, with_residual: bool = False):
    """One 2D smoke step: sources, forces, velocity diffusion (visc),
    projection, velocity self-advection, projection, dens/temp diffusion
    (diff, temp_diff) and advection.  ``sources`` maps "fu", "fv", "dens"
    and "temp" to tensors added times dt first.

    A stencil-advection Jacobi step in float32 of fields inside
    kernels.step2d_whole_ok that does not report the residual is one
    call (kernels.step2d_whole), as the reference takes
    step2d_whole_pallas; every other step is step2d_multi."""
    s = _with_sources(state, cfg, sources)
    if (cfg.advect_mode == "stencil" and cfg.projection == "jacobi"
            and cfg.solver_dtype == "float32" and not with_residual
            and kernels.step2d_whole_ok(s.u)):
        return GridState2D(*kernels.step2d_whole(s.u, s.v, s.dens, s.temp,
                                                 cfg))
    return step2d_multi(s, cfg, with_residual)


def step2d_multi(state: GridState2D, cfg: StamConfig,
                 with_residual: bool = False, solve=_lin_solve2d):
    """step2d without sources, in the reference's multi-call order: each
    solve through ``solve`` (kernels.lin_solve2d by default), the other
    stages torch ops."""
    u, v, dens, temp = state.u, state.v, state.dens, state.temp
    if cfg.buoyancy_alpha or cfg.buoyancy_beta:
        v = buoyancy2d(v, dens, temp, cfg)
    if cfg.vorticity_eps:
        u, v = vorticity_confinement2d(u, v, cfg)
    if cfg.visc:
        u = diffuse2d(1, u, cfg, cfg.visc, solve)
        v = diffuse2d(2, v, cfg, cfg.visc, solve)
    u, v = project2d(u, v, cfg, solve=solve)
    u, v = _advect_fields((u, v), (1, 2), (u, v), cfg)
    if with_residual:
        u, v, res = project2d(u, v, cfg, True, solve)
    else:
        u, v = project2d(u, v, cfg, solve=solve)
    if cfg.diff:
        dens = diffuse2d(0, dens, cfg, cfg.diff, solve)
    if cfg.temp_diff:
        temp = diffuse2d(0, temp, cfg, cfg.temp_diff, solve)
    dens, temp = _advect_fields((dens, temp), (0, 0), (u, v), cfg)
    out = GridState2D(u=u, v=v, dens=dens, temp=temp)
    return (out, res) if with_residual else out


def run2d_python(state: GridState2D, cfg: StamConfig, n_steps: int,
                 sources=None, snapshot_every: int = 0, snapshot_fn=None):
    """Run ``n_steps`` steps with ``sources`` added each step, queued on
    the device without a host sync.  Every ``snapshot_every`` steps
    ``snapshot_fn(step, state)`` receives the state as CPU tensors (the
    one host sync).  Returns the state."""
    for i in range(n_steps):
        state = step2d(state, cfg, sources)
        if (snapshot_fn is not None and snapshot_every > 0
                and (i + 1) % snapshot_every == 0):
            snapshot_fn(i + 1, GridState2D(state.u.cpu(), state.v.cpu(),
                                           state.dens.cpu(),
                                           state.temp.cpu()))
    return state


def run_each_residual(step, state, cfg, n_steps: int):
    """``n_steps`` calls of ``step(state, cfg, with_residual=True)``, as
    the reference's run scans, in one ``grid.frame`` span; returns
    (state, residuals as an (n_steps,) tensor)."""
    with span("grid.frame"):
        res = []
        for _ in range(n_steps):
            state, r = step(state, cfg, with_residual=True)
            res.append(r)
        return state, torch.stack(res)


def run_last_residual(step, state, cfg, n_steps: int):
    """Run ``n_steps`` calls of ``step`` (at least one), queued on the
    device without a host sync, in one ``grid.frame`` span; the residual
    of the final step only.  Returns (state, residual as a (1,)
    tensor)."""
    with span("grid.frame"):
        for _ in range(max(n_steps - 1, 0)):
            state = step(state, cfg)
        state, res = step(state, cfg, with_residual=True)
        return state, res.reshape(1)


def run2d(state: GridState2D, cfg: StamConfig, n_steps: int):
    """``n_steps`` steps, each reporting its Poisson residual, as the
    reference's run2d scan; returns (state, residuals as an (n_steps,)
    tensor)."""
    return run_each_residual(step2d, state, cfg, n_steps)


def step3d(state: GridState3D, cfg: StamConfig,
           sources: Optional[dict] = None, with_residual: bool = False):
    """One 3D step with set_bnd walls: forcing, velocity diffusion
    (visc), projection (first solve), velocity self-advection,
    projection (final solve), dens/temp diffusion (diff, temp_diff),
    dens/temp advection.  ``sources`` maps field names ("fu", "fv",
    "fw", "dens", "temp") to tensors added times dt first.

    A stencil-advection Jacobi step of fields inside the whole step's
    gate that does not report the residual is one fused call
    (kernels.step3d_whole), as the reference's step3d_whole_pallas;
    every other step, gather advection's and a bfloat16 solver's
    included, is step3d_multi.  Its span is ``grid.step``, detail
    ``whole`` or ``multi``."""
    s = _with_sources(state, cfg, sources)
    if (cfg.advect_mode == "stencil" and cfg.projection == "jacobi"
            and cfg.solver_dtype == "float32" and not with_residual
            and kernels.step_whole_ok(s.u)):
        with span("grid.step", "whole"):
            return GridState3D(*kernels.step3d_whole(s.u, s.v, s.w, s.dens,
                                                     s.temp, cfg))
    with span("grid.step", "multi"):
        return step3d_multi(s, cfg, with_residual)


def step3d_multi(state: GridState3D, cfg: StamConfig,
                 with_residual: bool = False):
    """step3d without sources, each stage through its own kernel (gather
    advection as torch ops), each in its span: ``grid.forcing``,
    ``grid.diffuse`` and ``grid.advect`` (detail ``velocity`` or
    ``scalars``), and project3d's."""
    u, v, w, dens, temp = state.u, state.v, state.w, state.dens, state.temp
    if cfg.buoyancy_alpha or cfg.buoyancy_beta or cfg.vorticity_eps:
        with span("grid.forcing"):
            u, v, w = kernels.forcing3d(u, v, w, dens, temp, cfg)
    if cfg.visc:
        with span("grid.diffuse", "velocity"):
            u, v, w = _diffuse_fields((u, v, w), (1, 2, 3),
                                      (cfg.visc,) * 3, cfg)
    u, v, w = project3d(u, v, w, cfg, final=False)
    with span("grid.advect", "velocity"):
        u, v, w = _advect_fields((u, v, w), (1, 2, 3), (u, v, w), cfg)
    if with_residual:
        u, v, w, res = project3d(u, v, w, cfg, with_residual=True)
    else:
        u, v, w = project3d(u, v, w, cfg)
    coeffs = {f: c for f, c in (("dens", cfg.diff), ("temp", cfg.temp_diff))
              if c}
    if coeffs:
        fields = {"dens": dens, "temp": temp}
        with span("grid.diffuse", "scalars"):
            fields.update(zip(coeffs, _diffuse_fields(
                [fields[f] for f in coeffs], (0,) * len(coeffs),
                list(coeffs.values()), cfg)))
        dens, temp = fields["dens"], fields["temp"]
    with span("grid.advect", "scalars"):
        dens, temp = _advect_fields((dens, temp), (0, 0), (u, v, w), cfg)
    out = GridState3D(u=u, v=v, w=w, dens=dens, temp=temp)
    return (out, res) if with_residual else out


def run3d_python(state: GridState3D, cfg: StamConfig, n_steps: int):
    """Run ``n_steps`` steps (at least one).  Steps are queued on the
    device without a host sync; the Poisson residual is evaluated on the
    final step only.  Returns (state, residual as a (1,) tensor)."""
    return run_last_residual(step3d, state, cfg, n_steps)


def run3d(state: GridState3D, cfg: StamConfig, n_steps: int):
    """``n_steps`` steps, each reporting its Poisson residual, as the
    reference's run3d scan; returns (state, residuals as an (n_steps,)
    tensor)."""
    return run_each_residual(step3d, state, cfg, n_steps)
