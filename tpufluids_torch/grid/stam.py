"""Stam-style stable-fluids solver in PyTorch: the 3D step of
``tpufluids.grid.stam`` with the spectral (DCT) or the Jacobi
(plain or red-black) projection, and diffusion.

Fields are dense (n+2)^3 float32 tensors with one ghost layer, z
contiguous, on any device.  The functions are pure: they return new
tensors and never write into their arguments.  The stencil stages of
the step (forcing, divergence, gradient subtraction, advection) and the
Jacobi solves go through ``tpufluids_torch.grid.kernels``, which
launches a CUDA kernel for a CUDA tensor and runs the plain PyTorch
version for a CPU tensor; the DCT solve is dense matrix products
(``torch.tensordot``).

The port keeps the reference's dense ghosted layout and reads stored
ghosts, so it reproduces the reference's dense XLA path
(``solver_backend="xla"``).  Configurations outside the ported slice
raise ``NotImplementedError`` naming the ROADMAP.md item that will port
them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Optional

import torch

from tpufluids_torch.grid import kernels


@dataclasses.dataclass(frozen=True)
class StamConfig:
    """Same fields and defaults as ``tpufluids.grid.stam.StamConfig``.

    The port runs ``advect_mode="stencil"`` with the "dct" or "jacobi"
    projection, with or without diffusion; ``solver_backend`` is ignored
    (the device of the fields decides), and ``mg_cycles`` only matters
    to the multigrid projection, which the port does not run yet.
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
class GridState3D:
    u: torch.Tensor      # (n+2, n+2, n+2)
    v: torch.Tensor
    w: torch.Tensor
    dens: torch.Tensor
    temp: torch.Tensor


def make_grid3d(cfg: StamConfig, device="cuda") -> GridState3D:
    shape = (cfg.n + 2,) * 3

    def zeros():
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return GridState3D(u=zeros(), v=zeros(), w=zeros(), dens=zeros(),
                       temp=torch.full(shape, cfg.ambient_temp,
                                       dtype=torch.float32, device=device))


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to tpufluids_torch yet (ROADMAP.md Queue 1 "
        f"item 5, {item!r})")


def _check_slice(cfg: StamConfig):
    """Raise for a configuration outside the ported slices."""
    if cfg.advect_mode != "stencil":
        raise _not_ported(f"advect_mode={cfg.advect_mode!r}",
                          "gather advection")
    if cfg.projection == "multigrid":
        raise _not_ported("projection='multigrid'", "multigrid")
    if cfg.solver_dtype != "float32":
        raise _not_ported(f"solver_dtype={cfg.solver_dtype!r}",
                          "bfloat16 solver")


def step2d(*args, **kwargs):
    raise _not_ported("the 2D step", "2D step")


def run2d_python(*args, **kwargs):
    raise _not_ported("the 2D step", "2D step")


# ---------------------------------------------------------------------------
# set_bnd — Stam's boundary enforcement.  b = 0: continuity (copy),
# b = k: negate the component normal to axis k-1 at that face.

_I = (slice(1, -1),) * 3          # the interior of a ghosted field


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


def lin_solve3d(b, x, x0, a, c, iters, red_black=False):
    """``iters`` Jacobi sweeps of (x0 + a * sum of neighbours) / c on the
    interior, or red-black iterations of two half-sweeps (parity 0, then
    1), each sweep and half-sweep followed by set_bnd3d(b); as the
    reference's lin_solve3d.  ``x`` None is a zero initial guess; the
    first sweep reads the stored ghosts of ``x``."""
    c_inv = 1.0 / c
    x = torch.zeros_like(x0) if x is None else x.clone()
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
    return x


def _lin_solve3d(b, x, x0, a, c, iters, red_black=False):
    """lin_solve3d through its kernel: red-black to lin_solve3d_rb, plain
    Jacobi to lin_solve3d."""
    solve = kernels.lin_solve3d_rb if red_black else kernels.lin_solve3d
    return solve(b, x, x0, a, c, iters)


def _diffusion_ac(cfg: StamConfig, coeff: float, n: int):
    """(a, c) of the implicit diffusion solve: a = dt coeff n^2,
    c = 1 + 6a."""
    a = cfg.dt * coeff * n * n
    return a, 1 + 6 * a


def diffuse3d(b, x, cfg: StamConfig, coeff):
    """Implicit diffusion of ``x`` by ``coeff``: ``cfg.jacobi_iters``
    plain Jacobi sweeps always (red_black applies to the pressure
    projection only), x0 = x."""
    a, c = _diffusion_ac(cfg, coeff, x.shape[0] - 2)
    return _lin_solve3d(b, x, x, a, c, cfg.jacobi_iters)


def _diffuse_fields(fields, bnds, coeffs, cfg: StamConfig):
    """diffuse3d of each field with its b and coefficient: one whole-tier
    call for fields that fit it, else one solve per field."""
    if not kernels.whole_ok(fields[0]):
        return tuple(diffuse3d(b, q, cfg, coeff)
                     for q, b, coeff in zip(fields, bnds, coeffs))
    n = fields[0].shape[0] - 2
    params = tuple((b, *_diffusion_ac(cfg, coeff, n))
                   for b, coeff in zip(bnds, coeffs))
    return kernels.diffuse3d_multi(fields, params, cfg.jacobi_iters)


# ---------------------------------------------------------------------------
# semi-Lagrangian advection

_SHIFTS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
           for dz in (-1, 0, 1)]


def _advect_stencil(fields, bnds, u, v, w, dt0: float):
    """27-tap stencil trilinear semi-Lagrangian advection of each field
    in ``fields`` by (u, v, w), then set_bnd3d(b) per field.

    The backtrace displacement -dt0 * vel is clamped to one cell and to
    the source range [0.5, n + 0.5]; the source value at offset o is the
    sum over shifts d in {-1, 0, 1}^3 of max(0, 1 - |o_a - d_a|) per axis
    times the shifted field.  The weights depend only on (u, v, w), so
    they are built once for all fields."""
    n = u.shape[0] - 2
    idx = torch.arange(n, dtype=torch.float32, device=u.device) + 1.0
    hats = []
    for a, vel in enumerate((u, v, w)):
        ia = idx.reshape([-1 if b == a else 1 for b in range(3)])
        off = torch.clamp(-dt0 * vel[_I], -1.0, 1.0)
        off = torch.clamp(off, 0.5 - ia, n + 0.5 - ia)
        hats.append([torch.clamp(1.0 - torch.abs(off - d), min=0.0)
                     for d in (-1, 0, 1)])
    outs = [torch.zeros((n,) * 3, dtype=torch.float32, device=u.device)
            for _ in fields]
    for d in _SHIFTS:
        wgt = hats[0][d[0] + 1] * hats[1][d[1] + 1] * hats[2][d[2] + 1]
        sl = tuple(slice(1 + da, 1 + da + n) for da in d)
        for out, q in zip(outs, fields):
            out += wgt * q[sl]
    result = []
    for out, q, b in zip(outs, fields, bnds):
        q = q.clone()
        q[_I] = out
        result.append(_set_bnd3d_(b, q))
    return result


def advect3d_stencil(b, q, u, v, w, cfg: StamConfig):
    n = q.shape[0] - 2
    return _advect_stencil((q,), (b,), u, v, w, cfg.dt * n)[0]


# ---------------------------------------------------------------------------
# projection


def divergence3d(u, v, w):
    n = u.shape[0] - 2
    h = 1.0 / n
    return -0.5 * h * (u[2:, 1:-1, 1:-1] - u[:-2, 1:-1, 1:-1]
                       + v[1:-1, 2:, 1:-1] - v[1:-1, :-2, 1:-1]
                       + w[1:-1, 1:-1, 2:] - w[1:-1, 1:-1, :-2])


def poisson_residual3d(p, div):
    nb = (p[:-2, 1:-1, 1:-1] + p[2:, 1:-1, 1:-1]
          + p[1:-1, :-2, 1:-1] + p[1:-1, 2:, 1:-1]
          + p[1:-1, 1:-1, :-2] + p[1:-1, 1:-1, 2:])
    return torch.max(torch.abs(div[_I] + nb - 6.0 * p[_I]))


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
            for ax, n in enumerate(xi.shape):
                C, Ci, lam1 = _dct_mats(n, xi.device)
                xi = _dct_axis(xi, C, ax)
                lam = lam + lam1.reshape((-1,) + (1,) * (nd - 1 - ax))
                invs.append(Ci)
            coef = xi / torch.where(lam == 0.0, 1.0, lam)
            coef[(0,) * nd] = 0.0                  # pressure gauge
            for ax, Ci in enumerate(invs):
                coef = _dct_axis(coef, Ci, ax)
            return coef

        pieces = [(xi, [])]
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
        for k, (a, lams) in enumerate(pieces):
            lam = 0.0
            for ax, l1 in enumerate(lams):
                lam = lam + l1.reshape((-1,) + (1,) * (nd - 1 - ax))
            if k == 0:
                a = a / torch.where(lam == 0.0, 1.0, lam)
                a[(0,) * nd] = 0.0                 # pressure gauge
            else:
                a = a / lam
            solved.append(a)
        pieces = solved

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


def project3d(u, v, w, cfg: StamConfig, with_residual: bool = False,
              final=True):
    """Pressure projection: the DCT solve, or ``cfg.jacobi_iters``
    Jacobi or red-black sweeps from a zero guess; ``with_residual`` also
    returns the max-norm residual of the Poisson system it solved.  A
    Jacobi projection of fields inside the whole tier, without the
    residual, is one fused call (kernels.project3d_whole)."""
    if cfg.projection == "multigrid":
        raise _not_ported("projection='multigrid'", "multigrid")
    jacobi = cfg.projection != "dct"
    if jacobi and not with_residual and kernels.whole_ok(u):
        return kernels.project3d_whole(u, v, w, cfg.jacobi_iters,
                                       cfg.red_black)
    div = kernels.div3d(u, v, w)
    if jacobi:
        p = _lin_solve3d(0, None, div, 1.0, 6.0, cfg.jacobi_iters,
                         red_black=cfg.red_black)
    else:
        p = dct_solve3d(div, cfg, final=final)
    u, v, w = kernels.gradsub3d(p, u, v, w)
    if with_residual:
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


# ---------------------------------------------------------------------------
# the step


def step3d(state: GridState3D, cfg: StamConfig,
           sources: Optional[dict] = None, with_residual: bool = False):
    """One 3D step with set_bnd walls: forcing, velocity diffusion
    (visc), projection (first solve), velocity self-advection,
    projection (final solve), dens/temp diffusion (diff, temp_diff),
    dens/temp advection.  ``sources`` maps field names ("fu", "fv",
    "fw", "dens", "temp") to tensors added times dt first.

    A Jacobi step of fields inside the whole step's gate that does not
    report the residual is one fused call (kernels.step3d_whole), as the
    reference's step3d_whole_pallas; every other step is step3d_multi."""
    _check_slice(cfg)
    u, v, w, dens, temp = state.u, state.v, state.w, state.dens, state.temp
    if sources:
        u = u + cfg.dt * sources.get("fu", 0.0)
        v = v + cfg.dt * sources.get("fv", 0.0)
        w = w + cfg.dt * sources.get("fw", 0.0)
        dens = dens + cfg.dt * sources.get("dens", 0.0)
        temp = temp + cfg.dt * sources.get("temp", 0.0)
    if (cfg.projection == "jacobi" and not with_residual
            and kernels.step_whole_ok(u)):
        return GridState3D(*kernels.step3d_whole(u, v, w, dens, temp, cfg))
    return step3d_multi(GridState3D(u=u, v=v, w=w, dens=dens, temp=temp),
                        cfg, with_residual)


def step3d_multi(state: GridState3D, cfg: StamConfig,
                 with_residual: bool = False):
    """step3d without sources, each stage through its own kernel."""
    _check_slice(cfg)
    u, v, w, dens, temp = state.u, state.v, state.w, state.dens, state.temp
    dt0 = cfg.dt * (u.shape[0] - 2)
    if cfg.buoyancy_alpha or cfg.buoyancy_beta or cfg.vorticity_eps:
        u, v, w = kernels.forcing3d(u, v, w, dens, temp, cfg)
    if cfg.visc:
        u, v, w = _diffuse_fields((u, v, w), (1, 2, 3), (cfg.visc,) * 3, cfg)
    u, v, w = project3d(u, v, w, cfg, final=False)
    u, v, w = kernels.advect3d_multi((u, v, w), (1, 2, 3), u, v, w, dt0)
    if with_residual:
        u, v, w, res = project3d(u, v, w, cfg, with_residual=True)
    else:
        u, v, w = project3d(u, v, w, cfg)
    coeffs = {f: c for f, c in (("dens", cfg.diff), ("temp", cfg.temp_diff))
              if c}
    if coeffs:
        fields = {"dens": dens, "temp": temp}
        fields.update(zip(coeffs, _diffuse_fields(
            [fields[f] for f in coeffs], (0,) * len(coeffs),
            list(coeffs.values()), cfg)))
        dens, temp = fields["dens"], fields["temp"]
    dens, temp = kernels.advect3d_multi((dens, temp), (0, 0), u, v, w, dt0)
    out = GridState3D(u=u, v=v, w=w, dens=dens, temp=temp)
    return (out, res) if with_residual else out


def run3d_python(state: GridState3D, cfg: StamConfig, n_steps: int):
    """Run ``n_steps`` steps (at least one).  Steps are queued on the
    device without a host sync; the Poisson residual is evaluated on the
    final step only.  Returns (state, residual as a (1,) tensor)."""
    for _ in range(max(n_steps - 1, 0)):
        state = step3d(state, cfg)
    state, res = step3d(state, cfg, with_residual=True)
    return state, res.reshape(1)
