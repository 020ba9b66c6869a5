"""A plain 3D stable-fluids step in PyTorch: the reference that decides a
grid cell's ``correct``.

Stam's step with set_bnd walls on dense ghosted (n+2)^3 float32 fields:
buoyancy, vorticity confinement, velocity diffusion, projection,
27-tap stencil self-advection of the velocity, projection, scalar
diffusion and advection.  The projection solves the Neumann Poisson
system by the cosine transform (dense DCT-II matrices built here in
float64) or by Jacobi or red-black sweeps from a zero guess.  It reads
only its arguments: a dict of the configuration's keywords and five
tensors.  TF32 is off for every product it takes.
"""

from __future__ import annotations

import math

import torch

_I = (slice(1, -1),) * 3
_SHIFTS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
           for dz in (-1, 0, 1)]
FIELDS = ("u", "v", "w", "dens", "temp")


def set_bnd(b: int, x: torch.Tensor) -> torch.Tensor:
    """Stam's walls in place: b = k negates the component normal to axis
    k-1 on that axis's faces, every other face copies; z faces last."""
    s = [-1.0 if b == a + 1 else 1.0 for a in range(3)]
    x[0], x[-1] = s[0] * x[1], s[0] * x[-2]
    x[:, 0], x[:, -1] = s[1] * x[:, 1], s[1] * x[:, -2]
    x[:, :, 0], x[:, :, -1] = s[2] * x[:, :, 1], s[2] * x[:, :, -2]
    return x


def _neighbours(x):
    return (x[:-2, 1:-1, 1:-1] + x[2:, 1:-1, 1:-1]
            + x[1:-1, :-2, 1:-1] + x[1:-1, 2:, 1:-1]
            + x[1:-1, 1:-1, :-2] + x[1:-1, 1:-1, 2:])


def lin_solve(b, x, x0, a, c, iters, red_black=False):
    """Jacobi sweeps, or red-black iterations (parity 0 of the 0-based
    interior index sum first), of (x0 + a * neighbours) / c, each sweep
    or half-sweep followed by set_bnd(b).  ``x`` None: zero guess."""
    c_inv = 1.0 / c
    x = torch.zeros_like(x0) if x is None else x.clone()
    if red_black:
        i = torch.arange(x.shape[0] - 2, device=x.device)
        red = (i[:, None, None] + i[None, :, None] + i[None, None, :]) % 2 == 0
    for _ in range(iters):
        if not red_black:
            x[_I] = (x0[_I] + a * _neighbours(x)) * c_inv
            set_bnd(b, x)
            continue
        for m in (red, ~red):
            x[_I] = torch.where(m, (x0[_I] + a * _neighbours(x)) * c_inv,
                                x[_I])
            set_bnd(b, x)
    return x


def diffuse(b, x, cfg, coeff):
    n = x.shape[0] - 2
    a = cfg["dt"] * coeff * n * n
    return lin_solve(b, x, x, a, 1 + 6 * a, cfg["jacobi_iters"])


def _dct_tables(n, device):
    """(forward DCT-II matrix, its inverse, per-axis eigenvalues of the
    Neumann Laplacian), in float64 and then rounded to float32."""
    i = torch.arange(n, dtype=torch.float64)
    fwd = torch.cos(math.pi / n * i[:, None] * (i[None, :] + 0.5))
    inv = fwd.T * (torch.where(i == 0, 1.0, 2.0) / n)
    lam = 2.0 - 2.0 * torch.cos(math.pi * i / n)
    return tuple(t.to(torch.float32).contiguous().to(device)
                 for t in (fwd, inv, lam))


def _along(a, m, ax):
    return torch.tensordot(m, a, dims=([1], [ax])).movedim(0, ax)


def dct_solve(div):
    """Exact solve of 6 p - neighbours(p) = div with mirror ghosts, the
    constant mode set to 0; the result has b = 0 ghosts."""
    xi = div[_I]
    n = xi.shape[0]
    fwd, inv, lam1 = _dct_tables(n, div.device)
    for ax in range(3):
        xi = _along(xi, fwd, ax)
    lam = lam1[:, None, None] + lam1[None, :, None] + lam1[None, None, :]
    coef = xi / torch.where(lam == 0.0, 1.0, lam)
    coef[0, 0, 0] = 0.0
    for ax in range(3):
        coef = _along(coef, inv, ax)
    p = torch.zeros_like(div)
    p[_I] = coef
    return set_bnd(0, p)


def _diff(q, axis, h):
    hi, lo = [slice(1, -1)] * 3, [slice(1, -1)] * 3
    hi[axis], lo[axis] = slice(2, None), slice(0, -2)
    return 0.5 * (q[tuple(hi)] - q[tuple(lo)]) / h


def project(u, v, w, cfg, solve):
    """(u, v, w) less the pressure gradient, the residual max|div +
    neighbours(p) - 6 p| and max|div| of the system solved."""
    h = 1.0 / (u.shape[0] - 2)
    div = torch.zeros_like(u)
    div[_I] = -0.5 * h * (u[2:, 1:-1, 1:-1] - u[:-2, 1:-1, 1:-1]
                          + v[1:-1, 2:, 1:-1] - v[1:-1, :-2, 1:-1]
                          + w[1:-1, 1:-1, 2:] - w[1:-1, 1:-1, :-2])
    set_bnd(0, div)
    if solve == "dct":
        p = dct_solve(div)
    else:
        p = lin_solve(0, None, div, 1.0, 6.0, cfg["jacobi_iters"],
                      red_black=cfg["red_black"])
    out = []
    for axis, (b, q) in enumerate(((1, u), (2, v), (3, w))):
        q = q.clone()
        q[_I] = q[_I] - _diff(p, axis, h)
        out.append(set_bnd(b, q))
    res = torch.max(torch.abs(div[_I] + _neighbours(p) - 6.0 * p[_I]))
    return (*out, res, torch.max(torch.abs(div[_I])))


def advect(fields, bnds, u, v, w, dt0):
    """27-tap stencil semi-Lagrangian advection: the backtrace -dt0 vel
    clamped to one cell and to [0.5, n + 0.5]; tap d weighs
    prod_a max(0, 1 - |off_a - d_a|)."""
    n = u.shape[0] - 2
    hats = []
    for a, vel in enumerate((u, v, w)):
        idx = (torch.arange(n, dtype=torch.float32, device=u.device) + 1.0
               ).reshape([-1 if k == a else 1 for k in range(3)])
        off = torch.clamp(-dt0 * vel[_I], -1.0, 1.0)
        off = torch.clamp(off, 0.5 - idx, n + 0.5 - idx)
        hats.append([torch.clamp(1.0 - torch.abs(off - d), min=0.0)
                     for d in (-1, 0, 1)])
    outs = [torch.zeros((n,) * 3, dtype=torch.float32, device=u.device)
            for _ in fields]
    for d in _SHIFTS:
        wgt = hats[0][d[0] + 1] * hats[1][d[1] + 1] * hats[2][d[2] + 1]
        sl = tuple(slice(1 + k, 1 + k + n) for k in d)
        for out, q in zip(outs, fields):
            out += wgt * q[sl]
    res = []
    for out, q, b in zip(outs, fields, bnds):
        q = q.clone()
        q[_I] = out
        res.append(set_bnd(b, q))
    return res


def forcing(u, v, w, dens, temp, cfg):
    """Buoyancy on w, then vorticity confinement of (u, v, w)."""
    if cfg["buoyancy_alpha"] or cfg["buoyancy_beta"]:
        w = w.clone()
        w[_I] += cfg["dt"] * (-cfg["buoyancy_alpha"] * dens[_I]
                              + cfg["buoyancy_beta"]
                              * (temp[_I] - cfg["ambient_temp"]))
        set_bnd(3, w)
    if not cfg["vorticity_eps"]:
        return u, v, w
    h = 1.0 / (u.shape[0] - 2)
    wx = _diff(w, 1, h) - _diff(v, 2, h)
    wy = _diff(u, 2, h) - _diff(w, 0, h)
    wz = _diff(v, 0, h) - _diff(u, 1, h)
    mag = torch.zeros_like(u)
    mag[_I] = torch.sqrt(wx * wx + wy * wy + wz * wz)
    gx, gy, gz = _diff(mag, 0, h), _diff(mag, 1, h), _diff(mag, 2, h)
    norm = torch.sqrt(gx * gx + gy * gy + gz * gz) + 1e-5
    gx, gy, gz = gx / norm, gy / norm, gz / norm
    eps_h = cfg["vorticity_eps"] * h
    out = []
    for b, q, f in ((1, u, gy * wz - gz * wy), (2, v, gz * wx - gx * wz),
                    (3, w, gx * wy - gy * wx)):
        q = q.clone()
        q[_I] += cfg["dt"] * (eps_h * f)
        out.append(set_bnd(b, q))
    return tuple(out)


def step(state, cfg, solve):
    """One step; returns (state, residual, max|div|) of its final
    projection.  ``state`` is a dict of the five fields."""
    u, v, w = state["u"], state["v"], state["w"]
    dens, temp = state["dens"], state["temp"]
    u, v, w = forcing(u, v, w, dens, temp, cfg)
    if cfg["visc"]:
        u, v, w = (diffuse(b, q, cfg, cfg["visc"])
                   for b, q in ((1, u), (2, v), (3, w)))
    u, v, w, _, _ = project(u, v, w, cfg, solve)
    dt0 = cfg["dt"] * (u.shape[0] - 2)
    u, v, w = advect((u, v, w), (1, 2, 3), u, v, w, dt0)
    u, v, w, res, div = project(u, v, w, cfg, solve)
    if cfg["diff"]:
        dens = diffuse(0, dens, cfg, cfg["diff"])
    if cfg["temp_diff"]:
        temp = diffuse(0, temp, cfg, cfg["temp_diff"])
    dens, temp = advect((dens, temp), (0, 0), u, v, w, dt0)
    return dict(u=u, v=v, w=w, dens=dens, temp=temp), res, div


def run(state, cfg, n_steps):
    """``n_steps`` steps in float32 with TF32 off; returns (state,
    residual and max|div| of the last step's final projection, as
    floats).  ``cfg`` holds the grid keywords of a configuration and its
    traffic; the projection is the DCT solve for ``projection`` "dct",
    else ``jacobi_iters`` Jacobi or red-black sweeps."""
    solve = "dct" if cfg["projection"] == "dct" else "sweeps"
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.no_grad():
            for _ in range(n_steps):
                state, res, div = step(state, cfg, solve)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])
    return state, float(res), float(div)
