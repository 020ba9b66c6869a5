"""The sharded 3D stable-fluids step: x-slab decomposition with halo
exchange over torch.distributed (BASELINE config 5: 512^3 over a mesh).
The port of ``tpufluids.shard.grid_sharded``.

Layout: the global field interior is (n, n+2, n+2), without the ghost
planes along the sharded x axis (they are materialized locally), with
ghost layers along y and z.  Each rank holds a slab of n / world rows
(``shard_state``).  Stencils read halo planes that the ranks exchange
before every application (``Mesh.shift``), the communication pattern of
the reference's one-plane halo buffer (``buffer = GRIDSIZE^2``,
solver-unidyn.cu:187).

Two steps, by ``make_sharded_step``'s backend:

- "plain" (JAX's ``backend="xla"``): torch ops on a one-plane halo,
  ``_step_local``.  Its advection is gather advection with backtraces
  clamped to one halo plane across a slab boundary, whatever
  ``advect_mode`` says, as the reference's (CFL <= 1 cell in x across
  ranks); it matches the dense stencil step only away from the domain
  edges.
- "kernels" (JAX's ``backend="pallas"``): the dense step's kernels on
  slabs kept padded with 2 rows a side, ``_step_local_kernels``: the
  slab modes of forcing3d, div3d, gradsub3d and advect3d_multi, and the
  sharded red-black solve lin_solve3d_rb_shard, which exchanges its
  deep halo once every ``fuse`` iterations.  Its per-cell arithmetic is
  the dense step's, so on set_bnd-consistent inputs the collected slabs
  equal the dense stam.step3d bit for bit (the DCT projection, whose
  x transform is a partial matrix product summed over the ranks, within
  rounding).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpufluids_torch.grid import kernels
from tpufluids_torch.grid import stam
from tpufluids_torch.grid.stam import GridState3D, StamConfig
from tpufluids_torch.shard.mesh import Mesh

FIELDS = ("u", "v", "w", "dens", "temp")
BNDS = (1, 2, 3, 0, 0)
BACKENDS = ("auto", "kernels", "plain")


# ---------------------------------------------------------------------------
# layout (dense single-process <-> sharded)


def to_sharded_layout(state: GridState3D) -> GridState3D:
    """Strip the x ghost planes: (n+2, n+2, n+2) -> (n, n+2, n+2)."""
    return GridState3D(*(getattr(state, f)[1:-1] for f in FIELDS))


def from_sharded_layout(state: GridState3D) -> GridState3D:
    """Re-attach the x ghost planes by set_bnd3d."""
    return GridState3D(*(stam.set_bnd3d(b, F.pad(getattr(state, f),
                                                 (0, 0, 0, 0, 1, 1)))
                         for f, b in zip(FIELDS, BNDS)))


def shard_state(state: GridState3D, mesh: Mesh) -> GridState3D:
    """This rank's slab, on the mesh's device, of a state in the sharded
    layout (every rank holds the same global state)."""
    n = state.u.shape[0]
    if n % mesh.size:
        raise ValueError(f"n={n} must divide over {mesh.size} ranks")
    c = n // mesh.size
    rows = slice(mesh.rank * c, (mesh.rank + 1) * c)
    return GridState3D(*(getattr(state, f)[rows].to(mesh.device).contiguous()
                         for f in FIELDS))


def collect(state: GridState3D, mesh: Mesh):
    """The global state in the sharded layout on rank 0, gathered from
    every rank's slab; None on the other ranks."""
    parts = [mesh.gather(getattr(state, f)) for f in FIELDS]
    if parts[0] is None:
        return None
    return GridState3D(*(torch.cat(p) for p in parts))


# ---------------------------------------------------------------------------
# slab primitives


def _sx(b):
    return -1.0 if b == 1 else 1.0


def _set_bnd_yz(b, x):
    """The y and z faces of set_bnd3d on a local slab (the x faces live in
    the halo)."""
    return kernels._set_bnd_yz_(b, x.clone())


def _halo_exchange(a, sx, mesh: Mesh):
    """Pad the slab (c, Y, Z) to (c+2, Y, Z) with the neighbours' planes;
    at a domain face the set_bnd x-face value (scale sx)."""
    from_left = mesh.shift(a[-1:], +1)     # the left neighbour's last
    from_right = mesh.shift(a[:1], -1)     # the right neighbour's first
    lo = sx * a[:1] if mesh.rank == 0 else from_left
    hi = sx * a[-1:] if mesh.rank == mesh.size - 1 else from_right
    return torch.cat([lo, a, hi])


def _halo(b, a, mesh: Mesh):
    """set_bnd and the halo pad: (c+2, Y, Z), ready for a stencil."""
    return _halo_exchange(_set_bnd_yz(b, a), _sx(b), mesh)


def _lin_solve_local(b, x, x0, a, c, iters, mesh: Mesh, red_black=False):
    c_inv = 1.0 / c

    def jacobi(x):
        xp = _halo(b, x, mesh)
        nb = (xp[:-2, 1:-1, 1:-1] + xp[2:, 1:-1, 1:-1]
              + xp[1:-1, :-2, 1:-1] + xp[1:-1, 2:, 1:-1]
              + xp[1:-1, 1:-1, :-2] + xp[1:-1, 1:-1, 2:])
        x = x.clone()
        x[:, 1:-1, 1:-1] = (x0[:, 1:-1, 1:-1] + a * nb) * c_inv
        return x

    if not red_black:
        for _ in range(iters):
            x = kernels._set_bnd_yz_(b, jacobi(x))
        return x
    # red-black parity in global x coordinates, 0-based interior indices
    # as the dense _checker
    c, n = x.shape[0], x.shape[1] - 2
    i = torch.arange(c, device=x.device) + mesh.rank * c
    jk = torch.arange(n, device=x.device)
    mask0 = (i[:, None, None] + jk[None, :, None] + jk[None, None, :]) \
        % 2 == 0
    for _ in range(iters):
        for m in (mask0, ~mask0):
            new = jacobi(x)
            x = x.clone()
            x[:, 1:-1, 1:-1] = torch.where(m, new[:, 1:-1, 1:-1],
                                           x[:, 1:-1, 1:-1])
            kernels._set_bnd_yz_(b, x)
    return x


def _advect_local(b, q, u, v, w, cfg: StamConfig, mesh: Mesh):
    """Semi-Lagrangian gather advection on a slab; backtraces clamp to the
    one-plane halo across a slab boundary (the reference's XLA slab step
    uses this formulation whatever ``advect_mode`` says)."""
    c, n = q.shape[0], q.shape[1] - 2
    dt0 = cfg.dt * n
    gx0 = mesh.rank * c                    # global x of local row 0
    qp = _halo(b, q, mesh)                 # local row i -> qp row i + 1
    dev = q.device
    ii = torch.arange(c, dtype=torch.float32, device=dev).reshape(-1, 1, 1)
    jj = stam._axis_index(n, 1, 3, dev)
    kk = stam._axis_index(n, 2, 3, dev)
    gi = ii + float(gx0) + 1.0             # global x coordinate
    x = torch.clamp(gi - dt0 * u[:, 1:-1, 1:-1], 0.5, n + 0.5)
    y = torch.clamp(jj - dt0 * v[:, 1:-1, 1:-1], 0.5, n + 0.5)
    z = torch.clamp(kk - dt0 * w[:, 1:-1, 1:-1], 0.5, n + 0.5)
    # local coordinate in qp (row r = global row gx0 + r): backtraces of
    # up to one cell across the boundary are exact, longer ones clamp
    lx = torch.clamp(x - gx0, 0.0, c + 1.0)
    i0 = torch.clamp(torch.floor(lx).to(torch.int64), 0, c)
    j0 = torch.floor(y).to(torch.int64)
    k0 = torch.floor(z).to(torch.int64)
    s1, t1, r1 = lx - i0, y - j0, z - k0
    s0, t0, r0 = 1 - s1, 1 - t1, 1 - r1

    def g(di, dj, dk):
        return qp[torch.clamp(i0 + di, 0, c + 1), j0 + dj, k0 + dk]

    out = (s0 * (t0 * (r0 * g(0, 0, 0) + r1 * g(0, 0, 1))
                 + t1 * (r0 * g(0, 1, 0) + r1 * g(0, 1, 1)))
           + s1 * (t0 * (r0 * g(1, 0, 0) + r1 * g(1, 0, 1))
                   + t1 * (r0 * g(1, 1, 0) + r1 * g(1, 1, 1))))
    q = q.clone()
    q[:, 1:-1, 1:-1] = out
    return kernels._set_bnd_yz_(b, q)


def _xmul(a, m, mesh: Mesh):
    """The x transform of a slab: this rank's columns of ``m`` times its
    rows of ``a``, summed over the ranks, this rank's rows kept."""
    c = a.shape[0]
    off = mesh.rank * c
    part = torch.tensordot(m[:, off:off + c], a, dims=([1], [0]))
    return mesh.reduce_scatter(part)


def _gauge_(coef, mesh: Mesh):
    """Zero the global (0, 0, 0) gauge mode, on rank 0's slab."""
    if mesh.rank == 0:
        coef[0, 0, 0] = 0.0
    return coef


def _dct_solve_local(x0, mesh: Mesh, cfg=None, final=True):
    """The spectral projection solve over x-slabs: y and z transforms
    are local products, the x transform a partial product per rank and
    one reduce-scatter each way."""
    prec = stam._dct_params(cfg, final)[0]
    c, n = x0.shape[0], x0.shape[1] - 2
    C, Ci, lam1 = stam._dct_mats(n, x0.device)
    off = mesh.rank * c
    with stam._matmul_precision(prec, x0.device):
        f = _xmul(x0[:, 1:-1, 1:-1], C, mesh)
        f = stam._dct_axis(stam._dct_axis(f, C, 1), C, 2)
        lam = (lam1[off:off + c, None, None] + lam1[None, :, None]
               + lam1[None, None, :])
        coef = _gauge_(f / torch.where(lam == 0.0, 1.0, lam), mesh)
        sol = _xmul(coef, Ci, mesh)
        sol = stam._dct_axis(stam._dct_axis(sol, Ci, 1), Ci, 2)
    p = torch.zeros_like(x0)
    p[:, 1:-1, 1:-1] = sol
    return kernels._set_bnd_yz_(0, p)


def _divergence_local(u, v, w, mesh: Mesh):
    h = 1.0 / (u.shape[1] - 2)
    up = _halo(1, u, mesh)
    return -0.5 * h * (
        up[2:, 1:-1, 1:-1] - up[:-2, 1:-1, 1:-1]
        + v[:, 2:, 1:-1] - v[:, :-2, 1:-1]
        + w[:, 1:-1, 2:] - w[:, 1:-1, :-2])


def _project_local(u, v, w, cfg: StamConfig, mesh: Mesh, with_residual=True,
                   final=True):
    h = 1.0 / (u.shape[1] - 2)
    div = torch.zeros_like(u)
    div[:, 1:-1, 1:-1] = _divergence_local(u, v, w, mesh)
    kernels._set_bnd_yz_(0, div)
    if cfg.projection == "dct":
        p = _dct_solve_local(div, mesh, cfg, final)
    else:
        p = _lin_solve_local(0, torch.zeros_like(u), div, 1.0, 6.0,
                             cfg.jacobi_iters, mesh, red_black=cfg.red_black)
    pp = _halo(0, p, mesh)
    u, v, w = u.clone(), v.clone(), w.clone()
    u[:, 1:-1, 1:-1] += -0.5 * (pp[2:, 1:-1, 1:-1] - pp[:-2, 1:-1, 1:-1]) / h
    v[:, 1:-1, 1:-1] += -0.5 * (p[:, 2:, 1:-1] - p[:, :-2, 1:-1]) / h
    w[:, 1:-1, 1:-1] += -0.5 * (p[:, 1:-1, 2:] - p[:, 1:-1, :-2]) / h
    u, v, w = (kernels._set_bnd_yz_(b, q) for b, q in ((1, u), (2, v),
                                                        (3, w)))
    if not with_residual:
        return u, v, w, None
    # the Poisson residual (global max), reusing the halo'd p
    nb = (pp[:-2, 1:-1, 1:-1] + pp[2:, 1:-1, 1:-1]
          + pp[1:-1, :-2, 1:-1] + pp[1:-1, 2:, 1:-1]
          + pp[1:-1, 1:-1, :-2] + pp[1:-1, 1:-1, 2:])
    res = torch.max(torch.abs(div[:, 1:-1, 1:-1] + nb
                              - 6.0 * p[:, 1:-1, 1:-1]))
    return u, v, w, mesh.max(res)


def _vorticity_local(u, v, w, cfg: StamConfig, mesh: Mesh):
    """stam.vorticity_confinement3d on the halo-padded slab.  The x
    ghosts come from the neighbours' or face values without re-running
    set_bnd (the sx-scaled face value is what the dense step's last
    set_bnd3d left)."""
    h = 1.0 / (u.shape[1] - 2)
    up = _halo_exchange(u, -1.0, mesh)
    vp = _halo_exchange(v, 1.0, mesh)
    wp = _halo_exchange(w, 1.0, mesh)

    def dx(q):
        return 0.5 * (q[2:, 1:-1, 1:-1] - q[:-2, 1:-1, 1:-1]) / h

    def dy(q):
        return 0.5 * (q[1:-1, 2:, 1:-1] - q[1:-1, :-2, 1:-1]) / h

    def dz(q):
        return 0.5 * (q[1:-1, 1:-1, 2:] - q[1:-1, 1:-1, :-2]) / h

    wx = dy(wp) - dz(vp)
    wy = dz(up) - dx(wp)
    wz = dx(vp) - dy(up)
    # the dense step keeps |curl|'s ghost shell at 0
    mag = torch.zeros_like(u)
    mag[:, 1:-1, 1:-1] = torch.sqrt(wx * wx + wy * wy + wz * wz)
    magp = _halo_exchange(mag, 0.0, mesh)
    gx, gy, gz = dx(magp), dy(magp), dz(magp)
    norm = torch.sqrt(gx * gx + gy * gy + gz * gz) + 1e-5
    gx, gy, gz = gx / norm, gy / norm, gz / norm
    eps_h = cfg.vorticity_eps * h
    out = []
    for b, q, f in ((1, u, gy * wz - gz * wy), (2, v, gz * wx - gx * wz),
                    (3, w, gx * wy - gy * wx)):
        q = q.clone()
        q[:, 1:-1, 1:-1] += cfg.dt * eps_h * f
        out.append(kernels._set_bnd_yz_(b, q))
    return tuple(out)


def _step_local(u, v, w, dens, temp, cfg: StamConfig, mesh: Mesh,
                with_residual=True):
    """One step of the plain slab step (JAX's ``_step_local``)."""
    n = cfg.n
    if cfg.buoyancy_alpha or cfg.buoyancy_beta:
        f = (-cfg.buoyancy_alpha * dens[:, 1:-1, 1:-1]
             + cfg.buoyancy_beta * (temp[:, 1:-1, 1:-1] - cfg.ambient_temp))
        w = w.clone()
        w[:, 1:-1, 1:-1] += cfg.dt * f
        kernels._set_bnd_yz_(3, w)
    if cfg.vorticity_eps:
        u, v, w = _vorticity_local(u, v, w, cfg, mesh)
    if cfg.visc:
        a = cfg.dt * cfg.visc * n * n
        u = _lin_solve_local(1, u, u, a, 1 + 6 * a, cfg.jacobi_iters, mesh)
        v = _lin_solve_local(2, v, v, a, 1 + 6 * a, cfg.jacobi_iters, mesh)
        w = _lin_solve_local(3, w, w, a, 1 + 6 * a, cfg.jacobi_iters, mesh)
    u, v, w, _ = _project_local(u, v, w, cfg, mesh, with_residual=False,
                                final=False)
    u0, v0, w0 = u, v, w
    u = _advect_local(1, u0, u0, v0, w0, cfg, mesh)
    v = _advect_local(2, v0, u0, v0, w0, cfg, mesh)
    w = _advect_local(3, w0, u0, v0, w0, cfg, mesh)
    u, v, w, res = _project_local(u, v, w, cfg, mesh,
                                  with_residual=with_residual)
    if cfg.diff:
        a = cfg.dt * cfg.diff * n * n
        dens = _lin_solve_local(0, dens, dens, a, 1 + 6 * a,
                                cfg.jacobi_iters, mesh)
    dens = _advect_local(0, dens, u, v, w, cfg, mesh)
    if cfg.temp_diff:
        a = cfg.dt * cfg.temp_diff * n * n
        temp = _lin_solve_local(0, temp, temp, a, 1 + 6 * a,
                                cfg.jacobi_iters, mesh)
    temp = _advect_local(0, temp, u, v, w, cfg, mesh)
    return u, v, w, dens, temp, res


# ---------------------------------------------------------------------------
# the kernel step: the dense step's kernels on slabs kept padded with 2 rows
# a side (interior rows [2:-2]) between halo exchanges


def _refresh_pad_(q, halo, b, mesh: Mesh):
    """Rewrite, in place, the ``halo`` pad rows a side of a padded slab
    (c + 2 halo rows): the neighbours' ``halo`` adjacent owned rows, or
    at a domain face the set_bnd ghost row (sx times the edge row) next
    to the slab and zeros beyond it, which no kernel reads.  Kernels
    leave their pad rows stale; this re-validates them before a stencil
    reads them.  Every pad row in the grid is rewritten, as the
    red-black slab solve's ``exchange`` must (kernels.
    lin_solve3d_rb_shard).  Returns q."""
    c = q.shape[0] - 2 * halo
    from_left = mesh.shift(q[c:c + halo], +1)
    from_right = mesh.shift(q[halo:2 * halo], -1)
    sx = _sx(b)
    if mesh.rank == 0:
        q[:halo - 1] = 0.0
        q[halo - 1] = sx * q[halo]
    else:
        q[:halo] = from_left
    if mesh.rank == mesh.size - 1:
        q[halo + c] = sx * q[halo + c - 1]
        q[halo + c + 1:] = 0.0
    else:
        q[halo + c:] = from_right
    return q


def _refresh_halo(q, b, mesh: Mesh):
    """The 2-row pad of the kernel step's persistent layout, refreshed in
    place (JAX's ``_refresh_halo``)."""
    return _refresh_pad_(q, 2, b, mesh)


def _refresh_halo_multi(qs, bs, mesh: Mesh):
    """_refresh_halo over several same-shape fields with one message each
    way: the fields' 2-row edge slabs are concatenated, exchanged as one
    (2k, Y, Z) message, and split back.  Bit-equal to per-field
    refreshes."""
    if mesh.size == 1 or len(qs) == 1:
        return tuple(_refresh_halo(q, b, mesh) for q, b in zip(qs, bs))
    from_left = mesh.shift(torch.cat([q[-4:-2] for q in qs]), +1)
    from_right = mesh.shift(torch.cat([q[2:4] for q in qs]), -1)
    for i, (q, b) in enumerate(zip(qs, bs)):
        sx = _sx(b)
        if mesh.rank == 0:
            q[0] = 0.0
            q[1] = sx * q[2]
        else:
            q[:2] = from_left[2 * i:2 * i + 2]
        if mesh.rank == mesh.size - 1:
            q[-2] = sx * q[-3]
            q[-1] = 0.0
        else:
            q[-2:] = from_right[2 * i:2 * i + 2]
    return tuple(qs)


def _padded(q, halo):
    return F.pad(q, (0, 0, 0, 0, halo, halo))


def _rb_solve(b, x, x0, a, c, iters, mesh: Mesh, fuse):
    """The sharded red-black solve of slab ``x0`` (x: the initial guess,
    None for zeros) through kernels.lin_solve3d_rb_shard: x0's deep halo
    exchanged once, x's before every pass."""
    halo = 2 * fuse
    x0p = _refresh_pad_(_padded(x0, halo), halo, b, mesh)
    xp = None if x is None else _refresh_pad_(_padded(x, halo), halo, b,
                                              mesh)
    return kernels.lin_solve3d_rb_shard(
        b, xp, x0p, a, c, iters, gx0=mesh.rank * x0.shape[0] + 1 - halo,
        fuse=fuse, exchange=lambda q: _refresh_pad_(q, halo, b, mesh))


def _dct_solve_slab(dslab, mesh: Mesh, cfg: StamConfig, final=True):
    """The spectral solve of the kernel step (JAX's
    ``_dct_solve_local_zg`` on the ghosted slab): a world of 1 runs the
    dense interior solver, radix split included; otherwise the partial
    products and reduce-scatters of _dct_solve_local, with the radix
    split on the local y and z transforms only."""
    prec, radix_min, levels = stam._dct_params(cfg, final)
    xi = dslab[:, 1:-1, 1:-1]
    if mesh.size == 1:
        sol = stam._dct_solve_interior(xi, prec, radix_min, levels)
    else:
        c, n = xi.shape[0], xi.shape[1]
        C, Ci, lam1 = stam._dct_mats(n, xi.device)
        lamx = lam1[mesh.rank * c:(mesh.rank + 1) * c]
        with stam._matmul_precision(prec, xi.device):
            f = _xmul(xi, C, mesh)
            if bool(radix_min) and n >= radix_min and n % 2 == 0:
                pieces = stam._radix_fwd_axis([(f, [])], 1, levels)
                pieces = stam._radix_fwd_axis(pieces, 2, levels)
                solved = []
                for k, (a, lams) in enumerate(pieces):
                    lam = (lamx[:, None, None] + lams[0][None, :, None]
                           + lams[1][None, None, :])
                    if k == 0:
                        a = _gauge_(a / torch.where(lam == 0.0, 1.0, lam),
                                    mesh)
                    else:
                        a = a / lam
                    solved.append(a)
                pieces = stam._radix_inv_axis(solved, 2, levels)
                pieces = stam._radix_inv_axis(pieces, 1, levels)
                sol = _xmul(pieces[0], Ci, mesh)
            else:
                f = stam._dct_axis(stam._dct_axis(f, C, 1), C, 2)
                lam = (lamx[:, None, None] + lam1[None, :, None]
                       + lam1[None, None, :])
                coef = _gauge_(f / torch.where(lam == 0.0, 1.0, lam), mesh)
                sol = _xmul(coef, Ci, mesh)
                sol = stam._dct_axis(stam._dct_axis(sol, Ci, 1), Ci, 2)
    p = torch.zeros_like(dslab)
    p[:, 1:-1, 1:-1] = sol
    return kernels._set_bnd_yz_(0, p)


def _step_local_kernels(u, v, w, dens, temp, cfg: StamConfig, mesh: Mesh,
                        fuse, with_residual=True):
    """One slab step on persistently padded (c + 4, n+2, n+2) fields
    (owned rows [2:-2]) through the dense step's kernels placed at
    global row gx0 = rank c - 1 of padded row 0 (JAX's
    ``_step_local_pallas``).  Pad rows are refreshed in place before
    every stencil reads them."""
    c = u.shape[0] - 4
    n = cfg.n
    gx0 = mesh.rank * c - 1
    iters = cfg.jacobi_iters

    def solve_padded(b, q, coeff):
        a, cc = stam._diffusion_ac(cfg, coeff, n)
        s = q[2:-2]
        return _padded(_rb_solve(b, s, s, a, cc, iters, mesh, fuse), 2)

    if cfg.buoyancy_alpha or cfg.buoyancy_beta or cfg.vorticity_eps:
        _refresh_halo_multi((u, v, w, dens, temp), BNDS, mesh)
        u, v, w = kernels.forcing3d(u, v, w, dens, temp, cfg, gx0=gx0)
    if cfg.visc:
        u, v, w = (solve_padded(b, q, cfg.visc)
                   for b, q in ((1, u), (2, v), (3, w)))

    def project(u, v, w, with_residual=False, final=True):
        _refresh_halo_multi((u, v, w), (1, 2, 3), mesh)
        dslab = kernels.div3d(u, v, w, gx0=gx0)[2:-2]
        if cfg.projection == "dct":
            p = _dct_solve_slab(dslab, mesh, cfg, final)
        else:
            p = _rb_solve(0, None, dslab, 1.0, 6.0, iters, mesh, fuse)
        pp = _refresh_halo(_padded(p, 2), 0, mesh)
        u, v, w = kernels.gradsub3d(pp, u, v, w, gx0=gx0)
        if not with_residual:
            return u, v, w, None
        nb = (pp[1:-3, 1:-1, 1:-1] + pp[3:-1, 1:-1, 1:-1]
              + p[:, :-2, 1:-1] + p[:, 2:, 1:-1]
              + p[:, 1:-1, :-2] + p[:, 1:-1, 2:])
        res = torch.max(torch.abs(dslab[:, 1:-1, 1:-1] + nb
                                  - 6.0 * p[:, 1:-1, 1:-1]))
        return u, v, w, mesh.max(res)

    u, v, w, _ = project(u, v, w, final=False)
    _refresh_halo_multi((u, v, w), (1, 2, 3), mesh)
    u, v, w = kernels.advect3d_multi((u, v, w), (1, 2, 3), u, v, w,
                                     cfg.dt * n, gx0=gx0)
    u, v, w, res = project(u, v, w, with_residual=with_residual)
    if cfg.diff:
        dens = solve_padded(0, dens, cfg.diff)
    if cfg.temp_diff:
        temp = solve_padded(0, temp, cfg.temp_diff)
    _refresh_halo_multi((u, v, w, dens, temp), BNDS, mesh)
    dens, temp = kernels.advect3d_multi((dens, temp), (0, 0), u, v, w,
                                        cfg.dt * n, gx0=gx0)
    return u, v, w, dens, temp, res


def kernels_supported(cfg: StamConfig) -> bool:
    """True for the configurations the kernel step runs: the Jacobi or
    DCT projection, red-black (its solves go through the sharded
    red-black solver), stencil advection, the float32 solver, n+2 >= 16
    (JAX's ``_pallas_sharded_supported``)."""
    return (cfg.projection in ("jacobi", "dct") and cfg.red_black
            and cfg.advect_mode == "stencil"
            and cfg.solver_dtype == "float32" and cfg.n + 2 >= 16)


def make_sharded_step(mesh: Mesh, cfg: StamConfig, n_steps: int = 1,
                      backend: str = "auto"):
    """A function ``step(state) -> (state, residual)`` that runs
    ``n_steps`` 3D steps on this rank's slab (the sharded layout, (n /
    world, n+2, n+2) fields on the mesh's device) with the other ranks;
    the residual (a 0-d tensor, the maximum over the ranks) is the last
    step's, as stam.run3d_python's.

    ``backend``: "kernels" (JAX's "pallas") is the kernel step, "plain"
    (JAX's "xla") the plain slab step of torch ops; "auto" takes the
    kernel step on a mesh whose slabs live on a CUDA device when the
    configuration supports it (kernels_supported, an even slab), and the
    plain slab step otherwise, as JAX's "auto" takes Pallas on a TPU.
    On the CPU the kernel step runs the kernels' plain versions.  The
    choice is made here, by configuration, never after a failure."""
    world, n = mesh.size, cfg.n
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if n % world:
        raise ValueError(f"n={n} must divide over {world} ranks")
    if cfg.projection not in ("jacobi", "dct"):
        raise ValueError(f"sharded step supports projection in ('jacobi', "
                         f"'dct'), got {cfg.projection!r}")
    c_local = n // world
    # the deep halo needs at least 2 donatable rows per slab; even slabs,
    # as the reference's packed checkerboard needs
    slab_ok = c_local % 2 == 0 and c_local >= 2
    if backend == "kernels" and not (kernels_supported(cfg) and slab_ok):
        raise ValueError(
            "backend='kernels' needs projection in ('jacobi', 'dct'), "
            "red_black, advect_mode='stencil', float32 solver, n+2 >= 16, "
            f"and an even per-device slab (n/world = {c_local})")
    use_kernels = backend == "kernels" or (
        backend == "auto" and slab_ok and kernels_supported(cfg)
        and mesh.device.type == "cuda")
    fuse = kernels.rb_shard_plan(c_local, cfg.jacobi_iters) \
        if use_kernels else None
    shape = (c_local, n + 2, n + 2)

    def step(state: GridState3D):
        fields = [getattr(state, f) for f in FIELDS]
        for f, q in zip(FIELDS, fields):
            if tuple(q.shape) != shape or q.device != mesh.device:
                raise ValueError(f"{f}: expected a {shape} slab on "
                                 f"{mesh.device}, got {tuple(q.shape)} on "
                                 f"{q.device}")
        if use_kernels:
            fields = [_padded(q, 2) for q in fields]
        res = None
        for i in range(n_steps):
            last = i == n_steps - 1
            if use_kernels:
                *fields, res = _step_local_kernels(*fields, cfg, mesh, fuse,
                                                   with_residual=last)
            else:
                *fields, res = _step_local(*fields, cfg, mesh,
                                           with_residual=last)
        if use_kernels:
            fields = [q[2:-2].contiguous() for q in fields]
        return GridState3D(*fields), res

    step.backend = "kernels" if use_kernels else "plain"
    step.fuse = fuse
    return step
