"""MAC (staggered-grid) stable-fluids option in 3D, as
``tpufluids.grid.mac``.

Velocity components live on cell faces: ``u`` (n+1, n, n), ``v``
(n, n+1, n), ``w`` (n, n, n+1), without ghost layers; ``dens`` and
``temp`` are (n, n, n) cell arrays.  The discrete divergence (forward
face differences) and gradient are exact adjoints, so the projection
drives the divergence down to the linear solver's tolerance.  Walls are
no-flux (the normal velocity is pinned to 0 on the domain faces) and
free-slip.

The pressure is solved on a ghosted (n+2)^3 array through the collocated
solver's machinery (``stam._lin_solve3d``, ``stam.mg_solve3d``,
``stam.dct_solve3d``), so a Jacobi projection at 64^3 is one whole-solve
launch on the card, in float32 or bfloat16 by ``cfg.solver_dtype``.  The
face-space advection and the averaging are torch ops, as they are XLA
ops in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tpufluids_torch.grid import stam


@dataclasses.dataclass
class MacState3D:
    u: torch.Tensor      # (n+1, n, n) x-velocity on x-faces
    v: torch.Tensor      # (n, n+1, n)
    w: torch.Tensor      # (n, n, n+1)
    dens: torch.Tensor   # (n, n, n) cell-centered
    temp: torch.Tensor


def make_mac3d(cfg: stam.StamConfig, device="cuda") -> MacState3D:
    n = cfg.n

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return MacState3D(
        u=zeros(n + 1, n, n), v=zeros(n, n + 1, n), w=zeros(n, n, n + 1),
        dens=zeros(n, n, n),
        temp=torch.full((n, n, n), cfg.ambient_temp, dtype=torch.float32,
                        device=device))


def _noflux(u, v, w):
    """Copies of u, v, w with the normal velocity on the six domain faces
    set to 0."""
    u, v, w = u.clone(), v.clone(), w.clone()
    u[0] = u[-1] = 0.0
    v[:, 0] = v[:, -1] = 0.0
    w[:, :, 0] = w[:, :, -1] = 0.0
    return u, v, w


def divergence(u, v, w, n):
    """The MAC divergence on cells: forward face differences times n
    (h = 1/n)."""
    return ((u[1:] - u[:-1]) + (v[:, 1:] - v[:, :-1])
            + (w[:, :, 1:] - w[:, :, :-1])) * float(n)


def _edge_pad(a, axis):
    """``a`` with its first and last planes along ``axis`` repeated once
    (numpy's mode="edge")."""
    first = a.narrow(axis, 0, 1)
    last = a.narrow(axis, a.shape[axis] - 1, 1)
    return torch.cat([first, a, last], dim=axis)


def _avg4(p, ax_a, ax_b):
    """0.25 (p[:-1, :-1] + p[:-1, 1:] + p[1:, :-1] + p[1:, 1:]) over the
    axes ``ax_a`` and ``ax_b`` (the terms in this order)."""
    def sl(a_lo, b_lo):
        idx = [slice(None)] * 3
        idx[ax_a] = slice(None, -1) if a_lo else slice(1, None)
        idx[ax_b] = slice(None, -1) if b_lo else slice(1, None)
        return p[tuple(idx)]

    return 0.25 * (sl(True, True) + sl(True, False) + sl(False, True)
                   + sl(False, False))


def _avg_to_u(v, w):
    """v and w averaged to the u-face positions, with edge clamping."""
    vp = _edge_pad(v, 0)
    wp = _edge_pad(w, 0)
    return _avg4(vp, 0, 1), _avg4(wp, 0, 2)


def _avg_to_v(u, w):
    up = _edge_pad(u, 1)
    u_v = 0.25 * (up[:-1, :-1] + up[1:, :-1] + up[:-1, 1:] + up[1:, 1:])
    wp = _edge_pad(w, 1)
    return u_v, _avg4(wp, 1, 2)


def _avg_to_w(u, v):
    up = _edge_pad(u, 2)
    u_w = 0.25 * (up[:-1, :, :-1] + up[1:, :, :-1]
                  + up[:-1, :, 1:] + up[1:, :, 1:])
    vp = _edge_pad(v, 2)
    v_w = 0.25 * (vp[:, :-1, :-1] + vp[:, 1:, :-1]
                  + vp[:, :-1, 1:] + vp[:, 1:, 1:])
    return u_w, v_w


def _avg_to_cell(u, v, w):
    return (0.5 * (u[1:] + u[:-1]), 0.5 * (v[:, 1:] + v[:, :-1]),
            0.5 * (w[:, :, 1:] + w[:, :, :-1]))


def _shift(a, d, axis):
    """``a`` moved by d in {-1, 0, 1} cells along ``axis``, the vacated
    plane repeated from the edge: out[i] = a[clamp(i + d)]."""
    if d == 0:
        return a
    n = a.shape[axis]
    if d > 0:
        return torch.cat([a.narrow(axis, 1, n - 1),
                          a.narrow(axis, n - 1, 1)], dim=axis)
    return torch.cat([a.narrow(axis, 0, 1), a.narrow(axis, 0, n - 1)],
                     dim=axis)


def _advect_stencil(q, ou, ov, ow, dt0: float):
    """CFL-clamped 27-tap trilinear semi-Lagrangian advection of ``q`` in
    its own index space; ``ou``, ``ov``, ``ow`` are the advecting
    velocity sampled at q's positions.  Backtraces are clamped to one
    cell and to the array's extent; the taps are summed in the
    reference's order."""
    def offs(vel, axis):
        extent = q.shape[axis]
        coord = torch.arange(extent, dtype=torch.float32, device=q.device)
        coord = coord.reshape([-1 if a == axis else 1 for a in range(3)])
        o = torch.clamp(-dt0 * vel, -1.0, 1.0)
        return torch.clamp(o, -coord, extent - 1.0 - coord)

    ox, oy, oz = offs(ou, 0), offs(ov, 1), offs(ow, 2)

    def hat(o, d):
        return torch.clamp(1.0 - torch.abs(o - d), min=0.0)

    out = torch.zeros_like(q)
    for dx in (-1, 0, 1):
        wx = hat(ox, dx)
        qx = _shift(q, dx, 0)
        for dy in (-1, 0, 1):
            wxy = wx * hat(oy, dy)
            qxy = _shift(qx, dy, 1)
            for dz in (-1, 0, 1):
                out = out + wxy * hat(oz, dz) * _shift(qxy, dz, 2)
    return out


def project(u, v, w, cfg: stam.StamConfig, with_residual: bool = False):
    """The MAC pressure projection: div and p on a ghosted (n+2)^3 array,
    set_bnd(0) the Neumann condition of no-flux walls, the solve by
    ``cfg.projection`` through the collocated solver's dispatch, the
    gradient subtracted on interior faces.  ``with_residual`` also
    returns max |divergence| after the projection."""
    n = cfg.n
    h = 1.0 / n
    div = torch.zeros((n + 2,) * 3, dtype=torch.float32, device=u.device)
    div[stam._I] = -h * h * divergence(u, v, w, n)
    div = stam._set_bnd3d_(0, div)
    if cfg.projection == "multigrid":
        p = stam.mg_solve3d(div, cfg)
    elif cfg.projection == "dct":
        p = stam.dct_solve3d(div, cfg)
    else:
        p = stam._lin_solve3d(0, None, div, 1.0, 6.0, cfg.jacobi_iters,
                              red_black=cfg.red_black,
                              dtype=cfg.solver_dtype)
    pi = p[stam._I]
    # h cancels: p is solved in units of h^2 div
    u, v, w = u.clone(), v.clone(), w.clone()
    u[1:-1] += -(pi[1:] - pi[:-1]) * n
    v[:, 1:-1] += -(pi[:, 1:] - pi[:, :-1]) * n
    w[:, :, 1:-1] += -(pi[:, :, 1:] - pi[:, :, :-1]) * n
    u, v, w = _noflux(u, v, w)
    if with_residual:
        return u, v, w, torch.max(torch.abs(divergence(u, v, w, n)))
    return u, v, w


def step3d(state: MacState3D, cfg: stam.StamConfig,
           sources: Optional[dict] = None, with_residual: bool = False):
    """One MAC step: sources ("dens" and "temp", added times dt),
    buoyancy on the interior w-faces, projection, face-space advection,
    projection, scalar advection; the reference's order."""
    u, v, w, dens, temp = state.u, state.v, state.w, state.dens, state.temp
    n = cfg.n
    if sources:
        dens = dens + cfg.dt * sources.get("dens", 0.0)
        temp = temp + cfg.dt * sources.get("temp", 0.0)
    if cfg.buoyancy_alpha or cfg.buoyancy_beta:
        f = (-cfg.buoyancy_alpha * dens
             + cfg.buoyancy_beta * (temp - cfg.ambient_temp))
        # the cell force averaged to the interior w-faces
        w = w.clone()
        w[:, :, 1:-1] += cfg.dt * 0.5 * (f[:, :, 1:] + f[:, :, :-1])
    u, v, w = _noflux(u, v, w)
    u, v, w = project(u, v, w, cfg)

    dt0 = float(cfg.dt) * n
    v_u, w_u = _avg_to_u(v, w)
    u_v, w_v = _avg_to_v(u, w)
    u_w, v_w = _avg_to_w(u, v)
    u2 = _advect_stencil(u, u, v_u, w_u, dt0)
    v2 = _advect_stencil(v, u_v, v, w_v, dt0)
    w2 = _advect_stencil(w, u_w, v_w, w, dt0)
    u, v, w = _noflux(u2, v2, w2)
    if with_residual:
        u, v, w, res = project(u, v, w, cfg, with_residual=True)
    else:
        u, v, w = project(u, v, w, cfg)

    uc, vc, wc = _avg_to_cell(u, v, w)
    dens = _advect_stencil(dens, uc, vc, wc, dt0)
    temp = _advect_stencil(temp, uc, vc, wc, dt0)
    out = MacState3D(u=u, v=v, w=w, dens=dens, temp=temp)
    return (out, res) if with_residual else out


def run3d(state: MacState3D, cfg: stam.StamConfig, n_steps: int):
    """``n_steps`` steps, each reporting max |divergence| after its final
    projection; returns (state, residuals as an (n_steps,) tensor)."""
    return stam.run_each_residual(step3d, state, cfg, n_steps)


def run3d_python(state: MacState3D, cfg: stam.StamConfig, n_steps: int):
    """Run ``n_steps`` steps (at least one), queued on the device without
    a host sync; the residual (max |divergence|) of the final step only.
    Returns (state, residual as a (1,) tensor)."""
    return stam.run_last_residual(step3d, state, cfg, n_steps)
