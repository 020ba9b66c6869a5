"""Per-particle update of the base variant: ``tpufluids.integrate`` in
PyTorch.  Explicit Euler with the static-friction hack
(FluidGPU.cuh:270-304), with the reference's quirks kept and named in
the config: the density normalization ``(sum + W(0))/23 + 9250``, the
0.003 friction threshold and the 150/rho acceleration prefactor."""

from __future__ import annotations

import torch

from tpufluids_torch.config import SPHConfig
from tpufluids_torch.forces import ForceAccum
from tpufluids_torch.kernels import w0
from tpufluids_torch.state import ParticleState


def eos_pressure(dens, solid, cfg: SPHConfig):
    """Tait EOS (FluidGPU.cuh:256-260; FluidGPU-unidyn.cuh:282-286)."""
    base = (cfg.eos_stiffness * cfg.rho0 / cfg.eos_gamma
            * ((dens / cfg.rho0) ** cfg.eos_gamma - 1.0))
    if cfg.variant == "base":
        return base
    sand = (cfg.eos_stiffness * cfg.rho0_sand / cfg.eos_gamma
            * ((dens / cfg.rho0) ** cfg.eos_gamma - 1.0))
    return (1.0 - solid) * base + solid * sand


def normalize_density(sum_w, boundary, cfg: SPHConfig):
    """dens = (sum + W(0)) / 23 * (1 + bnd*BDENSFACTOR) + 9250
    (FluidGPU.cuh:165-167)."""
    return ((sum_w + w0(cfg.cutoff)) / cfg.dens_norm_div
            * (1.0 + boundary * cfg.bdensfactor) + cfg.dens_norm_offset)


def update(state: ParticleState, acc: ForceAccum,
           cfg: SPHConfig) -> ParticleState:
    """The base branch of ``tpufluids.integrate.update``.  The base force
    pass has no diffusion or stress rate, so both become 0 where alive,
    as the JAX package's zero accumulators make them."""
    if cfg.variant != "base":
        raise NotImplementedError(
            "the unidyn update is not ported to tpufluids_torch yet "
            "(ROADMAP.md Queue 1 item 4)")
    bnd = state.boundary
    alive = state.alive
    mob = ((~bnd) & alive)[:, None]
    dt = cfg.dt

    dens = normalize_density(acc.sum_w, bnd, cfg)
    press = eos_pressure(dens, state.solid, cfg)
    delpress = acc.dpress

    pos = torch.where(mob, state.pos + dt * state.vel
                      + cfg.diff * state.diffusion, state.pos)
    vp = state.vel + dt * state.acc
    eps = cfg.friction_eps
    vx = vp[:, 0] - (vp[:, 0] > 0) * eps + (vp[:, 0] < 0) * eps
    vx = vx * (torch.abs(vx) > eps)
    vy = vp[:, 1] - (vp[:, 1] > 0) * eps + (vp[:, 1] < 0) * eps
    vy = vy * (torch.abs(vy) > eps)
    vz = vp[:, 2] * (torch.abs(vp[:, 2]) > eps)
    new_vel = torch.stack([vx, vy, vz], dim=1)
    new_acc = -(cfg.accel_prefactor / dens)[:, None] * delpress
    new_acc[:, 2] += cfg.gravity

    alive1 = alive[:, None]
    return state.replace(
        pos=pos,
        vel=torch.where(mob, new_vel, state.vel),
        acc=torch.where(mob, new_acc, state.acc),
        dens=torch.where(alive, dens, state.dens),
        press=torch.where(alive, press, state.press),
        delpress=torch.where(alive1, delpress, state.delpress),
        diffusion=torch.where(alive1, 0.0, state.diffusion),
        stress=torch.where(alive[:, None, None], 0.0, state.stress),
    )
