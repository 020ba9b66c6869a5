"""Per-particle update: ``tpufluids.integrate`` in PyTorch.

* base variant: explicit Euler with the static-friction hack
  (FluidGPU.cuh:270-304);
* unidyn variant: volume-fraction transport and kick-drift-kick
  leapfrog with drag, floor recycling and reflective walls
  (FluidGPU-unidyn.cuh:296-423).

The reference's quirks are kept and named in the config: the density
normalization ``(sum + W(0))/23 + 9250``, the 0.003 friction threshold,
the 150 and (220 - 70 solid) acceleration prefactors, the sequential
fraction renormalization, and the y/z drag conditions that read the
already-updated x velocity."""

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
    """``tpufluids.integrate.update``.  The base force pass has no
    diffusion or stress rate, so both become 0 where alive, as the JAX
    package's zero accumulators make them."""
    if cfg.variant != "base":
        return _update_unidyn(state, acc, cfg)
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


def _update_unidyn(state: ParticleState, acc: ForceAccum,
                   cfg: SPHConfig) -> ParticleState:
    """The unidyn branch of ``tpufluids.integrate.update``, quirks kept."""
    bnd = state.boundary
    alive = state.alive
    mob = (~bnd) & alive
    dt = cfg.dt

    dens = normalize_density(acc.sum_w, bnd, cfg)
    press = eos_pressure(dens, state.solid, cfg)
    delpress = acc.dpress

    friction = torch.sum(torch.abs(acc.diffusion), dim=-1)
    solid = state.solid + dt * acc.delsolid
    solid = solid * (solid >= 0)
    # the floor is tested on fluid + delfluid, not on fluid + dt delfluid
    delfluid = torch.where(state.fluid + acc.delfluid < cfg.fluid_floor,
                           0.0, acc.delfluid)
    fluid = state.fluid + dt * delfluid
    fluid = fluid * (fluid >= 0)
    # sequential renormalization quirk (FluidGPU-unidyn.cuh:319-320)
    fluid = fluid / (fluid + solid)
    solid = solid / (fluid + solid)
    solid = torch.where(mob, solid, state.solid)
    fluid = torch.where(mob, fluid, state.fluid)

    pos = torch.where(mob[:, None],
                      state.pos + dt * state.vel + 0.5 * dt * dt * state.acc
                      + cfg.diff * acc.diffusion, state.pos)
    below = mob & (pos[:, 2] < cfg.floor_recycle_z)
    v0x = torch.where(below, 0.0, state.vel[:, 0])
    v0y = torch.where(below, 0.0, state.vel[:, 1])
    v0z = state.vel[:, 2]

    sa, ma = acc.stress_accel, acc.mixture_accel
    drag = friction * cfg.solid_drag * solid
    maw = cfg.mixture_accel_weight
    a0 = state.acc

    vx = v0x + 0.5 * dt * a0[:, 0] + dt * sa[:, 0] + maw * dt * dt * ma[:, 0]
    cond_x = v0x + dt * a0[:, 0] + dt * sa[:, 0] + dt * dt * ma[:, 0]
    vx = vx - (cond_x > 0) * drag + (cond_x < 0) * drag
    # quirk: the y/z drag conditions read the updated x velocity and the
    # x acceleration (FluidGPU-unidyn.cuh:352-353)
    vy = v0y + 0.5 * dt * a0[:, 1] + dt * sa[:, 1] + maw * dt * dt * ma[:, 1]
    cond_y = vx + dt * a0[:, 0] + dt * sa[:, 1] + dt * dt * ma[:, 1]
    vy = vy - (cond_y > 0) * drag + (cond_y < 0) * drag
    vz = v0z + 0.5 * dt * a0[:, 2] + dt * sa[:, 2] + maw * dt * dt * ma[:, 2]
    cond_z = vx + dt * a0[:, 0] + dt * sa[:, 2] + dt * dt * ma[:, 2]
    vz = vz - (cond_z > 0) * drag + (cond_z < 0) * drag

    pref = (cfg.accel_prefactor_unidyn
            - cfg.accel_prefactor_solid * solid) / dens
    nax = -pref * delpress[:, 0]
    nay = -pref * delpress[:, 1]
    naz = cfg.gravity - pref * delpress[:, 2]
    vx = vx + 0.5 * nax * dt
    vy = vy + 0.5 * nay * dt
    vz = vz + 0.5 * naz * dt

    # walls (FluidGPU-unidyn.cuh:404-413)
    zhit = torch.abs(pos[:, 2]) > cfg.wall_limit
    pz = torch.where(mob & zhit, cfg.wall_clamp / pos[:, 2], pos[:, 2])
    vz = torch.where(zhit, 0.0, vz)
    vy = torch.where(torch.abs(pos[:, 1]) > cfg.wall_limit, -vy, vy)
    vx = torch.where(torch.abs(pos[:, 0]) > cfg.wall_limit, -vx, vx)
    # the split nudge, once per trigger (FluidGPU-unidyn.cu:282)
    newly = acc.split_trigger & (~state.split)
    py = pos[:, 1] + torch.where(newly, cfg.split_y_nudge, 0.0)
    pos = torch.stack([pos[:, 0], py, pz], dim=1)

    mob1 = mob[:, None]
    alive1 = alive[:, None]
    return state.replace(
        pos=pos,
        vel=torch.where(mob1, torch.stack([vx, vy, vz], dim=1), state.vel),
        acc=torch.where(mob1, torch.stack([nax, nay, naz], dim=1), state.acc),
        # the trigger resets the mother's mass (FluidGPU-unidyn.cu:279)
        mass=torch.where(acc.split_trigger, 1.0, state.mass),
        dens=torch.where(alive, dens, state.dens),
        press=torch.where(alive, press, state.press),
        delpress=torch.where(alive1, delpress, state.delpress),
        diffusion=torch.where(alive1, acc.diffusion, state.diffusion),
        solid=solid, fluid=fluid,
        stress=torch.where(alive[:, None, None], dt * acc.stress_rate,
                           state.stress),
        split=state.split | acc.split_trigger,
    )
