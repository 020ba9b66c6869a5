"""SPH solver configuration: ``tpufluids.config`` as plain Python.

Every field of the JAX package's ``SPHConfig`` is here with the same
name, order and default, so a config crosses between the packages as
its ``dataclasses.asdict`` (``tpufluids_torch.convert``).  The presets
``BASE_CONFIG`` and ``UNIDYN_CONFIG`` reproduce the reference's
constants (FluidGPU.cuh:1-31, FluidGPU-unidyn.cuh:1-36).

On the port the device of the state decides the force path: CPU
tensors run the plain PyTorch version, CUDA tensors launch the CUDA
kernel (``tpufluids_torch.sph_kernels``).  ``pallas_kernel`` names the
kernel family (``tpufluids_torch.step``).  The column family reads
``pallas_col_cap``, ``pallas_w_chunk`` and ``pallas_h_chunk`` through
``column_caps``, because its capacity caps decide which pairs are
dropped.  ``force_backend`` is read by ``step.use_kernels``: ``"xla"``
takes the JAX package's XLA pair path (torch ops, runs clipped at
``3 * max_per_cell`` rows) and refuses the sort cadence, as in the JAX
package; ``"auto"`` and ``"pallas"`` take the kernels.
``pallas_z_skip`` and the banded sweep's settings change no result
(``tpufluids/sph_pallas.py:223-242``, ``:329-346``); they are kept so
that a config round-trips, and the port does not read them.
"""

from __future__ import annotations

import dataclasses
import math

# The reference uses the literal 3.14159 in its smoothing kernels
# (FluidGPU.cu:13,16,25,28,37), not machine pi.  Kept for parity.
PI_REF = 3.14159


@dataclasses.dataclass(frozen=True)
class SPHConfig:
    """All solver constants. Defaults = base variant (FluidGPU.cuh:1-31).
    The comments of ``tpufluids.config.SPHConfig`` say what each one
    reproduces."""

    # variant: "base" (WCSPH, explicit Euler) or "unidyn" (two-phase)
    variant: str = "base"

    # domain / binning grid (FluidGPU.cuh:1-9)
    xmin: float = -1.0
    ymin: float = -1.0
    zmin: float = -1.0
    xmax: float = 1.0
    ymax: float = 1.0
    zmax: float = 1.0
    cell_size: float = 0.05
    grid_size: int = 40          # (xmax - xmin) / cell_size

    # physical constants (FluidGPU.cuh:10-14)
    gravity: float = -9.8
    sound: float = 1450.0
    rho0: float = 9550.0
    rho0_sand: float = 9550.0
    p0: float = 101325.0
    diff: float = 0.0

    # artificial viscosity (FluidGPU.cuh:16-20; -unidyn.cuh:17-21)
    alpha_fluid: float = -1.0
    alpha_boundary: float = 200.0
    alpha_sand: float = -1.55
    alpha_sand_boundary: float = 10.0
    # the literal 50 of the quadratic viscosity term (FluidGPU.cu:255)
    visc_quadratic: float = 50.0

    # boundary densification (FluidGPU.cuh:22)
    bdensfactor: float = 1.5

    # granular stress constants (FluidGPU.cuh:24-28; -unidyn.cuh:26-30)
    c1: float = 15.0
    c2: float = 0.0
    c3: float = 0.0
    phi: float = 1.23
    kc: float = 1e3
    stress_rate_reg: float = 1e8

    # mixture (drift-flux) couplings (FluidGPU-unidyn.cuh:32-33)
    mixpressure: float = 1e-12
    mixbrownian: float = 5e-9
    mix_frac_min: float = 0.001
    mix_frac_max: float = 0.999
    mixfactor_reg: float = 0.01
    solid_drag: float = 2e-7
    mixture_accel_weight: float = 5.0
    fluid_floor: float = 0.2

    # kernel support and timestep (FluidGPU.cuh:30-31)
    cutoff: float = 0.06         # smoothing length h; support radius 2h
    dt: float = 0.0005

    # quirky named constants: dens = (sum + W(0))/23 * (1 + bnd*BDENS)
    # + 9250 (FluidGPU.cuh:165-167), Tait EOS, the 0.003 static-friction
    # threshold, the 150/rho and (220 - 70 solid)/rho prefactors, walls
    dens_norm_div: float = 23.0
    dens_norm_offset: float = 9250.0
    eos_stiffness: float = 1000.0
    eos_gamma: float = 7.0
    friction_eps: float = 0.003
    accel_prefactor: float = 150.0
    accel_prefactor_unidyn: float = 220.0
    accel_prefactor_solid: float = 70.0
    floor_recycle_z: float = -0.89
    wall_limit: float = 0.98
    wall_clamp: float = 0.97

    # two-level binning (FluidGPU-unidyn.cu:181-192, 569-869)
    subbin_parity: bool = False
    subbin_threshold: int = 6

    # adaptive resolution (FluidGPU-unidyn.cu:261-285)
    merge_dist: float = -10.0
    merge_mass_new: float = 2.75
    merge_diffusion_max: float = 20.0
    split_mass_min: float = 3.0
    split_diffusion_min: float = 35000.0
    split_dens_max: float = 9400.0
    split_y_nudge: float = 0.015
    split_reinjection: bool = False
    split_child_y_offset: float = -0.03

    # TPU-side knobs of the JAX package, kept for the round trip
    force_backend: str = "auto"
    pallas_col_cap: int = 128
    pallas_w_chunk: int = 64
    pallas_h_chunk: int = -1
    pallas_z_skip: int = -1
    pallas_kernel: str = "auto"
    sort_every: int = 1
    # run capacity of the XLA pair path: a neighbour run keeps its first
    # 3 * max_per_cell rows and the rest count in bin_overflow (the
    # kernels' runs are uncapped)
    max_per_cell: int = 16

    @property
    def num_cells(self) -> int:
        return self.grid_size ** 3

    @property
    def support(self) -> float:
        return 2.0 * self.cutoff

    @property
    def yield_denom(self) -> float:
        """sqrt(9 + 12 tan^2 phi) (FluidGPU-unidyn.cu:436-438)."""
        t = math.tan(self.phi)
        return math.sqrt(9.0 + 12.0 * t * t)

    def replace(self, **kw) -> "SPHConfig":
        return dataclasses.replace(self, **kw)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def column_caps(cfg: SPHConfig) -> tuple[int, int]:
    """(b, w_cap): the column family's home cap (rows of a column that
    get forces) and window cap (rows of a neighbour column that count as
    candidates), as the JAX package derives them from
    ``pallas_col_cap``.  ``w_cap`` rounds up to a multiple of
    ``pallas_w_chunk`` (``sph_pallas.py:526-527``, ``:1129-1131``).  For
    the base variant ``b`` rounds up to a multiple of the home chunk,
    whose "auto" (-1) is 128 above a cap of 192 and 0 (none) otherwise
    (``tpufluids/step.py:115-117``, ``sph_pallas.py:528-533``)."""
    b = w_cap = cfg.pallas_col_cap
    if cfg.pallas_w_chunk:
        w_cap = _round_up(w_cap, cfg.pallas_w_chunk)
    if cfg.variant == "base":
        hc = cfg.pallas_h_chunk
        if hc < 0:
            hc = 128 if cfg.pallas_col_cap > 192 else 0
        if hc:
            if hc % 64:
                raise ValueError(f"pallas_h_chunk={hc}: only multiples of "
                                 f"64 are supported")
            b = _round_up(b, hc)
    return b, w_cap


# Base variant preset: FluidGPU.cuh:1-31 + solver.cu scene constants.
BASE_CONFIG = SPHConfig(pallas_col_cap=80)

# unidyn variant preset: FluidGPU-unidyn.cuh:1-36.
UNIDYN_CONFIG = SPHConfig(
    variant="unidyn",
    cell_size=0.12,
    grid_size=17,
    alpha_fluid=-0.155,
    alpha_boundary=80.0,
    alpha_sand=-1.55,
    alpha_sand_boundary=10.0,
    c1=15.0,
    c2=0.0,
    c3=50.0,
    kc=1e9,
    dt=0.0018,
    max_per_cell=32,
    subbin_parity=True,
)
