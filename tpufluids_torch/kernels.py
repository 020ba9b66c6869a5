"""SPH smoothing kernels on tensors: ``tpufluids.kernels`` in PyTorch.

The reference's kernel functions, with the literal pi = 3.14159 and
the cubic-spline density / spiky-gradient mismatch kept:

* ``w_cubic``       <- ``kernel``            (FluidGPU.cu:11-21)
* ``w_cubic_deriv`` <- ``kernel_test``       (FluidGPU.cu:23-33)
* ``grad_w_spiky``  <- ``kernel_derivative`` (FluidGPU.cu:35-43)

All take the pair distance ``r`` (a float32 tensor) and the smoothing
length ``h`` (a Python float, the reference's ``cutoff``).
"""

from __future__ import annotations

import torch

from tpufluids_torch.config import PI_REF


def _scalar(r: torch.Tensor, x: float) -> torch.Tensor:
    """x as a scalar tensor on r's device: on CUDA, torch turns a
    division by a Python number into a multiplication by its reciprocal;
    a division by a device scalar divides, on every device, as the CUDA
    kernels do (csrc/sph_common.cuh)."""
    return torch.full((), x, dtype=r.dtype, device=r.device)


def w_cubic(r: torch.Tensor, h: float) -> torch.Tensor:
    """Cubic-spline density kernel W(r); support 2h."""
    q = r / _scalar(r, h)
    inner = 1.0 - 1.5 * q * q + 0.75 * q * q * q          # 0 <= r <= h
    outer = 0.25 * (2.0 - q) ** 3                          # h < r < 2h
    val = torch.where(q <= 1.0, inner, torch.where(q < 2.0, outer, 0.0))
    return val / _scalar(r, PI_REF * h ** 3)


def w_cubic_deriv(r: torch.Tensor, h: float) -> torch.Tensor:
    """Cubic-spline derivative (the reference's ``kernel_test``, only
    used by commented-out code there; kept for parity)."""
    q = r / h
    inner = 1.0 - 3.0 * q + 2.25 * q * q
    outer = -0.5 * (2.0 - q) ** 2
    val = torch.where(q <= 1.0, inner, torch.where(q < 2.0, outer, 0.0))
    return val / (PI_REF * h ** 4)


def grad_w_spiky(r: torch.Tensor, h: float) -> torch.Tensor:
    """Spiky-type gradient magnitude dW/dr: -45/(pi h^6) (h - r)^2 for
    r < h, else 0 (zero on [h, 2h) although W is not: a parity quirk)."""
    val = -45.0 / (PI_REF * h ** 6) * (h - r) ** 2
    return torch.where(r < h, val, 0.0)


def w0(h: float) -> float:
    """W(0), the self-contribution of the density normalization
    (FluidGPU.cuh:166)."""
    return 1.0 / (PI_REF * h ** 3)
