"""tpufluids_torch: the port of tpufluids to PyTorch and CUDA.

``tpufluids_torch.grid.stam`` holds the 2D and 3D stable-fluids steps;
their stencil stages and solves are hand-written CUDA kernels
(``tpufluids_torch.grid.kernels``).  ``tpufluids_torch.step`` holds the
SPH step and its drivers (``scenes.base_dam`` -> ``step.run``); its
pair-force pass is a hand-written CUDA kernel
(``tpufluids_torch.sph_kernels``).  ``io`` holds checkpoints, the VTK
writers and the snapshot writer, ``diagnostics`` the metrics log and
the blow-up guard, ``cli`` the command line (``python -m
tpufluids_torch.cli``).  Kernel sources are in ``csrc/``, built by
``tpufluids_torch._build`` at their first launch, never on import.
The package imports torch and never JAX or the ``tpufluids`` package.
"""

__version__ = "0.1.0"

from tpufluids_torch.config import (BASE_CONFIG, UNIDYN_CONFIG,  # noqa: F401
                                    SPHConfig)
from tpufluids_torch.state import ParticleState  # noqa: F401
