"""advect_roofline (%): both advections of each step (k = 3, then k =
2), their least time by the frozen count in roofline/advect.py, over the
device time of their kernels in the traced slice.  Layer: kernels.
Moves updates_per_s (updates_per_s.host_paced in a host-paced cell,
under the name advect_roofline.host_paced)."""

from fluidbench import trace
from fluidbench.roofline import advect


def read(tr: trace.Slice):
    return trace.kernel_share(tr, advect)
