"""step_whole_roofline (%): the whole-step launches' least time, by the
frozen count in roofline/step_whole.py, over the device time of their
kernel in the traced slice.  Layer: kernels.  Moves updates_per_s."""

from fluidbench import trace
from fluidbench.roofline import step_whole


def read(tr: trace.Slice):
    return trace.kernel_share(tr, step_whole)
