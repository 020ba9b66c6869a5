"""rb_solve_roofline (%): the red-black solves' least time, by the frozen
count in roofline/rb_solve.py, over the device time of their kernels in
the traced slice.  Layer: kernels.  Moves updates_per_s."""

from fluidbench import trace
from fluidbench.roofline import rb_solve


def read(tr: trace.Slice):
    return trace.kernel_share(tr, rb_solve)
