"""dct_solve_roofline (%): the DCT solves' least time, by the count in
roofline/dct_solve.py for each grid.solve:dct span of the traced slice,
over the device time of the operations launched inside those spans
(spans.attribute).  Source: the program's spans.  Layer: kernels.
Moves updates_per_s.host_paced (the DCT cell is host-paced, so the name
is dct_solve_roofline.host_paced)."""

from fluidbench import spans
from fluidbench.roofline import dct_solve, peaks

LABEL = spans.SOLVE + ":dct"


def read(tr):
    p = getattr(tr, "program", None)
    if p is None or not p.events.get(LABEL) or not p.device_us.get(LABEL):
        return None
    least = peaks.bound_s(*dct_solve.solve_work(tr.stam["n"]))[0]
    return 100.0 * p.events[LABEL] * least / (p.device_us[LABEL] / 1e6)
