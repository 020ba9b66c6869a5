"""The DCT pressure solve (the spectral projection's solve, the
``grid.solve:dct`` span): one call of stam.dct_solve3d solves the
Neumann-Poisson system of one projection, and a step makes two.

The count is the algorithm's, whatever implements it (today dense
matrix products and torch glue; a cuFFT or fused solve keeps the same
yardstick): roofline/step.py's spectral count, a fast cosine transform
forward and back on three axes and the scaling, 15 log2(n) + 1
operations a cell; the divergence read once and the pressure written
once, float32.  At 256^3: 2.03e9 operations (30.3 us at 67 TFLOP/s)
against 137.4 MB (41.0 us at 3.35 TB/s) a solve, so bytes bind and a
step's two solves take at least 82.0 us."""

import math

from fluidbench.roofline import peaks


def solve_work(n: int):
    """(bytes, operations, peak operations/s) of one solve at n^3."""
    return (2 * peaks.field_bytes(n), (15 * math.log2(n) + 1) * n ** 3,
            peaks.FP32_OPS_PER_S)


def work(stam: dict):
    """[(bytes, operations, peak operations/s)] of a step's two solves,
    each bound apart: the least time is the sum of their bounds."""
    return [solve_work(stam["n"])] * 2
