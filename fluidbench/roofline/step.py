"""A whole step of any projection, for the step's share of the peak
(step_mfu): the least work the algorithm needs, whatever implements it.

Bytes: the five fields read once and written once, float32.  Operations
a cell: roofline/step_whole.py's step_ops for the Jacobi and red-black
projections; for the spectral (DCT) projection each solve counts as a
fast cosine transform forward and back on three axes, 2.5 log2(n)
operations a cell a transform, and the scaling, 15 log2(n) + 1 in all,
in place of the 8 a sweep.  So the count is a lower bound for the
dense-matrix transforms the program runs, and the share cannot pass
100% while the step keeps its work."""

import math

from fluidbench.roofline import peaks, step_whole


def step_ops(stam: dict) -> float:
    ops = step_whole.step_ops(stam)
    if stam["projection"] == "dct":
        sweeps = 8 * stam["jacobi_iters"]
        ops += 2 * (15 * math.log2(stam["n"]) + 1 - sweeps)
    return ops


def work(stam: dict):
    """[(bytes, operations, peak operations/s)] of one step."""
    n = stam["n"]
    return [(10 * peaks.field_bytes(n), step_ops(stam) * n ** 3,
             peaks.FP32_OPS_PER_S)]
