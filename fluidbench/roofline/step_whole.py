"""The whole step (kernel #7, csrc/step.cu with csrc/step_blocked.cuh):
one call of kernels.step3d_whole runs a Jacobi or red-black step,
forcing, diffusions, both projections and both advections, in one
cooperative launch.

The algorithm needs the five fields read once and written once, float32,
and per interior cell the operations of its phases (step_ops below,
counted from the kernels' sources: a min, max, sqrt or division counts
as one).  At 64^3 operations bind: 408 MFLOP, 6.1 us at 67 TFLOP/s,
against 3.4 us of bytes.  Frozen from chip_smoke.py's step_ops() and
GRID_OPS["step3d_whole"]."""

from fluidbench.roofline import peaks

NAMES = ("step_whole_kernel",)
COUNTER = "step3d_whole"
CALLS = 1                # counted calls that work() covers


def step_ops(stam: dict) -> int:
    """Operations a cell of a Jacobi or red-black step: two projections
    (divergence 6, 8 a sweep, gradient subtraction 15), the two
    advections (51 + 27 * 8 and 51 + 27 * 6), buoyancy 6, vorticity
    confinement 70, and 8 a sweep of each diffused field."""
    iters = stam["jacobi_iters"]
    ops = 2 * (6 + 8 * iters + 15) + (51 + 27 * 8) + (51 + 27 * 6)
    ops += 6 if stam["buoyancy_alpha"] or stam["buoyancy_beta"] else 0
    ops += 70 if stam["vorticity_eps"] else 0
    return ops + 8 * iters * (3 * bool(stam["visc"]) + bool(stam["diff"])
                              + bool(stam["temp_diff"]))


def work(stam: dict):
    """[(bytes, operations, peak operations/s)] of one step."""
    n = stam["n"]
    return [(10 * peaks.field_bytes(n), step_ops(stam) * n ** 3,
             peaks.FP32_OPS_PER_S)]
