"""The stencil advection (kernel #1, csrc/advect.cu with
csrc/stencil_march.cuh): one call of kernels.advect3d_multi advects k
fields by (u, v, w) with the 27-tap stencil.  A step makes two calls:
the velocity advects itself (k = 3: u, v, w in, 3 out) and then the
two scalars (k = 2: u, v, w, dens, temp in, 2 out).

Each input read once, each output written once, float32; per interior
cell 51 operations for the backtrace weights (17 an axis) and per tap
2 weight products and a multiply-add a field: 51 + 27 (2 + 2k).  Bytes
bind at 256^3.  Frozen from chip_smoke.py's GRID_OPS["advect3d_multi"]
and grid_work()."""

from fluidbench.roofline import peaks

NAMES = ("advect_march_kernel",)
COUNTER = "advect3d_multi"
CALLS = 2                # counted calls that work() covers: a step's


def call_work(n: int, k: int):
    """(bytes, operations) of one call that advects k fields."""
    inputs = 3 if k == 3 else 3 + k     # a velocity advecting itself
    return ((inputs + k) * peaks.field_bytes(n),
            (51 + 27 * (2 + 2 * k)) * n ** 3)


def work(stam: dict):
    """[(bytes, operations, peak operations/s)] of a step's two calls,
    each bound apart: the least time is the sum of their bounds."""
    n = stam["n"]
    return [(*call_work(n, 3), peaks.FP32_OPS_PER_S),
            (*call_work(n, 2), peaks.FP32_OPS_PER_S)]
