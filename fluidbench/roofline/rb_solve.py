"""The red-black pressure solve (kernel #10, csrc/rb_blocked.cu): one
call of kernels.lin_solve3d_rb, ``jacobi_iters`` iterations of two
half-sweeps from a zero guess on a ghosted float32 field.

The algorithm needs the right-hand side read once and the solution
written once (the zero guess is not read), and 8 float32 operations a
cell an iteration (5 adds, a multiply-add, a multiply; a red-black
iteration updates each cell once).  At 256^3 bytes bind: 0.041 ms
against 0.040 ms of operations at 67 TFLOP/s.  Frozen from
chip_smoke.py's GRID_OPS["lin_solve3d_rb"] and grid_work()."""

from fluidbench.roofline import peaks

# profiler kernel names of one solve: its blocked passes and its ghost
# pass; the first must appear at least once a call
NAMES = ("rb_blocked_kernel", "ghost_kernel")
COUNTER = "lin_solve3d_rb"
CALLS = 1                # counted calls that work() covers


def work(stam: dict):
    """[(bytes, operations, peak operations/s)] of one solve."""
    n = stam["n"]
    return [(2 * peaks.field_bytes(n), 8 * stam["jacobi_iters"] * n ** 3,
             peaks.FP32_OPS_PER_S)]
