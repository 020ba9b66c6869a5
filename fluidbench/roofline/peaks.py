"""Published peaks of one NVIDIA H100 SXM (data sheet and whitepaper,
dense, at the full 700 W power limit), and the least time a piece of
work can take on it.  Frozen: every roofline share divides by these.

Copied from chip_smoke.py (HBM_BYTES_PER_S, FP32_OPS_PER_S,
BF16_OPS_PER_S and bound()); operations outside the tensor cores, with
bfloat16 at twice the float32 rate (two to an instruction)."""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 133.8e12
FLOAT32_BYTES = 4


def bound_s(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    """(seconds, what binds): the larger of the bytes over the memory's
    bandwidth and the operations over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def field_bytes(n: int) -> int:
    """Bytes of one ghosted (n+2)^3 float32 field."""
    return (n + 2) ** 3 * FLOAT32_BYTES
