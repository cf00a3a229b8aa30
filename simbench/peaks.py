"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit): HBM3 bandwidth and float32 operations outside the
tensor cores."""
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12


def bound_ms(nbytes: float, ops: float) -> float:
    """The least time of a kernel that moves ``nbytes`` and performs
    ``ops`` float32 operations: the larger of the two."""
    return max(nbytes / HBM_BYTES_S, ops / F32_OPS_S) * 1e3
