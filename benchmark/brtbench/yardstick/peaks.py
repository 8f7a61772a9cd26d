"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): float32 outside the tensor cores, and HBM3
bandwidth.  A run states its card's power limit beside every share."""

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound_seconds(flops: float, nbytes: float) -> tuple:
    """The least seconds the card needs for `flops` float32 operations and
    `nbytes` bytes moved, and which of the two bounds it: -> (seconds,
    "operations" | "bytes")."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
