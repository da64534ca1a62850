"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit). Frozen: a later change to the
program cannot move the yardstick."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12  # f32 outside the tensor cores
F64_FLOP_PER_S = 67e12  # f64 on the tensor cores
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12


def least_seconds(nbytes: float, flops: float,
                  flop_rate: float = F32_FLOP_PER_S) -> tuple[float, str]:
    """The least time a piece of work can take on the card, and which of
    the two bounds it: bytes over HBM bandwidth or FLOPs over the peak."""
    tb = nbytes / HBM_BYTES_PER_S
    tf = flops / flop_rate
    return (tb, "bytes") if tb >= tf else (tf, "flops")
