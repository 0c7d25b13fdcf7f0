"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit). Roofline shares are stated against these, with
the card's power limit beside them in the run's record."""

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def bound_of(flops: float, nbytes: float) -> str:
    """Which bound applies: 'compute' or 'memory'."""
    return "compute" if flops / BF16_FLOPS >= nbytes / HBM_BYTES_PER_S else "memory"
