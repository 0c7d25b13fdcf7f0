"""Shape-keyed kernel defaults, a port of kuiperllama_tpu/ops/tuning.py.

Only the rule that decides numerics is carried over: whether a GEMV of the
decode megakernel quantizes its activation per group to int8. The JAX
package's environment overrides and its table of tuned tile sizes are not
ported; those values were measured on a TPU.

Shape rule (gemv_int8_auto): with many group rows (ngp >= 32, e.g. group 64
at dim >= 2048) the megakernel quantizes the normed activation per group
and contracts int8 x int8 into exact int32 sums; with fewer rows it keeps
the bf16 activation. The row count is the JAX package's PADDED scale-row
count (see ops/kernels/fused_decode.py `padded_groups`), because that is
what its megakernel reads, and the choice changes the rounding.
"""

from __future__ import annotations

# the JAX package's crossover: int8-activation GEMVs at >= this many group rows
GEMV_INT8_MIN_GROUPS = 32


def gemv_int8_auto(ngp: int) -> bool:
    """Whether a megakernel GEMV over `ngp` (padded) group rows takes an
    int8 activation."""
    return ngp >= GEMV_INT8_MIN_GROUPS
