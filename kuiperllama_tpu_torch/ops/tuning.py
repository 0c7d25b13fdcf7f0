"""Kernel-route knobs and shape-keyed defaults, a port of
kuiperllama_tpu/ops/tuning.py (the KT_* table).

Every KT_* environment variable the port reads is read in this module and
nowhere else, with the JAX package's name, default and reading time: the
`*_at_import` values once, when this module is imported; the functions each
time they are called (the JAX Generator reads those when it traces a chunk,
the port when a chunk starts). The defaults are the JAX package's, chosen
there by measurements on a TPU; none of them has been re-measured on the
card, so none is a claim about it.

| knob             | default | in the port                                  |
|------------------|---------|----------------------------------------------|
| KT_FUSED_STEP    | auto    | ported: `fused_step_env()`; 0/1 overrides    |
|                  |         | the Generator's auto route (`_fused_ok`)     |
| KT_FUSED_CHUNK   | 0       | ported: `fused_chunk_on()`; 1 takes the      |
|                  |         | greedy chunk megakernel when the small plan  |
|                  |         | fits and sampling is greedy                  |
| KT_FUSED_BIG     | 0       | ported: `fused_big_on()`; 1 takes the        |
|                  |         | big-model megakernel when the small plan     |
|                  |         | does not fit and the big plan does           |
| KT_BIG_INT8      | 1       | ported: `BIG_INT8`, read at import; the big  |
|                  |         | kernel's GEMVs take int8 activations         |
| KT_GEMV_INT8     | auto    | ported: read at import; 0/1 overrides        |
|                  |         | `gemv_int8_auto`                             |
| KT_DIAG_MAX      | 64      | a constant of the port's routing:            |
|                  |         | `ops/linear.py` GEMV_MAX_GROUPS              |
| KT_PREFILL_XLA_M | 256     | a constant of the port's routing:            |
|                  |         | `ops/linear.py` PREFILL_DEQUANT_ROWS         |
| KT_BIG_TILE      | 9 MB    | a constant of the big plan:                  |
|                  |         | `ops/kernels/fused_decode_big.py`            |
|                  |         | `_TILE_BUDGET`                               |
| KT_MIN_NT        | 1       | a constant of the small plan: its tile       |
|                  |         | counts start at 1 (`plan_tiles`)             |
| KT_BLOCK_OUT,    | 512,    | TPU tile sizes of the Pallas matmul; the     |
| KT_BLOCK_IN      | 4096    | CUDA kernels choose their own tiles          |
| KT_XLA_DIAG      | 1       | selects an XLA form of the TPU GEMV; no      |
|                  |         | meaning here                                 |
| KT_UNROLL        | 1       | unroll of the JAX decode scan; no meaning    |
|                  |         | here                                         |
| KT_BIG_STAGGER   | 1       | Mosaic prefetch order of the big kernel; no  |
|                  |         | meaning here                                 |
| KT_BIG_ABLATE    | unset   | Mosaic phase ablations for measurement; no   |
|                  |         | meaning here                                 |
| KT_SUB_BUDGET    | 6 MB    | VMEM sub-chunk of the TPU GEMV; no meaning   |
|                  |         | here                                         |
| KT_MIXED_DOT     | 0       | a Mosaic dot form; no meaning here           |
| KT_DUS_WRITE     | 0       | an XLA cache-write form; no meaning here     |

Shape rule (gemv_int8_auto): with many group rows (ngp >= 32, e.g. group 64
at dim >= 2048) the small megakernel quantizes the normed activation per
group and contracts int8 x int8 into exact int32 sums; with fewer rows it
keeps the bf16 activation. The row count is the JAX package's PADDED
scale-row count (see ops/kernels/fused_decode.py `padded_groups`), because
that is what its megakernel reads, and the choice changes the rounding.
"""

from __future__ import annotations

import os as _os

# the JAX package's crossover: int8-activation GEMVs at >= this many group rows
GEMV_INT8_MIN_GROUPS = 32

_GEMV_INT8_ENV = _os.environ.get("KT_GEMV_INT8")  # read at import, as in JAX
BIG_INT8 = _os.environ.get("KT_BIG_INT8", "1") == "1"  # read at import


def gemv_int8_auto(ngp: int) -> bool:
    """Whether a megakernel GEMV over `ngp` (padded) group rows takes an
    int8 activation (KT_GEMV_INT8=0/1 overrides)."""
    if _GEMV_INT8_ENV is not None:
        return _GEMV_INT8_ENV == "1"
    return ngp >= GEMV_INT8_MIN_GROUPS


def fused_step_env():
    """KT_FUSED_STEP: None when unset (auto), else whether it is "1"."""
    env = _os.environ.get("KT_FUSED_STEP")
    return None if env is None else env == "1"


def fused_chunk_on() -> bool:
    """KT_FUSED_CHUNK=1: the greedy chunk megakernel route."""
    return _os.environ.get("KT_FUSED_CHUNK") == "1"


def fused_big_on() -> bool:
    """KT_FUSED_BIG=1: the big-model megakernel route."""
    return _os.environ.get("KT_FUSED_BIG", "0") == "1"
