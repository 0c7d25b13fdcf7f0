"""The control of the comparison that decides `correct`: the reference with
its weights in the nearest precision below the one the configuration states,
the step that would tempt a later change.

  int8 weights (group g)  -> int4, symmetric, the same groups of g along K;
  bf16 weights            -> fp8 e4m3, one scale per output column.

The embedding lookup, norms and biases keep their precision; the lm_head is
a weight like the others (tied or not). Nothing here imports the program.
"""

from __future__ import annotations

import torch

from benchmark.harness.weights import dequantize

FP8_MAX = 448.0


def int4_groups(w: torch.Tensor, g: int) -> torch.Tensor:
    """w [..., K, N] float32 rounded to symmetric int4 over groups of g rows
    (of each matrix of a stack)."""
    *lead, K, N = w.shape
    wg = w.reshape(*lead, K // g, g, N)
    step = wg.abs().amax(dim=-2, keepdim=True).clamp(min=1e-30) / 7.0
    return (torch.clamp(torch.round(wg / step), -7, 7) * step).view(*lead, K, N)


def fp8_columns(w: torch.Tensor) -> torch.Tensor:
    """w [..., K, N] float32 through fp8 e4m3 with one scale per column (of
    each matrix of a stack)."""
    scale = w.abs().amax(dim=-2, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def weight_fn(config: dict):
    """`weight(raw_matrix, layer)` of the control for this configuration."""
    stated = config["benchmark"]["weights"]
    if stated == "int8":
        g = config["benchmark"]["group_size"]
        return lambda w, layer=None: int4_groups(dequantize(w, layer), g)
    if stated == "bfloat16":
        return lambda w, layer=None: fp8_columns(dequantize(w, layer))
    raise ValueError(f"no control below {stated!r} weights")
