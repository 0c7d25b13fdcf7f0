"""Rotary position embeddings, both pairing conventions.

  "interleaved" (llama2.c): adjacent pairs (i, i+1);
  "half" (HF llama3/qwen2): pairs (i, i + hd/2).
Both share the frequency vector theta^(-2j/hd) over pair index j; only the
pairing differs. The sin/cos tables are fp32.
"""

from __future__ import annotations

import math

import torch

from ..config import ROPE_HALF, ROPE_INTERLEAVED, RopeScaling


def scale_inv_freq(inv_freq: torch.Tensor, scaling: RopeScaling | None):
    """Frequency-dependent RoPE scaling (HF Llama-3.x "llama3" rope_type, and
    "linear"): low-frequency components divide by `factor`, high-frequency
    ones pass through, a smooth ramp interpolates between the two bands."""
    if scaling is None:
        return inv_freq
    if scaling.rope_type == "linear":
        return inv_freq / scaling.factor
    assert scaling.rope_type == "llama3", scaling.rope_type
    old_len = float(scaling.original_max_position_embeddings)
    low_wavelen = old_len / scaling.low_freq_factor
    high_wavelen = old_len / scaling.high_freq_factor
    wavelen = 2.0 * math.pi / inv_freq
    scaled = torch.where(wavelen > low_wavelen, inv_freq / scaling.factor,
                         inv_freq)
    smooth = (old_len / wavelen - scaling.low_freq_factor) / (
        scaling.high_freq_factor - scaling.low_freq_factor
    )
    smoothed = (1.0 - smooth) * inv_freq / scaling.factor + smooth * inv_freq
    medium = (wavelen >= high_wavelen) & (wavelen <= low_wavelen)
    return torch.where(medium, smoothed, scaled)


def rope_cache(seq_len: int, head_dim: int, theta: float,
               scaling: RopeScaling | None = None, device="cpu"):
    """Returns (sin, cos), each [seq_len, head_dim // 2], fp32."""
    j = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    inv_freq = 1.0 / (theta ** (j / head_dim))
    inv_freq = scale_inv_freq(inv_freq, scaling)
    t = (torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
         * inv_freq[None, :])
    return torch.sin(t), torch.cos(t)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
               style: str) -> torch.Tensor:
    """Rotate x: [..., T, H, head_dim] with sin/cos gathered per position,
    broadcastable to [..., T, 1, head_dim // 2]. Math in fp32."""
    if style == ROPE_HALF:
        half = x.shape[-1] // 2
        x1 = x[..., :half].float()
        x2 = x[..., half:].float()
        out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    elif style == ROPE_INTERLEAVED:
        xe = x[..., 0::2].float()
        xo = x[..., 1::2].float()
        oe = xe * cos - xo * sin
        oo = xe * sin + xo * cos
        out = torch.stack([oe, oo], dim=-1).reshape(x.shape)
    else:
        raise ValueError(f"unknown rope style {style!r}")
    return out.to(x.dtype)


def gather_rope(sin: torch.Tensor, cos: torch.Tensor, positions: torch.Tensor):
    """Per-token sin/cos. positions: [B, T] int ->
    ([B, T, 1, hd/2], [B, T, 1, hd/2]) ready to broadcast over heads.
    A position past the table takes its last row, as JAX clamps a gather."""
    positions = positions.long().clamp(max=sin.shape[0] - 1)
    return sin[positions][..., None, :], cos[positions][..., None, :]
