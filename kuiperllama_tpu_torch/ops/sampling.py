"""Token sampling on the device: greedy, temperature, top-k and top-p.

Random draws come from a caller-owned `torch.Generator` on the logits'
device, so a seeded run repeats exactly and nothing syncs with the host.
"""

from __future__ import annotations

from typing import Optional

import torch


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits: [..., vocab] -> int32 token ids [...] (first index on ties)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def filter_logits(logits: torch.Tensor, temperature: float, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """Temperature-scaled fp32 logits with the tokens outside the top-k set
    and outside the top-p nucleus set to -inf."""
    logits = logits.float() / temperature
    if top_k and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens while the cumulative probability before them < top_p;
        # the cutoff is the SMALLEST kept logit (the first token always stays)
        keep = cum - probs < top_p
        cutoff = torch.where(keep, sorted_logits,
                             torch.full_like(sorted_logits, float("inf")))
        cutoff = cutoff.amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def sample_token(
    logits: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """General sampler. temperature <= 0 means greedy. logits [B, V] -> [B]."""
    if temperature <= 0.0:
        return sample_greedy(logits)
    probs = torch.softmax(filter_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0].to(
        torch.int32)
