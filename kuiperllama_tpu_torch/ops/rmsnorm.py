"""RMSNorm with fp32 accumulation regardless of the activation dtype."""

import torch


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """x: [..., dim], weight: [dim]. Returns x's dtype."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(ms + eps)
    return (normed * weight.float()).to(x.dtype)
