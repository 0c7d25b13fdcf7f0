"""Plain float32 reference of the Qwen2 decoder (Qwen2.5), in plain PyTorch.

It follows the published architecture: token embedding; per layer an RMSNorm
(weight, eps), q/k/v projections with biases, rotary embedding on
half-split pairs (i, i + head_dim / 2) with theta^(-2j / head_dim),
grouped-query causal softmax attention, the output projection and the
residual, an RMSNorm, the SwiGLU MLP (silu(x W1) * (x W3)) W2 and the
residual; a final RMSNorm and the lm_head (the embedding matrix when tied).
Every matmul is float32 with TF32 off; the weights are the benchmark's raw
tensors (layouts/qwen2.py) widened to float32 layer by layer. It imports
nothing of the program and takes nothing the program made: the caller makes
the weights again from the seed.

The one departure: no KV cache, no batching. Each sequence is one causal
forward over all its tokens, blocked over queries so that it fits.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch

from benchmark.harness.weights import dequantize
from benchmark.layouts.qwen2 import shapes

Q_BLOCK = 512


@contextmanager
def exact_fp32():
    """float32 matmuls without TF32 inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def rmsnorm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def rope_tables(T: int, hd: int, theta: float, device):
    """(cos, sin) [T, hd / 2] of the half-split rotary embedding, worked out
    in float64."""
    j = torch.arange(0, hd, 2, dtype=torch.float64, device=device)
    inv = theta ** (-j / hd)
    ang = torch.arange(T, dtype=torch.float64, device=device)[:, None] * inv[None]
    return torch.cos(ang).float(), torch.sin(ang).float()


def rope(x, cos, sin):
    """x [T, heads, hd]: pairs (i, i + hd / 2) rotated by position."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[:, None], sin[:, None]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def attention(q, k, v):
    """Causal GQA attention: q [T, H, hd], k and v [T, KH, hd]."""
    T, H, hd = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)  # [H, T, hd]
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    qh = q.transpose(0, 1)
    out = torch.empty_like(qh)
    scale = 1.0 / math.sqrt(hd)
    for a in range(0, T, Q_BLOCK):
        b = min(a + Q_BLOCK, T)
        sc = (qh[:, a:b] @ k[:, :b].transpose(1, 2)) * scale  # [H, qb, b]
        causal = (torch.arange(b, device=q.device)[None]
                  <= torch.arange(a, b, device=q.device)[:, None])
        sc = sc.masked_fill(~causal, float("-inf"))
        out[:, a:b] = torch.softmax(sc, dim=-1) @ v[:, :b]
    return out.transpose(0, 1)


def layer_weights(raw, li, weight=dequantize) -> dict:
    """Layer li's matrices widened to float32 by `weight`, its norms and
    biases in float32."""
    Ly = raw["layers"]
    out = {n: weight(Ly[n], li) for n in ("wq", "wk", "wv", "wo", "w1", "w3", "w2")}
    out.update({n: Ly[n][li].float() for n in ("attn_norm", "ffn_norm", "bq", "bk", "bv")
                if n in Ly})
    return out


def layer(x, w, s, cos, sin):
    """One decoder layer on x [T, d] in float32 with layer weights `w`."""
    T = x.shape[0]
    H, KH, hd = s["H"], s["KH"], s["hd"]
    h = rmsnorm(x, w["attn_norm"], s["eps"])
    q, k, v = h @ w["wq"], h @ w["wk"], h @ w["wv"]
    if s["bias"]:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q = rope(q.view(T, H, hd), cos[:T], sin[:T])
    k = rope(k.view(T, KH, hd), cos[:T], sin[:T])
    a = attention(q, k, v.view(T, KH, hd)).reshape(T, H * hd)
    x = x + a @ w["wo"]
    h = rmsnorm(x, w["ffn_norm"], s["eps"])
    return x + (torch.nn.functional.silu(h @ w["w1"]) * (h @ w["w3"])) @ w["w2"]


def lm_head(raw, weight=dequantize) -> torch.Tensor:
    """The lm_head [d, V] in float32: the embedding's transpose when tied."""
    if raw["lm_head"] is None:
        return weight(raw["tok_emb"].t())
    return weight(raw["lm_head"])


@torch.no_grad()
def logits(config: dict, raw: dict, sequences, weight=dequantize) -> list:
    """Next-token logits of each sequence at its wanted positions.

    sequences: [(token ids, positions)], where position p asks for the
    logits that predict token p + 1. Returns one float32 [len(positions),
    V] tensor per sequence. `weight` widens a raw matrix (the control passes
    a lower-precision one)."""
    s = shapes(config)
    dev = raw["tok_emb"].device
    T_max = max(len(ids) for ids, _ in sequences)
    cos, sin = rope_tables(T_max, s["hd"], s["theta"], dev)
    with exact_fp32():
        xs = [raw["tok_emb"][torch.tensor(ids, device=dev)].float()
              for ids, _ in sequences]
        for li in range(s["L"]):
            w = layer_weights(raw, li, weight)
            xs = [layer(x, w, s, cos, sin) for x in xs]
            del w
        w = lm_head(raw, weight)
        out = []
        for x, (_, pos) in zip(xs, sequences):
            h = rmsnorm(x[torch.tensor(pos, device=dev)], raw["final_norm"].float(),
                        s["eps"])
            out.append(h @ w)
    return out
