"""Perplexity evaluation, a port of kuiperllama_tpu/evaluate.py.

Quantization damage is gated quantitatively: perplexity over a token
stream, with |ppl(int8) - ppl(fp32)| <= 0.1 as the acceptance bar
(BASELINE.md). Each window goes through the port's `decoder.forward` over
an fp32 KV cache with fp32 `log_softmax`; the INT8 projections take the
route `ops/linear.py` gives their row count (B x window rows: below 256
that is the GEMM kernel on the card, its plain version on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .models import decoder

GATE = 0.1


@torch.no_grad()
def window_nll(cfg: ModelConfig, params, tokens, rope=None):
    """Summed negative log-likelihood of tokens[:, 1:] given tokens[:, :-1].

    tokens: int [B, T] (on any device; moved to the params' device).
    Returns (total nll, a fp32 scalar tensor, count)."""
    dev = params["tok_emb"].device
    tokens = torch.as_tensor(tokens, dtype=torch.int32).to(dev)
    B, T = tokens.shape
    cache = decoder.init_kv_cache(cfg, batch=B, max_len=T, dtype=torch.float32,
                                  device=dev)
    positions = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    logits, _ = decoder.forward(cfg, params, tokens, positions, cache,
                                rope=rope, drop_past_end=False)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = tokens[:, 1:].long()
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    return nll.sum(), (T - 1) * B


def perplexity(cfg: ModelConfig, params, token_stream, window: int = 256,
               batch: int = 1) -> float:
    """Perplexity of a 1-D token stream, evaluated in independent windows
    (no cross-window context)."""
    toks = np.asarray(token_stream, np.int32)
    n_win = len(toks) // window
    assert n_win >= 1, "token stream shorter than one window"
    toks = toks[: n_win * window].reshape(n_win, window)
    rope = decoder.build_rope(cfg, params["tok_emb"].device)
    total, count = 0.0, 0
    for i in range(0, n_win, batch):
        nll, c = window_nll(cfg, params, torch.from_numpy(toks[i: i + batch]),
                            rope=rope)
        total += float(nll)
        count += c
    return float(np.exp(total / count))


def quantization_ppl_delta(cfg_fp, params_fp, cfg_q, params_q, token_stream,
                           window: int = 256) -> dict:
    """ppl(fp) against ppl(int8) on the same stream, as a small report."""
    ppl_fp = perplexity(cfg_fp, params_fp, token_stream, window)
    ppl_q = perplexity(cfg_q, params_q, token_stream, window)
    return {
        "ppl_fp": ppl_fp,
        "ppl_int8": ppl_q,
        "delta": ppl_q - ppl_fp,
        "passes_gate": abs(ppl_q - ppl_fp) <= GATE,
    }
