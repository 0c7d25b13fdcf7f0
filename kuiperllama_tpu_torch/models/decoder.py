"""Llama-family decoder forward pass (Llama-2 / TinyLlama / Llama-3.x /
Qwen2.5), a port of kuiperllama_tpu/models/decoder.py.

  * per-layer weights stacked on a leading L axis; the layer loop indexes
    the stack (zero-copy views), so no weight is copied per layer;
  * one forward covers prefill (T = prompt length) and batched decode (T = 1);
  * fp32 softmax/norm accumulation, bf16 (configurable) activations;
  * head counts come from the weight shapes, not the config;
  * the dense KV cache [L, B, S, KH, hd] is updated IN PLACE (the JAX
    package returns a new cache; here that would copy gigabytes per step).
    A position must be < S: the JAX package drops writes at positions >= S,
    which only its serving engine uses, and on the card an out-of-range
    index fails the cache write.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import ModelConfig
from ..ops.attention import attention_dense
from ..ops.linear import linear, linear_layered
from ..ops.rmsnorm import rmsnorm
from ..ops.rope import apply_rope, gather_rope, rope_cache


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: Optional[int] = None,
                  dtype=torch.float32, device="cuda"):
    """Dense KV cache {k, v}, each [L, B, S, KH, hd] of zeros."""
    S = max_len or cfg.seq_len
    shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.head_dim)
    return dict(k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device))


def build_rope(cfg: ModelConfig, device="cuda"):
    """(sin, cos) tables [seq_len, head_dim // 2] in fp32 on `device`."""
    return rope_cache(cfg.seq_len, cfg.head_dim, cfg.rope_theta,
                      scaling=cfg.rope_scaling, device=device)


def forward(cfg: ModelConfig, params, tokens, positions, kv_cache,
            kv_len_mask=None, last_pos=None, *, rope=None, mode: str = "fast"):
    """Forward over [B, T] tokens.

    tokens:    int [B, T]
    positions: int [B, T] absolute positions (cache slot == position, < S).
    kv_cache:  dict(k, v) [L, B, S, KH, hd]; written in place.
    kv_len_mask: optional [B, S] bool of valid slots for ragged batches.
    last_pos:  optional int [B] — compute logits only at this token index
               per row (prefill wants the final real token's logits).
    rope:      optional (sin, cos) from `build_rope`, to skip rebuilding it.
    mode:      "fast" | "exact" rounding of the INT8 matmul kernels.

    Returns (logits fp32 [B, T_or_1, vocab], kv_cache).
    """
    B, T = tokens.shape
    hd = cfg.head_dim
    x = params["tok_emb"][tokens.long()]  # [B, T, dim] in weight dtype
    sin, cos = rope if rope is not None else build_rope(cfg, x.device)
    s, c = gather_rope(sin, cos, positions)  # [B, T, 1, hd/2]
    b_idx = torch.arange(B, device=x.device)[:, None]
    slots = positions.long()

    blocks = params["blocks"]
    fused = "wqkv" in blocks
    if fused:
        H = blocks["wo"].shape[-2] // hd
        KH = (blocks["wqkv"].shape[-1] - H * hd) // (2 * hd)
    else:
        H = blocks["wq"].shape[-1] // hd
        KH = blocks["wk"].shape[-1] // hd
    hidden = blocks["w2"].shape[-2]
    k_all, v_all = kv_cache["k"], kv_cache["v"]

    for li in range(cfg.n_layers):
        h = rmsnorm(x, blocks["attn_norm"][li], cfg.norm_eps)
        if fused:
            qkv = linear_layered(h, blocks["wqkv"], li, blocks.get("bqkv"),
                                 mode=mode)
            q = qkv[..., : H * hd]
            k = qkv[..., H * hd: (H + KH) * hd]
            v = qkv[..., (H + KH) * hd:]
        else:
            q = linear_layered(h, blocks["wq"], li, blocks.get("bq"), mode=mode)
            k = linear_layered(h, blocks["wk"], li, blocks.get("bk"), mode=mode)
            v = linear_layered(h, blocks["wv"], li, blocks.get("bv"), mode=mode)
        q = apply_rope(q.reshape(B, T, H, hd), s, c, cfg.rope_style)
        k = apply_rope(k.reshape(B, T, KH, hd), s, c, cfg.rope_style)
        v = v.reshape(B, T, KH, hd)

        k_cache, v_cache = k_all[li], v_all[li]  # views of layer li
        k_cache[b_idx, slots] = k.to(k_cache.dtype)
        v_cache[b_idx, slots] = v.to(v_cache.dtype)
        attn = attention_dense(q, k_cache, v_cache, positions, kv_len_mask)
        x = x + linear_layered(attn.reshape(B, T, H * hd), blocks["wo"], li,
                               mode=mode)

        h = rmsnorm(x, blocks["ffn_norm"][li], cfg.norm_eps)
        if "w13" in blocks:
            g13 = linear_layered(h, blocks["w13"], li, mode=mode)
            gate, up = g13[..., :hidden], g13[..., hidden:]
        else:
            gate = linear_layered(h, blocks["w1"], li, mode=mode)
            up = linear_layered(h, blocks["w3"], li, mode=mode)
        gf = gate.float()
        act = (gf * torch.sigmoid(gf)).to(x.dtype) * up
        x = x + linear_layered(act, blocks["w2"], li, mode=mode)

    if last_pos is not None:
        x = x[torch.arange(B, device=x.device), last_pos.long()][:, None]
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = linear(x, params["lm_head"], mode=mode).float()
    return logits, kv_cache


def prefill(cfg: ModelConfig, params, tokens, kv_cache, prompt_lens=None, *,
            rope=None, mode: str = "fast"):
    """Batched prefill of [B, T] prompts starting at position 0.

    prompt_lens: optional int [B] actual lengths (tokens beyond are padding).
    Returns (last_logits [B, vocab], kv_cache): logits at each row's final
    real token.
    """
    B, T = tokens.shape
    S = kv_cache["k"].shape[2]
    assert T <= S, (T, S)
    dev = tokens.device
    positions = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    if prompt_lens is None:
        prompt_lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    slot = torch.arange(S, dtype=torch.int32, device=dev)
    kv_len_mask = slot[None, :] < prompt_lens[:, None]
    logits, kv_cache = forward(cfg, params, tokens, positions, kv_cache,
                               kv_len_mask, last_pos=prompt_lens - 1,
                               rope=rope, mode=mode)
    return logits[:, 0], kv_cache


def decode_step(cfg: ModelConfig, params, token, pos, kv_cache,
                kv_len_mask=None, *, rope=None, mode: str = "fast"):
    """One batched decode step. token: int [B], pos: int [B] (each < S)."""
    logits, kv_cache = forward(cfg, params, token[:, None], pos[:, None],
                               kv_cache, kv_len_mask, rope=rope, mode=mode)
    return logits[:, 0], kv_cache
