"""Llama-family decoder forward pass (Llama-2 / TinyLlama / Llama-3.x /
Qwen2.5), a port of kuiperllama_tpu/models/decoder.py.

  * per-layer weights stacked on a leading L axis; the layer loop indexes
    the stack (zero-copy views), so no weight is copied per layer;
  * one forward covers prefill (T = prompt length) and batched decode (T = 1);
  * fp32 softmax/norm accumulation, bf16 (configurable) activations;
  * head counts come from the weight shapes, not the config;
  * the dense KV cache [L, B, S, KH, hd] is updated IN PLACE (the JAX
    package returns a new cache; here that would copy gigabytes per step);
  * positions >= S are sentinels whose cache writes are DROPPED, as the JAX
    package's scatter with mode="drop" drops them: the serving engine's
    admit prefill passes S for the rows of live slots, and a done row that
    decodes past the cache writes nothing. Their rope row is clamped to the
    table's last, as JAX clamps the gather. On the card an out-of-range
    index would fail, so every slot is clamped to S - 1 and each write that
    lands there carries the value the slot must end with (`_drop_writes`),
    which needs no host sync: a CUDA graph can capture it. A caller whose
    positions all lie below S (the Generator) passes drop_past_end=False
    and skips it.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import ModelConfig
from ..ops.attention import attention_dense
from ..ops.linear import PREFILL_DEQUANT_ROWS, linear, linear_layered
from ..ops.rmsnorm import rmsnorm
from ..ops.rope import apply_rope, gather_rope, rope_cache
from ..parallel.collectives import all_gather, all_reduce, group_size
from ..quant import QuantTensor


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


def _heads(cfg, blocks):
    """(H, KH) from the weight shapes."""
    hd = cfg.head_dim
    if "wqkv" in blocks:
        H = blocks["wo"].shape[-2] // hd
        return H, (blocks["wqkv"].shape[-1] - H * hd) // (2 * hd)
    return blocks["wq"].shape[-1] // hd, blocks["wk"].shape[-1] // hd


def _qkv(cfg, blocks, li, x, s, c, B, T, mode="fast"):
    """Normed q, k, v of layer li for x [B, T, dim], roped; (q, k, v, H, KH).
    Shared with the paged decoder (models/paged.py)."""
    hd = cfg.head_dim
    H, KH = _heads(cfg, blocks)
    h = rmsnorm(x, blocks["attn_norm"][li], cfg.norm_eps)
    if "wqkv" in blocks:  # fused projection (fuse.py)
        qkv = linear_layered(h, blocks["wqkv"], li, blocks.get("bqkv"), mode=mode)
        q = qkv[..., : H * hd]
        k = qkv[..., H * hd: (H + KH) * hd]
        v = qkv[..., (H + KH) * hd:]
    else:
        q = linear_layered(h, blocks["wq"], li, blocks.get("bq"), mode=mode)
        k = linear_layered(h, blocks["wk"], li, blocks.get("bk"), mode=mode)
        v = linear_layered(h, blocks["wv"], li, blocks.get("bv"), mode=mode)
    q = apply_rope(q.reshape(B, T, H, hd), s, c, cfg.rope_style)
    k = apply_rope(k.reshape(B, T, KH, hd), s, c, cfg.rope_style)
    return q, k, v.reshape(B, T, KH, hd), H, KH


def partial_dtype(w, rows: int, act_dtype, group):
    """The dtype a row-parallel product of `rows` rows against `w` crosses
    `group` in. Where the INT8 kernels run (fewer than PREFILL_DEQUANT_ROWS
    rows), an fp32 x costs nothing: the kernel reads it as it reads bf16
    and returns its fp32 accumulation unrounded, so two or more ranks
    exchange fp32 partials and round to the activation dtype once, after
    the sum. Every other product (dense weights, the dequantized prefill
    matmul) is summed in the activation dtype, as the JAX package's psum
    sums it."""
    if (group_size(group) > 1 and isinstance(w, QuantTensor)
            and rows < PREFILL_DEQUANT_ROWS):
        return torch.float32
    return act_dtype


def _row_parallel(h, w, li, mode, group):
    """h @ layer li of a row-parallel weight, summed over `group` in
    `partial_dtype`'s dtype, in place on the fresh product."""
    dt = partial_dtype(w, h.numel() // h.shape[-1], h.dtype, group)
    return all_reduce(linear_layered(h.to(dt), w, li, mode=mode), group).to(h.dtype)


def _mlp_residual(cfg, blocks, li, x, attn_out, B, T, H, hd, mode="fast",
                  group=None, wo_reduce=True):
    """Attention output projection and SwiGLU MLP with residuals. Under
    tensor parallelism (`group`, the model axis's process group) wo and w2
    are row-parallel: their outputs are summed over the group before each
    residual add (`_row_parallel`). Sequence parallelism replicates wo
    (wo_reduce=False): only w2's sum remains."""
    a = attn_out.reshape(B, T, H * hd)
    x = x + (_row_parallel(a, blocks["wo"], li, mode, group) if wo_reduce
             else linear_layered(a, blocks["wo"], li, mode=mode))
    h = rmsnorm(x, blocks["ffn_norm"][li], cfg.norm_eps)
    if "w13" in blocks:  # fused gate|up projection (fuse.py)
        hidden = blocks["w2"].shape[-2]
        g13 = linear_layered(h, blocks["w13"], li, mode=mode)
        gate, up = g13[..., :hidden], g13[..., hidden:]
    else:
        gate = linear_layered(h, blocks["w1"], li, mode=mode)
        up = linear_layered(h, blocks["w3"], li, mode=mode)
    gf = gate.float()
    act = (gf * torch.sigmoid(gf)).to(x.dtype) * up
    return x + _row_parallel(act, blocks["w2"], li, mode, group)


def _drop_writes(cache, new, at_end, has_last, last_tok):
    """The values a T > 1 forward writes at its clamped slots [B, T] of one
    layer's cache [B, S, KH, hd], so that the write keeps the meaning of a
    scatter with mode="drop" for any mix of kept and dropped positions:
    a slot below S - 1 takes its token's K/V; every write that lands on slot
    S - 1 (`at_end`: the token at position S - 1 and each one past the end)
    carries what that slot must end with, the K/V of the row's token at
    position S - 1 where it has one (`has_last`, `last_tok`), else the
    slot's old value. Duplicate indices then all carry one value, so the
    write is exact in any order, and nothing syncs the host. Positions in a
    row are distinct."""
    B = new.shape[0]
    rows = torch.arange(B, device=new.device)
    new = new.to(cache.dtype)
    end = torch.where(has_last, new[rows, last_tok], cache[:, -1])  # [B, KH, hd]
    return torch.where(at_end[..., None, None], end[:, None], new)


def forward(cfg: ModelConfig, params, tokens, positions, kv_cache,
            kv_len_mask=None, last_pos=None, *, rope=None, mode: str = "fast",
            drop_past_end: bool = True, group=None):
    """Forward over [B, T] tokens.

    tokens:    int [B, T]
    positions: int [B, T] absolute positions (cache slot == position).
               A position >= S drops its cache write; with
               drop_past_end=False every position must be < S.
    kv_cache:  dict(k, v) [L, B, S, KH, hd]; written in place.
    kv_len_mask: optional [B, S] bool of valid slots for ragged batches.
    last_pos:  optional int [B] — compute logits only at this token index
               per row (prefill wants the final real token's logits).
    rope:      optional (sin, cos) from `build_rope`, to skip rebuilding it.
    mode:      "fast" | "exact" rounding of the INT8 matmul kernels.
    group:     the model axis's process group when params and cache are one
               rank's tensor-parallel slices (parallel/sharded.py): wo and w2
               are summed over it and the vocab-split logits gathered.

    Returns (logits fp32 [B, T_or_1, vocab], kv_cache).
    """
    B, T = tokens.shape
    hd = cfg.head_dim
    x = params["tok_emb"][tokens.long()]  # [B, T, dim] in weight dtype
    sin, cos = rope if rope is not None else build_rope(cfg, x.device)
    s, c = gather_rope(sin, cos, positions)  # [B, T, 1, hd/2]
    b_idx = torch.arange(B, device=x.device)[:, None]
    S = kv_cache["k"].shape[2]
    slots = positions.long()
    if drop_past_end and T == 1:
        keep = (slots < S)[..., None, None]
        slots = slots.clamp(max=S - 1)
    elif drop_past_end:
        last_slot = slots == S - 1
        has_last = last_slot.any(dim=1)[:, None, None]  # [B, 1, 1]
        last_tok = last_slot.to(torch.int32).argmax(dim=1)  # its token, or 0
        at_end = slots >= S - 1  # writes that land on slot S - 1
        slots = slots.clamp(max=S - 1)

    blocks = params["blocks"]
    k_all, v_all = kv_cache["k"], kv_cache["v"]

    for li in range(cfg.n_layers):
        q, k, v, H, KH = _qkv(cfg, blocks, li, x, s, c, B, T, mode)
        k_cache, v_cache = k_all[li], v_all[li]  # views of layer li
        if not drop_past_end:
            k_cache[b_idx, slots] = k.to(k_cache.dtype)
            v_cache[b_idx, slots] = v.to(v_cache.dtype)
        elif T == 1:
            k_cache[b_idx, slots] = torch.where(keep, k.to(k_cache.dtype),
                                                k_cache[b_idx, slots])
            v_cache[b_idx, slots] = torch.where(keep, v.to(v_cache.dtype),
                                                v_cache[b_idx, slots])
        else:
            k_cache[b_idx, slots] = _drop_writes(k_cache, k, at_end, has_last,
                                                 last_tok)
            v_cache[b_idx, slots] = _drop_writes(v_cache, v, at_end, has_last,
                                                 last_tok)
        attn = attention_dense(q, k_cache, v_cache, positions, kv_len_mask)
        x = _mlp_residual(cfg, blocks, li, x, attn, B, T, H, hd, mode, group)

    if last_pos is not None:
        x = x[torch.arange(B, device=x.device),
              last_pos.long().clamp(0, T - 1)][:, None]
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = linear(x, params["lm_head"], mode=mode).float()
    return all_gather(logits, group), kv_cache


def prefill(cfg: ModelConfig, params, tokens, kv_cache, prompt_lens=None, *,
            rope=None, mode: str = "fast", forward_fn=None):
    """Batched prefill of [B, T] prompts starting at position 0.

    prompt_lens: optional int [B] actual lengths (tokens beyond are padding).
    forward_fn: a callable with `forward`'s signature that runs in its place
      (parallel/sharded.py ShardedForward).
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
    logits, kv_cache = (forward_fn or forward)(
        cfg, params, tokens, positions, kv_cache, kv_len_mask,
        last_pos=prompt_lens - 1, rope=rope, mode=mode, drop_past_end=False)
    return logits[:, 0], kv_cache


def decode_step(cfg: ModelConfig, params, token, pos, kv_cache,
                kv_len_mask=None, *, rope=None, mode: str = "fast",
                drop_past_end: bool = True, forward_fn=None):
    """One batched decode step. token: int [B], pos: int [B] (a position
    >= S drops its cache write, see `forward`). forward_fn: as in
    `prefill`."""
    fwd = forward_fn or forward
    logits, kv_cache = fwd(cfg, params, token[:, None], pos[:, None],
                           kv_cache, kv_len_mask, rope=rope, mode=mode,
                           drop_past_end=drop_past_end)
    return logits[:, 0], kv_cache
