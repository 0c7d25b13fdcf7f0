"""Batched GQA attention over a dense KV cache, in fp32.

One call handles [B, T] query tokens against the cache with causal and
length masking, covering prefill (T = prompt length) and decode (T = 1).
The JAX package leaves this to XLA, so the port keeps it as torch ops.
"""

import math

import torch

# Masked scores take a large finite negative value, not -inf: a padded
# prefill row whose mask is empty then softmaxes to a uniform row instead
# of NaN.
NEG_INF = -1e30

# Long-prompt prefill guard: the score tensor is [B, T, H, S] fp32. Above
# _BLOCK_THRESHOLD_BYTES the query axis is processed in _Q_BLOCK chunks; the
# T split is embarrassingly parallel, so only peak memory changes.
_Q_BLOCK = 256
_BLOCK_THRESHOLD_BYTES = 192 * 1024 * 1024


def attention_dense(q, k_cache, v_cache, q_positions, kv_len_mask=None,
                    q_block=None):
    """Attention of q against a dense cache where slot index == position.

    q:        [B, T, H, hd]
    k_cache:  [B, S, KH, hd]
    v_cache:  [B, S, KH, hd]
    q_positions: [B, T] int — absolute position of each query token.
    kv_len_mask: optional [B, S] bool — valid cache slots (the causal rule
      slot <= q_position always applies).
    q_block: query-axis block size for the memory-bounded path (None =
      auto: block only when the fp32 score tensor would exceed
      _BLOCK_THRESHOLD_BYTES and T divides evenly).

    Returns [B, T, H, hd] in q.dtype.
    """
    B, T, H, hd = q.shape
    S = k_cache.shape[1]
    if q_block is None:
        if (4 * B * T * H * S > _BLOCK_THRESHOLD_BYTES
                and T > _Q_BLOCK and T % _Q_BLOCK == 0):
            q_block = _Q_BLOCK
    if q_block and T > q_block and T % q_block == 0:
        outs = [
            _attention_full(q[:, i:i + q_block], k_cache, v_cache,
                            q_positions[:, i:i + q_block], kv_len_mask)
            for i in range(0, T, q_block)
        ]
        return torch.cat(outs, dim=1)
    return _attention_full(q, k_cache, v_cache, q_positions, kv_len_mask)


def _attention_full(q, k_cache, v_cache, q_positions, kv_len_mask=None):
    """Unblocked attention body (see attention_dense)."""
    B, T, H, hd = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    kv_mul = H // KH

    qf = q.reshape(B, T, KH, kv_mul, hd).float()
    kf = k_cache.float()
    vf = v_cache.float()
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("btkmh,bskh->btkms", qf, kf) * scale

    slot = torch.arange(S, device=q.device)
    mask = slot[None, None, :] <= q_positions[:, :, None]  # [B, T, S]
    if kv_len_mask is not None:
        mask = mask & kv_len_mask[:, None, :]
    scores = scores.masked_fill(~mask[:, :, None, None, :], NEG_INF)

    scores = scores - scores.amax(dim=-1, keepdim=True)
    probs = torch.exp(scores)
    probs = probs / probs.sum(dim=-1, keepdim=True)

    out = torch.einsum("btkms,bskh->btkmh", probs, vf)
    return out.reshape(B, T, H, hd).to(q.dtype)
