"""Batched GQA attention over a dense KV cache, in fp32.

One call handles [B, T] query tokens against the cache with causal and
length masking, covering prefill (T = prompt length) and decode (T = 1).
`attention_packed` is the same arithmetic over one packed stream of
several prompts (models/paged.py `prefill_packed_paged`). The JAX package
leaves this to XLA, so the port keeps it as torch ops.
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


def attention_dense_parts(q, k_cache, v_cache, q_positions, kv_len_mask=None):
    """attention_dense, returning the UNNORMALISED flash partials instead of
    the softmax output (a port of the JAX `attention_dense_parts`):
    acc [B, T, H, hd], m [B, T, H], l [B, T, H], all fp32. A rank scores
    its own slice of the keys and the partials merge exactly
    (ops/kernels/paged_attention.merge_flash_many): sequence-parallel
    chunked prefill. A row whose mask is empty gives the flash identity
    (acc 0, m NEG_INF, l 0) and vanishes in the merge."""
    B, T, H, hd = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    kv_mul = H // KH
    qf = q.reshape(B, T, KH, kv_mul, hd).float()
    scores = torch.einsum("btkmh,bskh->btkms", qf, k_cache.float()) * (1.0 / math.sqrt(hd))
    slot = torch.arange(S, device=q.device)
    mask = slot[None, None, :] <= q_positions[:, :, None]
    if kv_len_mask is not None:
        mask = mask & kv_len_mask[:, None, :]
    mask5 = mask[:, :, None, None, :]
    scores = scores.masked_fill(~mask5, NEG_INF)
    m = scores.amax(dim=-1)
    # exp(NEG_INF - NEG_INF) = 1 on an empty row: zero it explicitly
    p = torch.where(mask5, torch.exp(scores - m[..., None]), torch.zeros((), device=q.device))
    l = p.sum(dim=-1)
    acc = torch.einsum("btkms,bskh->btkmh", p, v_cache.float())
    return acc.reshape(B, T, H, hd), m.reshape(B, T, H), l.reshape(B, T, H)


def packed_tiles(positions, segments, max_len: int, q_tile=_Q_BLOCK):
    """The query tiles of a packed stream for `attention_packed`: a list of
    (t0, t1, k0, mask), where tile [t0, t1) of the N queries sees the keys
    [k0, t1) and mask [t1 - t0, t1 - k0] bool says which of them it
    attends to: a key of the same segment at a position <= the query's.

    positions, segments [N] int: each token's position inside its own
    prompt and its prompt's index (-1 for padding), prompts contiguous and
    in order. Every prompt is shorter than `max_len`, so a tile needs at
    most the max_len keys before it: k0 = max(0, t0 - max_len); a stream
    of at most max_len tokens is seen whole up to each tile's end. The
    shapes depend on N, max_len and q_tile alone, so a CUDA graph of one N
    serves every mix of prompts."""
    N = positions.shape[0]
    pos, seg = positions.long(), segments.long()
    tiles = []
    for t0 in range(0, N, q_tile):
        t1 = min(t0 + q_tile, N)
        k0 = max(0, t0 - max_len)
        mask = ((seg[k0:t1][None] == seg[t0:t1, None])
                & (pos[k0:t1][None] <= pos[t0:t1, None]))
        tiles.append((t0, t1, k0, mask))
    return tiles


def attention_packed(q, k, v, tiles):
    """Causal attention inside each prompt of a packed stream, tile by
    query tile (`packed_tiles`), with `_attention_full`'s fp32 arithmetic
    and NEG_INF: a key a query does not see contributes exactly 0, so each
    prompt's rows equal its own dense attention up to summation order.

    q [N, H, hd]; k, v [N, KH, hd]. Returns [N, H, hd] in q.dtype."""
    N, H, hd = q.shape
    KH = k.shape[1]
    kv_mul = H // KH
    kf, vf = k.float(), v.float()
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for t0, t1, k0, mask in tiles:
        qf = q[t0:t1].reshape(t1 - t0, KH, kv_mul, hd).float()
        scores = torch.einsum("tkmh,skh->tkms", qf, kf[k0:t1]) * scale
        scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
        scores = scores - scores.amax(dim=-1, keepdim=True)
        probs = torch.exp(scores)
        probs = probs / probs.sum(dim=-1, keepdim=True)
        outs.append(torch.einsum("tkms,skh->tkmh", probs, vf[k0:t1]))
    return torch.cat(outs).reshape(N, H, hd).to(q.dtype)
