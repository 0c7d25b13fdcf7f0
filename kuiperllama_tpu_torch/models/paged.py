"""Decoder forward over the paged KV cache, a port of
kuiperllama_tpu/models/paged.py (single device).

  * prefill_paged: a batch of prompts from position 0, causal attention over
    each prompt's own K/V, which is then written into its pages;
  * prefill_packed_paged: the same prompts packed into one ragged token
    stream, padded only to the stream's own length (the single-device
    engine's admission prefill);
  * prefill_chunk_paged: one C-token chunk of a chunked prefill, attending
    to the row's earlier context gathered from its pages and, causally, to
    the chunk itself;
  * decode_step_paged: one decode step of the whole batch, in place on a
    DecodeState, appending the new token's K/V to its page and running the
    paged flash-decode kernel (ops/kernels/paged_attention.py) once per
    layer; run_chunk_paged runs `steps` of them, eagerly or as replays of
    a CUDA graph of the step (serving/graphs.py), and
    decode_chunk_paged(_packed) is the JAX package's functional form.

The pools k_pages, v_pages [L, P, ps, KH*hd] are updated IN PLACE and
returned (the JAX package donates them to each call instead). Out-of-range
pages (the 2**30 padding sentinel) are redirected to the garbage page 0.
The scheduler (serving/engine.py) owns the page tables and pre-extends each
row's pages to cover a whole decode chunk; slots not yet written are masked
by seq_lens inside the kernel.

Parallel hooks, as the JAX bodies take `tp_axis` (parallel/sharded_paged.py,
parallel/seqpar.py): `group` is the model axis's process group. Tensor
parallelism: weights are this rank's Megatron slices and the pools its
block of kv-head lanes; wo and w2 are summed over the group and the
vocab-split logits gathered; page tables and work lists stay global.
seqpar=True: the pools are this rank's block of pages (global page g lives
on rank g // P_local as local page g % P_local; a write to a page it does
not own goes to its local garbage page 0), the attention weights are whole,
each rank's flash statistics cover only its pages and are gathered and
merged exactly, and only w2 is summed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModelConfig
from ..kvcache import sink_pages
from ..ops.attention import (attention_dense, attention_dense_parts,
                             attention_packed, packed_tiles)
from ..ops.kernels.paged_attention import merge_flash_many, paged_attention_flat
from ..ops.linear import linear
from ..ops.rmsnorm import rmsnorm
from ..ops.rope import gather_rope
from ..ops.sampling import DecodeState
from ..parallel.collectives import all_gather, group_rank
from ..serving.graphs import run_steps
from .decoder import _mlp_residual, _qkv, build_rope

# A measurement switch, the JAX package's: the decode step skips its page
# writes, so that tools/profile_paged.py can time them apart. Read at call
# time (a graph captured with it set keeps skipping). Never set in serving.
_DEBUG_SKIP_WRITES = False


def _write_chunk_pages(li, kp_all, vp_all, k2, v2, chunk_pages, ps):
    """Write [B, T, kv_dim] K/V of layer li into pages, in place.

    chunk_pages [B, n_chunks] (long, already redirected into range) is the
    physical page of each ps-wide chunk of the T axis; every chunk starts at
    in-page offset 0. A partial tail chunk (T not a page multiple) fills the
    first T % ps slots of its page. Several chunks redirected to page 0
    write it in an undefined order, which is harmless for the sink."""
    B, T, kv_dim = k2.shape
    n_chunks = chunk_pages.shape[1]
    n_full = min(T // ps, n_chunks)
    tail = T - n_full * ps if n_full < n_chunks else 0
    if n_full:
        pages = chunk_pages[:, :n_full]
        kp_all[li][pages] = k2[:, : n_full * ps].reshape(B, n_full, ps, kv_dim)
        vp_all[li][pages] = v2[:, : n_full * ps].reshape(B, n_full, ps, kv_dim)
    if tail:
        page = chunk_pages[:, n_full][:, None]  # [B, 1]
        offs = torch.arange(tail, device=k2.device)[None]  # [1, tail]
        kp_all[li][page, offs] = k2[:, n_full * ps: n_full * ps + tail]
        vp_all[li][page, offs] = v2[:, n_full * ps: n_full * ps + tail]


def _final_logits(cfg, params, x_last, mode, group=None):
    x_last = rmsnorm(x_last, params["final_norm"], cfg.norm_eps)
    return all_gather(linear(x_last, params["lm_head"], mode=mode).float(), group)


def _owned(pages: torch.Tensor, n_local: int, shard: int) -> torch.Tensor:
    """Seqpar: local ids of the global pages this rank owns, the garbage
    page 0 for every other (the 2**30 sentinel included)."""
    return torch.where(pages // n_local == shard, pages % n_local,
                       torch.zeros_like(pages))


def merge_shards(group, acc, m, l, covered=None, extra=None):
    """Seqpar's exact merge of every rank's flash partials (acc [..., hd],
    m, l): rows this rank does not cover (`covered` [B, 1] bool, None for
    all) are first set to the flash identity, then the group's (acc, m, l),
    packed as one [..., hd + 2] fp32 tensor, are gathered, `extra` (a
    replicated partial) is stacked after them, and the normalised output is
    returned."""
    if covered is not None:
        dev = acc.device
        acc = torch.where(covered[..., None], acc, torch.zeros((), device=dev))
        m = torch.where(covered, m, torch.full((), -1e30, device=dev))
        l = torch.where(covered, l, torch.zeros((), device=dev))
    hd = acc.shape[-1]
    parts = all_gather(torch.cat([acc, m[..., None], l[..., None]], dim=-1)[None],
                       group, dim=0)
    pa, pm, pl = parts[..., :hd], parts[..., hd], parts[..., hd + 1]
    if extra is not None:
        pa = torch.cat([pa, extra[0][None]])
        pm = torch.cat([pm, extra[1][None]])
        pl = torch.cat([pl, extra[2][None]])
    return merge_flash_many(pa, pm, pl, axis=0)


@torch.no_grad()
def prefill_paged(cfg: ModelConfig, params, tokens, prompt_lens, k_pages,
                  v_pages, token_pages, token_offs=None, *, rope=None,
                  mode: str = "fast", group=None, seqpar: bool = False):
    """Batched prefill of admitted prompts from position 0.

    tokens [B, T]; prompt_lens [B]; token_pages [B, T] maps each prompt
    position to its physical page (2**30 for padding rows and slots: those
    writes go to the garbage page 0). token_offs is accepted for the JAX
    signature: positions start at 0, so a position's in-page offset is
    position % ps. In-chunk slots past a prompt's end are written into the
    row's own page at future decode offsets; decode overwrites them before
    they become visible, and the kernel masks them by seq_lens meanwhile.
    Returns (last_logits [B, vocab] fp32, k_pages, v_pages)."""
    B, T = tokens.shape
    hd = cfg.head_dim
    dev = tokens.device
    x = params["tok_emb"][tokens.long()]
    sin, cos = rope if rope is not None else build_rope(cfg, dev)
    positions = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    s, c = gather_rope(sin, cos, positions)
    kv_mask = (torch.arange(T, device=dev)[None] < prompt_lens[:, None])
    ps, P = k_pages.shape[2], k_pages.shape[1]
    chunk_pages = token_pages[:, ::ps].long()
    chunk_pages = (_owned(chunk_pages, P, group_rank(group)) if seqpar
                   else sink_pages(chunk_pages, P))
    blocks = params["blocks"]
    for li in range(cfg.n_layers):
        q, k, v, H, KH = _qkv(cfg, blocks, li, x, s, c, B, T, mode)
        attn = attention_dense(q, k, v, positions, kv_mask)
        _write_chunk_pages(li, k_pages, v_pages,
                           k.reshape(B, T, KH * hd).to(k_pages.dtype),
                           v.reshape(B, T, KH * hd).to(v_pages.dtype),
                           chunk_pages, ps)
        x = _mlp_residual(cfg, blocks, li, x, attn, B, T, H, hd, mode, group,
                          wo_reduce=not seqpar)
    last = (prompt_lens.long() - 1).clamp(0, T - 1)
    x_last = x[torch.arange(B, device=dev), last]
    return _final_logits(cfg, params, x_last, mode, group), k_pages, v_pages


def pack_prompts(prompts, page_rows, n: int, rows: int, page_size: int):
    """The host-side inputs of prefill_packed_paged for `prompts` (lists of
    ids, in admit order) whose tokens go to the pages of `page_rows` (a
    page-table row each): int32 (tokens [1, n], positions [n], segments
    [n], token_pages [n], last_idx [rows]), the stream padded to n tokens
    (segment -1, the 2**30 page sentinel) and last_idx to `rows` entries."""
    tokens = np.zeros((1, n), np.int32)
    positions = np.zeros((n,), np.int32)
    segments = np.full((n,), -1, np.int32)
    pages = np.full((n,), 2 ** 30, np.int32)
    last = np.zeros((rows,), np.int32)
    o = 0
    for i, (ids, row) in enumerate(zip(prompts, page_rows)):
        m = len(ids)
        pos = np.arange(m)
        tokens[0, o:o + m] = ids
        positions[o:o + m] = pos
        segments[o:o + m] = i
        pages[o:o + m] = np.asarray(row)[pos // page_size]
        last[i] = o + m - 1
        o += m
    return tokens, positions, segments, pages, last


@torch.no_grad()
def prefill_packed_paged(cfg: ModelConfig, params, tokens, positions, segments,
                         token_pages, last_idx, k_pages, v_pages, max_len: int, *,
                         rope=None, mode: str = "fast"):
    """Prefill of admitted prompts packed into ONE token stream: the real
    tokens of every prompt, back to back, and padding only up to the
    stream's length N.

    tokens [1, N]; positions [N] each token's position inside its own
    prompt; segments [N] its prompt's admit row (-1 for padding);
    token_pages [N] its physical page (2**30 for padding: those writes go to
    the garbage page 0); last_idx [R] the stream index of each admit row's
    last token (any index for rows past the admitted ones). Every prompt is
    shorter than `max_len`, which bounds the keys a query tile of the
    attention reads (ops/attention.py `packed_tiles`).

    Embedding, projections, rope, norms and the MLP are row-wise and run on
    [1, N] as on [B, T]; the INT8 projections take the route of N rows. Each
    token's K/V go to (page, position % ps); unlike prefill_paged, nothing
    past a prompt's end is written. The lm_head runs on the R gathered
    last tokens. Returns (last_logits [R, vocab] fp32, k_pages, v_pages)."""
    _, N = tokens.shape
    hd = cfg.head_dim
    dev = tokens.device
    x = params["tok_emb"][tokens.long()]
    sin, cos = rope if rope is not None else build_rope(cfg, dev)
    s, c = gather_rope(sin, cos, positions[None])
    pages = sink_pages(token_pages.long(), k_pages.shape[1])
    offs = positions.long() % k_pages.shape[2]
    tiles = packed_tiles(positions, segments, max_len)
    blocks = params["blocks"]
    for li in range(cfg.n_layers):
        q, k, v, H, KH = _qkv(cfg, blocks, li, x, s, c, 1, N, mode)
        k_pages[li, pages, offs] = k.reshape(N, KH * hd).to(k_pages.dtype)
        v_pages[li, pages, offs] = v.reshape(N, KH * hd).to(v_pages.dtype)
        attn = attention_packed(q[0], k[0], v[0], tiles)
        x = _mlp_residual(cfg, blocks, li, x, attn[None], 1, N, H, hd, mode)
    x_last = x[0, last_idx.long()]
    return _final_logits(cfg, params, x_last, mode), k_pages, v_pages


@torch.no_grad()
def prefill_chunk_paged(cfg: ModelConfig, params, tokens_chunk, chunk_start,
                        row_lens, k_pages, v_pages, chunk_pages, hist_pages, *,
                        rope=None, mode: str = "fast", group=None,
                        seqpar: bool = False):
    """One C-token chunk of a chunked prefill (C a multiple of the page size).

    tokens_chunk [B, C]; chunk_start: absolute position of chunk token 0
    (the same for every row of the admission wave), an int or a 0-d int
    tensor on the device, which JAX traces: a CUDA graph of the chunk then
    serves every chunk start (serving/engine.py); row_lens [B] prompt
    lengths (rows that ended before chunk_start write to the garbage page
    through sentinel chunk_pages, and their logits are not selected);
    chunk_pages [B, C/ps] physical page per page slot of the chunk (2**30 for
    padding); hist_pages [B, n_hist] pages of the earlier context (pad
    entries read page 0 and are masked by chunk_start and row_lens).

    Returns (logits [B, vocab] at each row's last prompt token when it falls
    in this chunk, else at a clamped slot; ends_here [B] bool; k_pages;
    v_pages)."""
    B, C = tokens_chunk.shape
    hd = cfg.head_dim
    dev = tokens_chunk.device
    L, P, ps = k_pages.shape[0], k_pages.shape[1], k_pages.shape[2]
    if C % ps:
        raise ValueError(f"prefill_chunk_paged: chunk {C} is not a multiple "
                         f"of the page size {ps}")
    chunk_start = torch.as_tensor(chunk_start, device=dev).long()
    n_hist = hist_pages.shape[1]
    S_hist = n_hist * ps
    row_lens = row_lens.long()

    x = params["tok_emb"][tokens_chunk.long()]
    sin, cos = rope if rope is not None else build_rope(cfg, dev)
    abs_pos = chunk_start + torch.arange(C, device=dev)
    s, c = gather_rope(sin, cos, abs_pos.expand(B, C))
    if seqpar:
        # each rank writes and scores only the pages it owns; the history
        # pages it does not own read its garbage page and are masked
        shard = group_rank(group)
        cp = _owned(chunk_pages.long(), P, shard)
        hist_owned = (hist_pages.long() // P == shard) & (hist_pages >= 0)
        hp = _owned(hist_pages.long(), P, shard)
    else:
        cp = sink_pages(chunk_pages.long(), P)
        hp = sink_pages(hist_pages.long(), P)

    # attention layout [history (S_hist) | chunk (C)]: history slots precede
    # every chunk query, so the causal rule on layout positions is right
    q_layout_pos = (S_hist + torch.arange(C, device=dev)).expand(B, C)
    hist_valid = (torch.arange(S_hist, device=dev)[None]
                  < torch.minimum(row_lens, chunk_start)[:, None])
    chunk_valid = abs_pos[None] < row_lens[:, None]
    kv_mask = torch.cat([hist_valid, chunk_valid], dim=1)

    blocks = params["blocks"]
    for li in range(cfg.n_layers):
        q, k, v, H, KH = _qkv(cfg, blocks, li, x, s, c, B, C, mode)
        _write_chunk_pages(li, k_pages, v_pages,
                           k.reshape(B, C, KH * hd).to(k_pages.dtype),
                           v.reshape(B, C, KH * hd).to(v_pages.dtype), cp, ps)
        if S_hist:
            k_hist = k_pages[li][hp].reshape(B, S_hist, KH, hd).to(k.dtype)
            v_hist = v_pages[li][hp].reshape(B, S_hist, KH, hd).to(v.dtype)
            if seqpar:
                # this rank's history partials, gathered, merged exactly with
                # the chunk's causal part (computed alike on every rank)
                own = hist_owned.repeat_interleave(ps, dim=1)
                hist = attention_dense_parts(q, k_hist, v_hist, q_layout_pos,
                                             hist_valid & own)
                rel = torch.arange(C, device=dev).expand(B, C)
                chunk = attention_dense_parts(q, k, v, rel, chunk_valid)
                attn = merge_shards(group, *hist, extra=chunk).to(q.dtype)
            else:
                attn = attention_dense(q, torch.cat([k_hist, k], dim=1),
                                       torch.cat([v_hist, v], dim=1),
                                       q_layout_pos, kv_mask)
        else:
            attn = attention_dense(q, k, v, q_layout_pos, kv_mask)
        x = _mlp_residual(cfg, blocks, li, x, attn, B, C, H, hd, mode, group,
                          wo_reduce=not seqpar)
    last_rel = (row_lens - 1 - chunk_start).clamp(0, C - 1)
    x_last = x[torch.arange(B, device=dev), last_rel]
    logits = _final_logits(cfg, params, x_last, mode, group)
    ends_here = (row_lens - 1 >= chunk_start) & (row_lens - 1 < chunk_start + C)
    return logits, ends_here, k_pages, v_pages


def decode_step_paged(cfg: ModelConfig, params, state: DecodeState, k_pages,
                      v_pages, meta, generator=None, page_size: int = 128,
                      temperature: float = 0.0, top_k: int = 0,
                      top_p: float = 1.0, *, rope=None, mode: str = "fast",
                      group=None, seqpar: bool = False):
    """One decode step of the whole batch over the paged cache, IN PLACE:
    each row's new K/V rows land in its page, the paged flash-decode kernel
    runs once per layer, and `state` (token, pos, done, the chunk's token
    block) advances. meta = (page_table [B, max_pages], flat_b, flat_page,
    flat_tok0, n_items): int32 device tensors, read, never written. With
    seqpar, the work list is this rank's (local page ids,
    parallel/seqpar.build_work_lists_sharded) and meta ends with covered
    [B] int32, the rows it touches."""
    page_table_dev, flat_b, flat_page, flat_tok0, n_items = meta[:5]
    token, pos = state.token, state.pos
    B = token.shape[0]
    hd = cfg.head_dim
    dev = token.device
    sin, cos = rope if rope is not None else build_rope(cfg, dev)
    b_idx = torch.arange(B, device=dev)
    blocks = params["blocks"]
    pt = page_table_dev.long()
    max_pages = pt.shape[1]
    x = params["tok_emb"][token.long()][:, None]  # [B, 1, dim]
    s, c = gather_rope(sin, cos, pos[:, None])
    seq_lens = (pos + 1).to(torch.int32)
    pos_l = pos.long()
    write_page = pt[b_idx, (pos_l // page_size).clamp(max=max_pages - 1)]
    if seqpar:
        write_page = _owned(write_page, k_pages.shape[1], group_rank(group))
        covered = meta[5].bool()[:, None]
    else:
        write_page = sink_pages(write_page, k_pages.shape[1])
    write_off = pos_l % page_size
    for li in range(cfg.n_layers):
        q, k, v, H, KH = _qkv(cfg, blocks, li, x, s, c, B, 1, mode)
        # retired slots' page-table rows are 0, the garbage page: several
        # such rows write it in an undefined order, which is harmless
        if not _DEBUG_SKIP_WRITES:
            k_pages[li, write_page, write_off] = k.reshape(B, KH * hd).to(k_pages.dtype)
            v_pages[li, write_page, write_off] = v.reshape(B, KH * hd).to(v_pages.dtype)
        acc, m, l = paged_attention_flat(
            q[:, 0].contiguous(), k_pages, v_pages, flat_b, flat_page,
            flat_tok0, n_items, seq_lens, page_size=page_size, layer_idx=li)
        if seqpar:  # rows this rank's list does not touch: the identity
            attn = merge_shards(group, acc, m, l, covered).to(x.dtype)
        else:
            attn = (acc / torch.clamp(l[..., None], min=1e-30)).to(x.dtype)
        x = _mlp_residual(cfg, blocks, li, x, attn[:, None], B, 1, H, hd, mode,
                          group, wo_reduce=not seqpar)
    logits = _final_logits(cfg, params, x[:, 0], mode, group)
    state.emit(logits, generator, temperature, top_k, top_p)


@torch.no_grad()
def run_chunk_paged(cfg: ModelConfig, params, state: DecodeState, k_pages,
                    v_pages, generator, meta, steps: int, page_size: int = 128,
                    temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                    *, rope=None, mode: str = "fast", graphs=None, group=None,
                    seqpar: bool = False, mesh_key=None):
    """`steps` calls of `decode_step_paged` on `state`, eagerly or through
    `graphs` (serving/graphs.py), keyed as the JAX package keys its jitted
    chunk: (B, max_pages, sampling, mode), with the pools' dtype and the
    page size, and `mesh_key` (parallel/mesh.py Mesh.key) with group.
    Returns the chunk's tokens [B, steps] (a view of state.toks)."""
    B, max_pages = meta[0].shape

    def step():
        decode_step_paged(cfg, params, state, k_pages, v_pages, meta, generator,
                          page_size, temperature, top_k, top_p, rope=rope,
                          mode=mode, group=group, seqpar=seqpar)

    key = ("paged", B, max_pages, k_pages.dtype, page_size, temperature, top_k,
           top_p, mode, seqpar, mesh_key)
    return run_steps(state, step, steps, graphs, key,
                     (k_pages, v_pages, *meta, *(rope or ())), rng=temperature > 0)


@torch.no_grad()
def decode_chunk_paged(cfg: ModelConfig, params, token, pos, k_pages, v_pages,
                       done, generator, stop_ids, page_table_dev, flat_b,
                       flat_page, flat_tok0, n_items, steps: int,
                       page_size: int = 128, temperature: float = 0.0,
                       top_k: int = 0, top_p: float = 1.0, *, rope=None,
                       mode: str = "fast", group=None, seqpar: bool = False,
                       covered=None):
    """Run `steps` decode iterations over the paged cache.

    token/pos/done: [B] current state on the device (not written: the steps
    run on copies). page_table_dev [B, max_pages] int locates the write page
    of each new token; a row that decodes up to max_len inside a chunk
    reaches pos // ps == max_pages, whose index is clamped to the last page
    as JAX clamps the gather. The work list must cover each row's pages up
    to pos + steps (the scheduler pre-extends them); unwritten slots are
    masked by seq_lens = pos + 1. Finished rows (done) keep their token and
    position. `generator` is the torch.Generator of the sampling draws.
    group, seqpar: as in `decode_step_paged`; with seqpar, `covered` [B]
    marks the rows this rank's work list touches.

    Returns (tokens int32 [B, steps], token, pos, k_pages, v_pages, done)."""
    state = DecodeState(token.clone(), pos.clone(), done.clone(), stop_ids, steps)
    meta = (page_table_dev, flat_b, flat_page, flat_tok0, n_items)
    if seqpar:
        meta += (covered.to(torch.int32),)
    toks = run_chunk_paged(
        cfg, params, state, k_pages, v_pages, generator, meta, steps,
        page_size, temperature, top_k, top_p, rope=rope, mode=mode, group=group,
        seqpar=seqpar)
    return toks, state.token, state.pos, k_pages, v_pages, state.done


def pack_chunk_meta(pt, fb, fp, ft, ni, covered=None) -> np.ndarray:
    """The per-chunk scheduler arrays (page table and flat work list, and
    seqpar's covered rows) packed into ONE int32 vector, so a decode chunk
    costs one host-to-device copy."""
    extra = [] if covered is None else [np.asarray(covered, np.int32).ravel()]
    return np.concatenate([
        np.asarray(pt, np.int32).ravel(), np.asarray(fb, np.int32),
        np.asarray(fp, np.int32), np.asarray(ft, np.int32),
        np.asarray([int(np.asarray(ni).reshape(-1)[0])], np.int32), *extra])


def unpack_chunk_meta(packed, shapes, covered: bool = False):
    """The (page_table [B, max_pages], flat_b, flat_page, flat_tok0,
    n_items[, covered [B]]) views of a packed vector; shapes = (B,
    max_pages, M)."""
    B, MP, M = shapes
    o = B * MP
    meta = (packed[:o].view(B, MP), packed[o: o + M], packed[o + M: o + 2 * M],
            packed[o + 2 * M: o + 3 * M], packed[o + 3 * M: o + 3 * M + 1])
    if covered:
        meta += (packed[o + 3 * M + 1: o + 3 * M + 1 + B],)
    return meta


def decode_chunk_paged_packed(cfg: ModelConfig, params, token, pos, k_pages,
                              v_pages, done, generator, stop_ids, packed,
                              shapes, steps: int, page_size: int = 128,
                              temperature: float = 0.0, top_k: int = 0,
                              top_p: float = 1.0, *, rope=None,
                              mode: str = "fast"):
    """decode_chunk_paged with the scheduler metadata as ONE packed int32
    device vector (pack_chunk_meta); shapes = (B, max_pages, M). The pieces
    are views of it (`unpack_chunk_meta`)."""
    return decode_chunk_paged(
        cfg, params, token, pos, k_pages, v_pages, done, generator, stop_ids,
        *unpack_chunk_meta(packed, shapes), steps=steps, page_size=page_size,
        temperature=temperature, top_k=top_k, top_p=top_p, rope=rope, mode=mode)
