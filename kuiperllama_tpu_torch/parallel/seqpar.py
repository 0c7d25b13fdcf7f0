"""Sequence-parallel (split-K) paged decode attention, a port of
kuiperllama_tpu/parallel/seqpar.py.

Under kv-head tensor parallelism every rank still reads every page of every
sequence. For long contexts the split is along the sequence: the page pool
is block-split over its page dim, each rank runs the paged flash-decode
kernel over only its own pages, producing the kernel's unnormalised flash
statistics, and the partials merge exactly (merge_flash_many). The
attention weights are whole on every rank (it writes complete lanes into
its own pages and contributes full-head statistics), which also lifts the
lane rule that caps lane-split TP for hd = 64 families at tp = 1, and
n_heads need not divide the rank count.

Host side: `build_work_lists_sharded` partitions the global page walk by
page ownership and records which rows each rank covers; rows a rank does
not cover are set to the flash identity before the merge.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kvcache import init_paged_cache
from ..models.paged import merge_shards
from ..ops.kernels.paged_attention import paged_attention_flat
from .mesh import MODEL_AXIS
from .sharded_paged import ShardedPagedStep
from .shardings import validate_seqpar


def build_work_lists_sharded(page_table, seq_lens, page_size: int, n_shards: int,
                             n_pages: int, pad_to: int = 0):
    """Partition the flat page walk by page ownership.

    page_table [B, max_pages] GLOBAL page ids; rank s owns the global pages
    [s Pl, (s+1) Pl), Pl = n_pages / n_shards, and indexes them LOCALLY as
    global - s Pl.

    Returns (flat_b [S, M], flat_page_local [S, M], flat_tok0 [S, M],
    n_items [S, 1], covered [S, B] bool) int32 numpy arrays, each rank's
    list padded by repeating its last item to a common M: the longest
    list (at least 1), or `pad_to` when that is larger (a fixed M keeps a
    CUDA graph's metadata buffer one size)."""
    B, max_pages = page_table.shape
    if n_pages % n_shards:
        raise ValueError(f"{n_pages} pages do not split over {n_shards} ranks")
    pl = n_pages // n_shards
    per = [([], [], []) for _ in range(n_shards)]
    covered = np.zeros((n_shards, B), bool)
    for b in range(B):
        n = -(-int(seq_lens[b]) // page_size) if seq_lens[b] > 0 else 0
        for pi in range(n):
            g = int(page_table[b, pi])
            s = g // pl
            per[s][0].append(b)
            per[s][1].append(g - s * pl)
            per[s][2].append(pi * page_size)
            covered[s, b] = True
    M = max(1, pad_to, max(len(p[0]) for p in per))
    fb, fp, ft = (np.zeros((n_shards, M), np.int32) for _ in range(3))
    ni = np.zeros((n_shards, 1), np.int32)
    for s, (bs, ps_, ts) in enumerate(per):
        ni[s, 0] = len(bs)
        if bs:  # pad by repeating the last item (the kernel stops at n_items)
            pad = M - len(bs)
            fb[s], fp[s], ft[s] = (a + [a[-1]] * pad for a in (bs, ps_, ts))
    return fb, fp, ft, ni, covered


def _owned_block(pool, mesh):
    """This rank's contiguous block of the page dim (axis -3) of a pool."""
    n = pool.shape[-3] // mesh.tp
    return pool.narrow(-3, mesh.tp_rank * n, n).contiguous()


class SeqParAttention:
    """Sequence-parallel paged decode attention over the mesh's model axis:
    __call__ has paged_attention's semantics (normalised output), but each
    rank reads only its own pages (`shard_pages`) and one all-gather of the
    statistics merges them."""

    def __init__(self, mesh, page_size: int = 128):
        self.mesh = mesh
        self.page_size = page_size
        self.sp = mesh.shape[MODEL_AXIS]

    def shard_pages(self, k_pages, v_pages):
        return _owned_block(k_pages, self.mesh), _owned_block(v_pages, self.mesh)

    def __call__(self, q, k_pages, v_pages, page_table, seq_lens):
        """q [B, H, hd]; k/v_pages this rank's [P / sp, ps, KH*hd];
        page_table (GLOBAL ids) and seq_lens host numpy. Returns [B, H, hd]
        in q.dtype."""
        n_pages = k_pages.shape[0] * self.sp
        sl = np.asarray(seq_lens, np.int32)
        fb, fp, ft, ni, cov = build_work_lists_sharded(
            np.asarray(page_table), sl, self.page_size, self.sp, n_pages)
        r, dev = self.mesh.tp_rank, q.device
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        acc, m, l = paged_attention_flat(q, k_pages, v_pages, t(fb[r]), t(fp[r]),
                                         t(ft[r]), t(ni[r]), t(sl),
                                         page_size=self.page_size)
        # the merge decode_step_paged runs (models/paged.py)
        out = merge_shards(self.mesh.model_group, acc, m, l, t(cov[r])[:, None])
        return out.to(q.dtype)


class SeqParPagedStep(ShardedPagedStep):
    """Sequence-parallel counterpart of ShardedPagedStep: the pools
    [L, P, ps, KH*hd] are block-split over the page dim with FULL lanes on
    every rank, the attention weights are whole, the MLP Megatron-split and
    lm_head vocab-split (shard_params(seqpar=True)). Each rank's decode
    kernel walks only its own pages (`build_lists`), and one all-gather of
    the flash statistics per layer merges them exactly. The allocator must
    reserve the global pages {s P_local}, each rank's local page 0, as its
    garbage page: PagedEngine(seqpar=True) does. Chunked prefill composes:
    each rank scores only the history pages it owns and the partials merge
    exactly (models/paged.prefill_chunk_paged)."""

    seqpar = True

    @staticmethod
    def _validate(cfg, n, g):
        validate_seqpar(cfg, n, g)

    @property
    def sp(self) -> int:
        return self.mesh.tp

    def build_lists(self, page_table, seq_lens, page_size: int, n_pages: int):
        """Every rank's work list and covered rows for a decode chunk (LOCAL
        page ids), each padded to page_table.size items."""
        return build_work_lists_sharded(page_table, seq_lens, page_size, self.sp,
                                        n_pages, pad_to=page_table.size)

    def shard_pages(self, k_pages, v_pages):
        return _owned_block(k_pages, self.mesh), _owned_block(v_pages, self.mesh)

    def init_pages(self, n_pages: int, page_size: int, dtype, device):
        """Zeroed pools of this rank's block: n_pages / sp full-lane pages."""
        cache = init_paged_cache(self.cfg, n_pages // self.sp, page_size, dtype,
                                 device=device)
        return cache.k_pages, cache.v_pages
