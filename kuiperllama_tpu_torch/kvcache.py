"""Paged KV cache, a port of kuiperllama_tpu/kvcache.py.

Fixed-size pages are allocated to sequences on demand, so memory scales with
the tokens that exist, not with max_seqs x max_len, and decode attention
reads only real pages (ops/kernels/paged_attention.py).

Layout, as in the JAX package:
  k_pages, v_pages: [L, n_pages, page_size, KH*hd]
token t of kv head h at [li, page, t % ps, h*hd:(h+1)*hd], so one token's
K/V row of every head is contiguous and a decode step's append is one row
write per sequence. The port writes the pools IN PLACE (the JAX package
donates them to each step instead).

Page 0 is a reserved garbage sink: writes of padding rows or retired slots
go to page 0 instead of needing drop semantics. The allocator never hands it
out. The page table [max_seqs, max_pages_per_seq] int32 and seq_lens
[max_seqs] live on the host (the scheduler owns them) and ship to the
device per step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .config import ModelConfig


@dataclass
class PagedKVCache:
    k_pages: torch.Tensor  # [L, P, ps, KH*hd]
    v_pages: torch.Tensor  # [L, P, ps, KH*hd]
    page_size: int

    @property
    def n_pages(self) -> int:
        return self.k_pages.shape[1]


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int = 128,
                     dtype=torch.bfloat16, n_kv_heads: Optional[int] = None,
                     device="cuda") -> PagedKVCache:
    """Zeroed pools of n_pages pages on `device`."""
    KH = n_kv_heads or cfg.n_kv_heads
    shape = (cfg.n_layers, n_pages, page_size, KH * cfg.head_dim)
    return PagedKVCache(
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device),
        page_size=page_size,
    )


class PageAllocator:
    """Host-side free-list page allocator and page tables (the scheduler's
    bookkeeping; nothing here touches the device). Page 0 is reserved as the
    garbage sink and is never allocated; `reserved` adds more such pages.
    A copy of the JAX package's allocator: pages leave the free list in the
    same order, so page ids match the JAX engine's."""

    def __init__(self, n_pages: int, page_size: int, max_seqs: int,
                 max_len: int, reserved=()):
        self.page_size = page_size
        self.max_pages_per_seq = -(-max_len // page_size)
        self.reserved = {0} | set(reserved)
        self.free: List[int] = [p for p in range(1, n_pages)
                                if p not in self.reserved]
        self.page_table = np.zeros((max_seqs, self.max_pages_per_seq), np.int32)
        self.seq_lens = np.zeros((max_seqs,), np.int32)
        self.owned: dict[int, List[int]] = {}

    @property
    def n_free_pages(self) -> int:
        return len(self.free)

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def alloc_seq(self, slot: int, n_tokens: int) -> bool:
        """Reserve pages for a sequence of n_tokens in `slot`. False if OOM."""
        need = self.pages_needed(max(n_tokens, 1))
        if need > len(self.free):
            return False
        pages = [self.free.pop() for _ in range(need)]
        self.owned[slot] = pages
        self.page_table[slot, :need] = pages
        self.seq_lens[slot] = n_tokens
        return True

    def extend_seq(self, slot: int, new_len: int) -> bool:
        """Grow a sequence; allocates a page when it crosses a boundary."""
        have = len(self.owned[slot])
        need = self.pages_needed(new_len)
        while have < need:
            if not self.free:
                return False
            p = self.free.pop()
            self.owned[slot].append(p)
            self.page_table[slot, have] = p
            have += 1
        self.seq_lens[slot] = new_len
        return True

    def free_seq(self, slot: int):
        for p in self.owned.pop(slot, []):
            self.free.append(p)
        self.page_table[slot] = 0  # page 0 = garbage sink for stale writes
        self.seq_lens[slot] = 0


def sink_pages(pages: torch.Tensor, n_pages: int) -> torch.Tensor:
    """Page ids with every out-of-range value (such as the 2**30 padding
    sentinel) redirected to the garbage page 0."""
    return torch.where((pages < 0) | (pages >= n_pages),
                       torch.zeros_like(pages), pages)


def write_tokens_paged(cache: PagedKVCache, k_new, v_new, slot_pages, offsets):
    """Write new K/V into the pages IN PLACE and return the cache.

    k_new/v_new: [L, B, T, KH, hd] from the layer forward.
    slot_pages:  [B, T] int physical page per token; out-of-range values
                 (such as a 2**30 padding sentinel) go to the garbage page 0.
    offsets:     [B, T] int in-page offset per token.
    Several writes to one slot of page 0 land in an undefined order, which
    is harmless for the sink; real slots are written once each."""
    L, B, T, KH, hd = k_new.shape
    kp, vp = cache.k_pages, cache.v_pages
    pages = sink_pages(slot_pages.long(), kp.shape[1])
    offs = offsets.long()
    kp[:, pages, offs] = k_new.reshape(L, B, T, KH * hd).to(kp.dtype)
    vp[:, pages, offs] = v_new.reshape(L, B, T, KH * hd).to(vp.dtype)
    return cache
