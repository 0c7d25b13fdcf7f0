"""Paged flash-decode attention: the kernel's wrapper, its plain PyTorch
version, the host-side work list and the flash-statistics merges.

Port of kuiperllama_tpu/ops/pallas/paged_attention.py. Pool layout as in the
JAX package: k_pages, v_pages [P, ps, KH*hd] for one layer, or the stacked
[L, P, ps, KH*hd] pools with `layer_idx` (the layer of a contiguous stack is
a zero-copy view). Token t of kv head h sits at [page, t % ps, h*hd:(h+1)*hd].
The scheduler flattens the batch's pages into one work list sorted by row
(`build_work_list`); the kernel returns UNNORMALISED flash statistics
(acc, m, l) and callers divide acc by l. The CUDA source is
csrc/paged_attention.cu; its header says what bounds it on the card and how
its design deals with that.

The wrapper takes the plain version for a tensor that lies on the CPU, and
for a CUDA tensor it launches the kernel or raises: there is no fallback.
`paged_attention_flat.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import build

SOURCE = "paged_attention"
NEG_INF = -1e30
_THREADS = 128   # threads per block in csrc/paged_attention.cu
_WARPS = _THREADS // 32
_MAX_KV_MUL = 8  # the kernel's largest register tile of query heads
_SMEM_LIMIT = 227 * 1024  # shared memory a block may opt in to on sm_90

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int
_ARGS = [_c_void_p, _c_int, _c_void_p, _c_void_p, _c_int, _c_void_p, _c_void_p,
         _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_void_p,
         _c_void_p, _c_void_p, _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int,
         _c_int, _c_int, ctypes.c_float, _c_void_p]


def build_work_list(page_table, seq_lens, page_size: int):
    """Flatten the pages of all rows, sorted by row, into the kernel's work
    list. Host-side numpy (the scheduler owns these arrays).

    Returns (flat_b, flat_page, flat_tok0, n_items) int32 numpy arrays, the
    flat ones padded to page_table.size by repeating the last item (the
    kernel stops at n_items)."""
    B, max_pages = page_table.shape
    fb, fp, ft = [], [], []
    for b in range(B):
        n = -(-int(seq_lens[b]) // page_size) if seq_lens[b] > 0 else 0
        for pi in range(n):
            fb.append(b)
            fp.append(int(page_table[b, pi]))
            ft.append(pi * page_size)
    n_items = len(fb)
    total = max(B * max_pages, 1)
    if n_items == 0:
        fb, fp, ft = [0], [0], [0]
    while len(fb) < total:
        fb.append(fb[-1]); fp.append(fp[-1]); ft.append(ft[-1])
    return (np.asarray(fb, np.int32), np.asarray(fp, np.int32),
            np.asarray(ft, np.int32), np.asarray([n_items], np.int32))


def attention_scale(hd: int) -> float:
    """1/sqrt(hd) rounded to fp32, the scale of the scores."""
    return float(np.float32(1.0 / math.sqrt(hd)))


def _layer(pool, layer_idx):
    """One layer's [P, ps, KH*hd] view of a stacked pool."""
    if pool.dim() == 3:
        return pool
    if layer_idx is None:
        raise ValueError("paged_attention_flat: stacked pools need layer_idx")
    return pool[int(layer_idx)]


def _geometry(q, kp, page_size, n_kv_heads):
    B, H, hd = q.shape
    P, ps, kv_dim = kp.shape
    if ps != page_size:
        raise ValueError(f"paged_attention_flat: pool pages hold {ps} tokens, "
                         f"page_size is {page_size}")
    KH = n_kv_heads or kv_dim // hd
    if KH * hd != kv_dim or H % KH:
        raise ValueError(f"paged_attention_flat: H {H}, KH {KH}, hd {hd} do not "
                         f"fit a pool lane dim of {kv_dim}")
    return B, H, hd, P, ps, KH


# ---------------------------------------------------------------------------
# Plain version: the TPU kernel's page-by-page recurrence, all rows at once


def paged_attention_flat_ref(q, k_pages, v_pages, flat_b, flat_page, flat_tok0,
                             n_items, seq_lens, page_size: int = 128,
                             n_kv_heads=None, layer_idx=None):
    """The plain version of `paged_attention_flat` (same arguments and
    returns). Each row's pages are taken in work-list order; the k-th page
    of every row is processed in one vectorised pass."""
    kp, vp = _layer(k_pages, layer_idx), _layer(v_pages, layer_idx)
    B, H, hd, P, ps, KH = _geometry(q, kp, page_size, n_kv_heads)
    kv_mul = H // KH
    dev = q.device
    acc = torch.zeros((B, H, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, H), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H), dtype=torch.float32, device=dev)
    n = min(int(n_items.reshape(-1)[0]), flat_b.shape[0])
    if n == 0:
        return acc, m, l
    fb = flat_b[:n].long().to(dev)
    pages = flat_page[:n].long().to(dev).clamp(0, P - 1)
    tok0 = flat_tok0[:n].long().to(dev)
    # rank of each item within its row (flat_b is sorted)
    first = torch.searchsorted(fb, fb, right=False)
    rank = torch.arange(n, device=dev) - first
    k = kp[pages].reshape(n, ps, KH, hd).to(q.dtype).float()
    v = vp[pages].reshape(n, ps, KH, hd)
    qi = q[fb].reshape(n, KH, kv_mul, hd).float()
    s = torch.einsum("nkmd,ntkd->nkmt", qi, k).reshape(n, H, ps)
    s = s * attention_scale(hd)
    valid = (tok0[:, None] + torch.arange(ps, device=dev)[None]
             < seq_lens.to(dev).long()[fb][:, None])[:, None, :]  # [n, 1, ps]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    for r in range(int(rank.max()) + 1):
        sel = torch.nonzero(rank == r).flatten()
        rows = fb[sel]
        m_old = m[rows]
        m_new = torch.maximum(m_old, s[sel].amax(-1))
        p = torch.where(valid[sel], torch.exp(s[sel] - m_new[..., None]),
                        torch.zeros((), device=dev))
        corr = torch.exp(m_old - m_new)
        l[rows] = l[rows] * corr + p.sum(-1)
        pr = p.to(vp.dtype).float().reshape(-1, KH, kv_mul, ps)
        pv = torch.einsum("nkmt,ntkd->nkmd", pr, v[sel].float()).reshape(-1, H, hd)
        acc[rows] = acc[rows] * corr[..., None] + pv
        m[rows] = m_new
    return acc, m, l


# ---------------------------------------------------------------------------
# Kernel wrapper


def stats_smem_bytes(kv_mul: int, hd: int, ps: int, elem: int) -> int:
    """Shared memory of one block of the kernel's first pass (`Layout` in
    csrc/paged_attention.cu): the page's K rows (later the token groups'
    partial sums), its V rows, each row padded by 16 bytes, the query heads
    and the scores."""
    kv = ps * (hd + 16 // elem) * elem
    return max(kv, _WARPS * kv_mul * hd * 4) + kv + 4 * kv_mul * (hd + ps)


def _check(q, kp, vp, meta, hd, ps, kv_mul):
    dev = q.device
    if not all(t.device == dev for t in (kp, vp, *meta)):
        raise ValueError("paged_attention_flat: q, the pools and the work list "
                         "must share one CUDA device")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"paged_attention_flat: q is on {dev}, the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged_attention_flat: q must be fp32 or bf16, got {q.dtype}")
    if kp.dtype != vp.dtype or kp.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("paged_attention_flat: the pools must both be fp32 or "
                        f"both bf16, got {kp.dtype} and {vp.dtype}")
    if kp.shape != vp.shape:
        raise ValueError(f"paged_attention_flat: pool shapes differ: "
                         f"{tuple(kp.shape)}, {tuple(vp.shape)}")
    if any(t.dtype != torch.int32 for t in meta):
        raise TypeError("paged_attention_flat: the work list and seq_lens "
                        "must be int32")
    if not all(t.is_contiguous() for t in (q, kp, vp, *meta)):
        raise ValueError("paged_attention_flat: tensors must be contiguous")
    vec = 16 // kp.element_size()
    chunks = hd // vec if hd % vec == 0 else 0
    if not chunks or _THREADS % chunks:
        raise ValueError(f"paged_attention_flat: head dim {hd} does not split "
                         f"into 16-byte chunks that divide {_THREADS} threads")
    if kv_mul > _MAX_KV_MUL:
        raise ValueError(f"paged_attention_flat: kv_mul {kv_mul} > {_MAX_KV_MUL}")
    if stats_smem_bytes(kv_mul, hd, ps, kp.element_size()) > _SMEM_LIMIT:
        raise ValueError(f"paged_attention_flat: kv_mul {kv_mul}, hd {hd}, page "
                         f"size {ps} need more than 227 KB of shared memory")
    if kp.data_ptr() % 16 or vp.data_ptr() % 16:
        raise ValueError("paged_attention_flat: pools must be 16-byte aligned")


def paged_attention_flat(q, k_pages, v_pages, flat_b, flat_page, flat_tok0,
                         n_items, seq_lens, page_size: int = 128,
                         n_kv_heads=None, layer_idx=None):
    """q [B, H, hd] against paged K/V through a flat work list (see
    build_work_list). k_pages/v_pages are one layer's [P, ps, KH*hd], or the
    stacked [L, P, ps, KH*hd] pools with the int `layer_idx`. The work list
    (flat_b, flat_page, flat_tok0 int32 [M], n_items int32 [1]) and
    seq_lens [B] int32 lie on q's device.

    Returns UNNORMALISED flash statistics (acc [B, H, hd], m [B, H],
    l [B, H], all fp32): out = acc / l. A row with no items in the list gets
    the flash identity (acc 0, m -1e30, l 0)."""
    if q.device.type == "cpu":
        return paged_attention_flat_ref(q, k_pages, v_pages, flat_b, flat_page,
                                        flat_tok0, n_items, seq_lens, page_size,
                                        n_kv_heads, layer_idx)
    kp, vp = _layer(k_pages, layer_idx), _layer(v_pages, layer_idx)
    B, H, hd, P, ps, KH = _geometry(q, kp, page_size, n_kv_heads)
    meta = (flat_b, flat_page, flat_tok0, n_items, seq_lens)
    _check(q, kp, vp, meta, hd, ps, H // KH)
    if seq_lens.shape != (B,) or n_items.numel() != 1:
        raise ValueError("paged_attention_flat: seq_lens must be [B] and "
                         "n_items [1]")
    max_items = flat_b.shape[0]
    if max_items < 1:
        raise ValueError("paged_attention_flat: the work list is empty (pad it "
                         "as build_work_list does)")
    f32 = dict(dtype=torch.float32, device=q.device)
    # per-item statistics of the first pass; the second merges them by row
    part_acc = torch.empty((max_items, H, hd), **f32)
    part_m = torch.empty((max_items, H), **f32)
    part_l = torch.empty((max_items, H), **f32)
    acc = torch.empty((B, H, hd), **f32)
    m = torch.empty((B, H), **f32)
    l = torch.empty((B, H), **f32)
    rc = build.entry(SOURCE, SOURCE, _ARGS)(
        q.data_ptr(), int(q.dtype == torch.bfloat16), kp.data_ptr(),
        vp.data_ptr(), int(kp.dtype == torch.bfloat16), flat_b.data_ptr(),
        flat_page.data_ptr(), flat_tok0.data_ptr(), n_items.data_ptr(),
        seq_lens.data_ptr(), part_acc.data_ptr(), part_m.data_ptr(),
        part_l.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        B, H, KH, hd, ps, P, max_items, attention_scale(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention_flat: kernel launch failed, CUDA error {rc}")
    paged_attention_flat.launches += 1
    return acc, m, l


paged_attention_flat.launches = 0


def merge_flash_many(acc, m, l, axis: int = 0):
    """Exactly merge N unnormalised flash partials over disjoint key sets,
    stacked on `axis`: acc [N, ..., hd], m/l [N, ...]. Returns the
    NORMALISED merged output [..., hd]."""
    m_max = m.amax(dim=axis)
    c = torch.exp(m - m_max.unsqueeze(axis))
    num = (acc * c[..., None]).sum(dim=axis)
    den = (l * c).sum(dim=axis)
    return num / torch.clamp(den[..., None], min=1e-30)


def merge_flash_parts(acc1, m1, l1, acc2, m2, l2):
    """Two-partial form of merge_flash_many."""
    return merge_flash_many(torch.stack([acc1, acc2]), torch.stack([m1, m2]),
                            torch.stack([l1, l2]))


def paged_attention(q, k_pages, v_pages, page_table, seq_lens,
                    page_size: int = 128):
    """Convenience form: builds the work list on the host from page_table
    and seq_lens (numpy or tensors) and returns the NORMALISED output
    [B, H, hd] in q.dtype."""
    pt = np.asarray(page_table.cpu() if torch.is_tensor(page_table) else page_table)
    sl = np.asarray(seq_lens.cpu() if torch.is_tensor(seq_lens) else seq_lens,
                    np.int32)
    dev = q.device
    fb, fp, ft, n = (torch.from_numpy(a).to(dev)
                     for a in build_work_list(pt, sl, page_size))
    acc, m, l = paged_attention_flat(q, k_pages, v_pages, fb, fp, ft, n,
                                     torch.from_numpy(sl).to(dev),
                                     page_size=page_size)
    return (acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype)
