"""The numerics of the split paged flash-decode kernel (csrc/paged_attention.cu),
written in torch and held to the JAX package's paged_attention_flat (its
Pallas kernel in interpret mode) before the card runs the kernel.

The kernel computes each work item's own statistics (m_i = max over the
page, p = exp(s - m_i) rounded to the pool dtype before the pv product,
l_i, acc_i) and merges a row's items in work-list order. The JAX kernel
walks a row's pages with a running max. Limits, as chip_smoke.py holds the
kernel to its plain version: the normalised output relative to max|want|
1e-6 with fp32 pools and 1e-3 with bf16 pools (p is rounded relative to
another max), m 1e-6 relative to max|m| (exact: a max is order-free), l 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kuiperllama_tpu.ops.pallas import paged_attention as jpa
from kuiperllama_tpu_torch.ops.kernels import paged_attention as tpa
from torch_threads import one_thread  # noqa: F401


def split_then_merge(q, kp, vp, fb, fp, ft, n_items, sl, ps, layer):
    """Per-item statistics, then each row's items merged in item order by
    merge_flash_many: (normalised out [B, H, hd], m [B, H], l [B, H])."""
    kp, vp = kp[layer], vp[layer]
    B, H, hd = q.shape
    KH = kp.shape[-1] // hd
    kv_mul = H // KH
    n = int(n_items[0])
    out = torch.zeros((B, H, hd))
    m = torch.full((B, H), tpa.NEG_INF)
    l = torch.zeros((B, H))
    parts = {}
    for i in range(n):
        b, page, tok0 = int(fb[i]), int(fp[i]), int(ft[i])
        k = kp[page].reshape(ps, KH, hd).to(q.dtype).float()
        v = vp[page].reshape(ps, KH, hd)
        qi = q[b].reshape(KH, kv_mul, hd).float()
        s = torch.einsum("kmd,tkd->kmt", qi, k).reshape(H, ps) * tpa.attention_scale(hd)
        valid = tok0 + torch.arange(ps) < int(sl[b])
        s = torch.where(valid[None], s, torch.full_like(s, tpa.NEG_INF))
        mi = s.amax(-1)
        p = torch.where(valid[None], torch.exp(s - mi[:, None]), torch.zeros(()))
        li = p.sum(-1)
        pr = p.to(vp.dtype).float().reshape(KH, kv_mul, ps)
        acc = torch.einsum("kmt,tkd->kmd", pr, v.float()).reshape(H, hd)
        parts.setdefault(b, []).append((acc, mi, li))
    for b, items in parts.items():
        acc, mi, li = (torch.stack(x) for x in zip(*items))
        out[b] = tpa.merge_flash_many(acc, mi, li)
        m[b] = mi.amax(0)
        l[b] = (li * torch.exp(mi - m[b])).sum(0)
    return out, m, l


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("pool_dtype,tol", [("float32", 1e-6), ("bfloat16", 1e-3)])
@pytest.mark.parametrize("lens,kv_mul,ps,hd", [
    ([1, 8, 0, 72, 21, 7], 4, 8, 32),        # 0, 1 and 9 pages; 1 token
    ([300, 129, 128, 1], 1, 128, 64),        # MHA, 128-token pages
    ([40, 3, 17], 7, 8, 16),                 # kv_mul 7
])
def test_split_then_merge_matches_jax(pool_dtype, tol, lens, kv_mul, ps, hd):
    rng = np.random.default_rng(len(lens) * 100 + kv_mul)
    KH, B = 2, len(lens)
    H = KH * kv_mul
    max_pages = -(-max(lens) // ps) + 1
    P = B * max_pages + 1
    kp = rng.standard_normal((2, P, ps, KH * hd)).astype(np.float32)
    vp = rng.standard_normal((2, P, ps, KH * hd)).astype(np.float32)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    pt = rng.permutation(np.arange(1, P)).reshape(B, max_pages).astype(np.int32)
    sl = np.asarray(lens, np.int32)
    work = tpa.build_work_list(pt, sl, ps)
    jdt = getattr(jnp, pool_dtype)
    ja, jm, jl = (torch.from_numpy(np.asarray(x, np.float32)) for x in jpa.paged_attention_flat(
        jnp.asarray(q), jnp.asarray(kp).astype(jdt), jnp.asarray(vp).astype(jdt),
        *(jnp.asarray(a) for a in (*work, sl)), page_size=ps, layer_idx=jnp.int32(1)))
    tdt = getattr(torch, pool_dtype)
    out, m, l = split_then_merge(torch.from_numpy(q), torch.from_numpy(kp).to(tdt),
                                 torch.from_numpy(vp).to(tdt), *work, sl, ps, 1)
    rows = torch.from_numpy(sl > 0)
    assert _rel(out[rows], ja[rows] / jl[rows][..., None]) <= tol
    assert _rel(m[rows], jm[rows]) <= 1e-6
    assert _rel(l[rows], jl[rows]) <= 1e-5
    # the row with no items keeps the flash identity
    assert (m[~rows] == tpa.NEG_INF).all() and (l[~rows] == 0).all()


def test_stats_smem_fits_the_main_geometries():
    """Shared memory of the first pass: every geometry chip_smoke.py runs
    fits a block, fp32 pools included; a page too large is refused."""
    for kv_mul, hd, elem in ((1, 128, 2), (4, 128, 2), (8, 64, 2), (7, 64, 2),
                             (8, 64, 4), (8, 128, 4)):
        assert tpa.stats_smem_bytes(kv_mul, hd, 128, elem) <= tpa._SMEM_LIMIT
    assert tpa.stats_smem_bytes(8, 128, 512, 4) > tpa._SMEM_LIMIT
    # the token groups' partial sums reuse the K rows where they fit
    assert tpa.stats_smem_bytes(8, 64, 8, 2) == (4 * 8 * 64 * 4 + 8 * 144
                                                 + 4 * 8 * (64 + 8))
