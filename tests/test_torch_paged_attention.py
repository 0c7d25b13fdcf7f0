"""The port's paged attention, work list, flash merges, page allocator and
paged writes against the JAX package's (kuiperllama_tpu/kvcache.py and
ops/pallas/paged_attention.py, its Pallas kernel in interpret mode), on the
same numpy inputs. On the CPU the port's wrapper runs its plain version."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kuiperllama_tpu import kvcache as jkv
from kuiperllama_tpu.config import tiny_config as jtiny
from kuiperllama_tpu.ops.pallas import paged_attention as jpa
from kuiperllama_tpu_torch import kvcache as tkv
from kuiperllama_tpu_torch.config import tiny_config
from kuiperllama_tpu_torch.ops.kernels import paged_attention as tpa
from torch_threads import one_thread  # noqa: F401

ATOL, RTOL = 2e-5, 1e-4  # tests/test_paged_attention.py's own


def _pools(rng, B, S, KH, hd, ps, shuffle=False, layers=0):
    """q-less pools [P, ps, KH*hd] (or [layers, P, ...]) holding B rows of S
    tokens, and the page table; page 0 stays the garbage page."""
    max_pages = S // ps
    n_pages = B * max_pages + 1
    shape = (n_pages, ps, KH * hd) if not layers else (layers, n_pages, ps, KH * hd)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    ids = np.arange(1, n_pages)
    if shuffle:
        ids = rng.permutation(ids)
    return kp, vp, ids.reshape(B, max_pages).astype(np.int32)


@pytest.mark.parametrize("kv_mul", [1, 4])
@pytest.mark.parametrize("lens", [[1], [128], [129, 3], [400, 256, 17]])
def test_paged_attention_matches_jax(rng, lens, kv_mul):
    ps, KH, hd, S = 128, 2, 32, 512
    H, B = KH * kv_mul, len(lens)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kp, vp, pt = _pools(rng, B, S, KH, hd, ps, shuffle=True)
    sl = np.asarray(lens, np.int32)
    want = np.asarray(jpa.paged_attention(jnp.asarray(q), jnp.asarray(kp),
                                          jnp.asarray(vp), jnp.asarray(pt),
                                          jnp.asarray(sl), page_size=ps))
    got = tpa.paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                              torch.from_numpy(vp), pt, sl, page_size=ps)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_paged_attention_mha_7b_geometry_matches_jax(rng):
    ps, KH, hd, S = 128, 8, 128, 256
    lens = [200, 129]
    q = rng.standard_normal((2, KH, hd)).astype(np.float32)
    kp, vp, pt = _pools(rng, 2, S, KH, hd, ps)
    sl = np.asarray(lens, np.int32)
    want = np.asarray(jpa.paged_attention(jnp.asarray(q), jnp.asarray(kp),
                                          jnp.asarray(vp), jnp.asarray(pt),
                                          jnp.asarray(sl), page_size=ps))
    got = tpa.paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                              torch.from_numpy(vp), pt, sl, page_size=ps)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
def test_flat_stats_on_stacked_pools_match_jax(rng, pool_dtype):
    """Unnormalised (acc, m, l) read at layer 1 of a stacked pool, with a
    row that has no items (the port gives it the flash identity; JAX leaves
    it unwritten, so only rows with items are compared). bf16 pools round p
    before the pv product on both sides."""
    ps, KH, hd, kv_mul = 8, 2, 32, 2
    lens = [9, 0, 24, 1]
    B, H, S = len(lens), KH * kv_mul, 32
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kp, vp, pt = _pools(rng, B, S, KH, hd, ps, shuffle=True, layers=2)
    sl = np.asarray(lens, np.int32)
    fb, fp, ft, n = tpa.build_work_list(pt, sl, ps)
    jdt = getattr(jnp, pool_dtype)
    ja, jm, jl = (np.asarray(x) for x in jpa.paged_attention_flat(
        jnp.asarray(q), jnp.asarray(kp).astype(jdt), jnp.asarray(vp).astype(jdt),
        *(jnp.asarray(a) for a in (fb, fp, ft, n, sl)), page_size=ps,
        layer_idx=jnp.int32(1)))
    tdt = getattr(torch, pool_dtype)
    ta, tm, tl = tpa.paged_attention_flat(
        torch.from_numpy(q), torch.from_numpy(kp).to(tdt),
        torch.from_numpy(vp).to(tdt), *(torch.from_numpy(a) for a in (fb, fp, ft, n, sl)),
        page_size=ps, layer_idx=1)
    rows = sl > 0
    np.testing.assert_allclose(tm.numpy()[rows], jm[rows], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tl.numpy()[rows], jl[rows], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ta.numpy()[rows], ja[rows], atol=ATOL, rtol=RTOL)
    assert (ta.numpy()[~rows] == 0).all() and (tl.numpy()[~rows] == 0).all()
    assert (tm.numpy()[~rows] == tpa.NEG_INF).all()


@pytest.mark.parametrize("lens,max_pages,ps", [
    ([1], 4, 128), ([128, 0, 129], 4, 128), ([0, 0], 2, 8), ([17, 40, 8], 5, 8)])
def test_build_work_list_matches_jax(rng, lens, max_pages, ps):
    pt = rng.integers(1, 50, size=(len(lens), max_pages)).astype(np.int32)
    sl = np.asarray(lens, np.int32)
    for got, want in zip(tpa.build_work_list(pt, sl, ps),
                         jpa.build_work_list(pt, sl, ps)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_merge_flash_matches_jax(rng):
    acc = rng.standard_normal((3, 2, 4, 16)).astype(np.float32)
    m = rng.standard_normal((3, 2, 4)).astype(np.float32) * 3
    m[1, 0, 0] = tpa.NEG_INF  # an empty partial
    l = rng.uniform(0.5, 4.0, (3, 2, 4)).astype(np.float32)
    l[1, 0, 0] = 0.0
    want = np.asarray(jpa.merge_flash_many(jnp.asarray(acc), jnp.asarray(m),
                                           jnp.asarray(l)))
    got = tpa.merge_flash_many(*(torch.from_numpy(a) for a in (acc, m, l)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    want2 = np.asarray(jpa.merge_flash_parts(*(jnp.asarray(a) for a in
                                               (acc[0], m[0], l[0], acc[2], m[2], l[2]))))
    got2 = tpa.merge_flash_parts(*(torch.from_numpy(a) for a in
                                   (acc[0], m[0], l[0], acc[2], m[2], l[2])))
    np.testing.assert_allclose(got2.numpy(), want2, atol=1e-6, rtol=1e-6)


def test_page_allocator_matches_jax():
    args = dict(n_pages=12, page_size=4, max_seqs=4, max_len=24)
    j, t = jkv.PageAllocator(**args), tkv.PageAllocator(**args)
    ops = [("alloc_seq", 0, 5), ("alloc_seq", 1, 4), ("extend_seq", 0, 8),
           ("extend_seq", 0, 9), ("free_seq", 0), ("alloc_seq", 2, 16),
           ("alloc_seq", 3, 16), ("extend_seq", 1, 13), ("alloc_seq", 3, 6),
           ("free_seq", 2), ("alloc_seq", 0, 3), ("extend_seq", 3, 20)]
    for name, *a in ops:
        assert getattr(t, name)(*a) == getattr(j, name)(*a), (name, a)
        np.testing.assert_array_equal(t.page_table, j.page_table)
        np.testing.assert_array_equal(t.seq_lens, j.seq_lens)
        assert t.free == j.free and t.owned == j.owned
    assert t.n_free_pages == j.n_free_pages


def test_write_tokens_paged_matches_jax(rng):
    jcfg = jtiny("llama2", n_heads=4, n_kv_heads=2, dim=64)
    cfg = tiny_config("llama2", n_heads=4, n_kv_heads=2, dim=64)
    ps, P = 4, 6
    L, KH, hd = cfg.n_layers, 2, cfg.head_dim
    B, T = 2, 3
    k_new = rng.standard_normal((L, B, T, KH, hd)).astype(np.float32)
    v_new = rng.standard_normal((L, B, T, KH, hd)).astype(np.float32)
    # row 0 at positions 2, 3, 4 of pages [1, 2]; row 1 at 0, 1, 2 of page 5;
    # a 2**30 sentinel goes to the garbage page 0 on both sides
    pages = np.asarray([[1, 1, 2], [5, 5, 2 ** 30]], np.int32)
    offs = np.asarray([[2, 3, 0], [0, 1, 2]], np.int32)
    jc = jkv.write_tokens_paged(
        jkv.init_paged_cache(jcfg, n_pages=P, page_size=ps, dtype=jnp.float32),
        jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(pages),
        jnp.asarray(offs))
    tc = tkv.init_paged_cache(cfg, n_pages=P, page_size=ps, dtype=torch.float32,
                              device="cpu")
    out = tkv.write_tokens_paged(tc, torch.from_numpy(k_new),
                                 torch.from_numpy(v_new), torch.from_numpy(pages),
                                 torch.from_numpy(offs))
    assert out is tc  # in place
    np.testing.assert_array_equal(tc.k_pages.numpy(), np.asarray(jc.k_pages))
    np.testing.assert_array_equal(tc.v_pages.numpy(), np.asarray(jc.v_pages))
    assert tc.n_pages == P
