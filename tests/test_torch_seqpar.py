"""Sequence-parallel (split-K) paged decode attention of the port
(parallel/seqpar.py) against the JAX package, the counterpart of
tests/test_seqpar.py: the sharded work lists equal JAX's and cover the
global walk exactly once, merge_flash_many equals the pairwise fold,
attention_dense_parts equals JAX's, and SeqParAttention on 4 gloo ranks
(tests/torch_rank_cases.py) equals JAX's single-device paged kernel (Pallas
interpreter) and the dense oracle."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_rank_cases as rc
from kuiperllama_tpu.ops.attention import attention_dense as jdense
from kuiperllama_tpu.ops.attention import attention_dense_parts as jparts
from kuiperllama_tpu.ops.pallas.paged_attention import (merge_flash_many as jmerge,
                                                        paged_attention as jpaged)
from kuiperllama_tpu.parallel.seqpar import build_work_lists_sharded as jlists
from kuiperllama_tpu_torch.ops.attention import attention_dense_parts
from kuiperllama_tpu_torch.ops.kernels.paged_attention import (build_work_list,
                                                               merge_flash_many,
                                                               merge_flash_parts)
from kuiperllama_tpu_torch.parallel.seqpar import build_work_lists_sharded
from torch_threads import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with rc.open_pool(tmp_path_factory.mktemp("rdv"), 4) as p:
        yield p


def _mk_case(rng, B=3, KH=2, kv_mul=2, hd=16, ps=8, S=64, n_pages=64):
    """tests/test_seqpar.py's case: rows' pages scattered over the pool."""
    H = KH * kv_mul
    lens = rng.integers(ps + 1, S, size=B)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kp = np.zeros((n_pages, ps, KH * hd), np.float32)
    vp = np.zeros((n_pages, ps, KH * hd), np.float32)
    pt = np.zeros((B, S // ps), np.int32)
    order = iter(rng.permutation(np.arange(1, n_pages)))
    k_all = rng.standard_normal((B, S, KH, hd)).astype(np.float32)
    v_all = rng.standard_normal((B, S, KH, hd)).astype(np.float32)
    for b in range(B):
        for pi in range(-(-int(lens[b]) // ps)):
            page = int(next(order))
            pt[b, pi] = page
            kp[page] = k_all[b, pi * ps:(pi + 1) * ps].reshape(ps, KH * hd)
            vp[page] = v_all[b, pi * ps:(pi + 1) * ps].reshape(ps, KH * hd)
    return q, kp, vp, pt, lens.astype(np.int32), k_all, v_all


@pytest.mark.parametrize("shards", [2, 8])
def test_work_lists_equal_jax_and_cover_everything(rng, shards):
    _, _, _, pt, lens, _, _ = _mk_case(rng)
    got = build_work_lists_sharded(pt, lens, 8, shards, 64)
    for a, b in zip(got, jlists(pt, lens, 8, shards, 64)):
        np.testing.assert_array_equal(a, np.asarray(b))
    fb, fp, ft, ni, cov = got
    gb, gp, gt, gn = build_work_list(pt, lens, 8)
    want = {(int(gb[i]), int(gp[i]), int(gt[i])) for i in range(int(gn[0]))}
    seen, pl = set(), 64 // shards
    for s in range(shards):
        for i in range(int(ni[s, 0])):
            item = (int(fb[s, i]), int(fp[s, i]) + s * pl, int(ft[s, i]))
            assert item not in seen and cov[s, fb[s, i]]
            seen.add(item)
    assert seen == want
    # a fixed length for a graph's metadata buffer: padding only
    padded = build_work_lists_sharded(pt, lens, 8, shards, 64, pad_to=pt.size)
    assert padded[0].shape == (shards, pt.size)
    np.testing.assert_array_equal(padded[3], ni)
    np.testing.assert_array_equal(padded[1][:, :fb.shape[1]], fp)


def test_merge_flash_many_matches_pairwise_and_jax(rng):
    B, H, hd = 2, 4, 8
    acc = rng.standard_normal((3, B, H, hd)).astype(np.float32)
    m = rng.standard_normal((3, B, H)).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (3, B, H)).astype(np.float32)
    t = torch.from_numpy
    many = merge_flash_many(t(acc), t(m), t(l)).numpy()
    m12 = np.maximum(m[0], m[1])
    acc12 = (acc[0] * np.exp(m[0] - m12)[..., None]
             + acc[1] * np.exp(m[1] - m12)[..., None])
    l12 = l[0] * np.exp(m[0] - m12) + l[1] * np.exp(m[1] - m12)
    pair = merge_flash_parts(t(acc12), t(m12), t(l12), t(acc[2]), t(m[2]),
                             t(l[2])).numpy()
    np.testing.assert_allclose(many, pair, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(many, np.asarray(jmerge(acc, m, l)), rtol=2e-6,
                               atol=2e-6)
    # every partial the flash identity: zeros, not NaN
    ident = merge_flash_many(torch.zeros(2, B, H, hd), torch.full((2, B, H), -1e30),
                             torch.zeros(2, B, H))
    assert torch.equal(ident, torch.zeros(B, H, hd))


def test_attention_dense_parts_matches_jax(rng):
    B, T, S, KH, H, hd = 2, 3, 10, 2, 4, 8
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KH, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KH, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S - T, S, dtype=np.int32), (B, T)).copy()
    mask = rng.random((B, S)) < 0.6
    mask[1] = False  # an empty row: the flash identity
    got = attention_dense_parts(*(torch.from_numpy(a) for a in (q, k, v, pos, mask)))
    want = jparts(q, k, v, pos, mask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    assert float(got[2][1].abs().max()) == 0.0


def test_seqpar_attention_matches_jax_and_oracle(pool, rng):
    ps = 8
    q, kp, vp, pt, lens, k_all, v_all = _mk_case(rng, ps=ps, n_pages=64)
    outs = pool.run(rc.seqpar_attention, q, kp, vp, pt, lens, ps, 4)
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    want_single = np.asarray(jpaged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                    jnp.asarray(pt), jnp.asarray(lens), page_size=ps))
    np.testing.assert_allclose(outs[0], want_single, atol=2e-5)
    S = k_all.shape[1]
    mask = np.arange(S)[None, :] < lens[:, None]
    want = np.asarray(jdense(jnp.asarray(q[:, None]), jnp.asarray(k_all),
                             jnp.asarray(v_all),
                             jnp.asarray((lens - 1)[:, None].astype(np.int32)),
                             kv_len_mask=jnp.asarray(mask)))[:, 0]
    np.testing.assert_allclose(outs[0], want, atol=2e-5)
