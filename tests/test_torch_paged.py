"""The port's paged decoder (models/paged.py) against the JAX package's on a
tiny_config with fp32 params (carried across by `convert.from_jax_params`)
and the same numpy inputs on both sides: logits within 1e-4, pools within
1e-5, greedy tokens equal. The JAX side runs its paged-attention Pallas
kernel in interpret mode."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kuiperllama_tpu.config import tiny_config as jtiny
from kuiperllama_tpu.models import paged as jpaged
from kuiperllama_tpu.ops.pallas.paged_attention import build_work_list
from kuiperllama_tpu.params import random_params as jrandom, to_device as jto
from kuiperllama_tpu.serving.generate import _stop_array as jstop
from kuiperllama_tpu_torch.config import tiny_config
from kuiperllama_tpu_torch.convert import from_jax_params
from kuiperllama_tpu_torch.models import paged
from kuiperllama_tpu_torch.serving.generate import _stop_array
from torch_threads import one_thread  # noqa: F401

LOGITS_TOL, POOL_TOL = 1e-4, 1e-5
PS, P, MAX_LEN, SENT = 8, 20, 64, 2 ** 30


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = jtiny("llama2", seq_len=MAX_LEN), tiny_config("llama2", seq_len=MAX_LEN)
    jp = jto(jrandom(jcfg, seed=5), dtype=jnp.float32)
    return jcfg, jp, cfg, from_jax_params(jp, device="cpu")


def _pools(cfg, rng):
    shape = (cfg.n_layers, P, PS, cfg.kv_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def prefilled(model):
    """Three rows prefilled on both sides: lengths 13 and 16, and a padding
    row whose writes all go to the garbage page. Pools start from noise, so
    slots the prefill must not touch are checked too."""
    jcfg, jp, cfg, tp = model
    rng = np.random.default_rng(3)
    kp, vp = _pools(cfg, rng)
    T = 16
    tokens = rng.integers(1, cfg.vocab_size, (3, T)).astype(np.int32)
    lens = np.asarray([13, 16, 1], np.int32)
    pt = np.zeros((3, MAX_LEN // PS), np.int32)
    pt[0, :2], pt[1, :2] = [3, 7], [5, 2]
    token_pages = np.full((3, T), SENT, np.int32)
    for b in range(2):
        token_pages[b, :lens[b]] = pt[b, np.arange(lens[b]) // PS]
    offs = np.broadcast_to(np.arange(T, dtype=np.int32) % PS, (3, T)).copy()
    jl, jk, jv = jpaged.prefill_paged(
        jcfg, jp, jnp.asarray(tokens), jnp.asarray(lens), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(token_pages), jnp.asarray(offs))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tl, tk2, tv2 = paged.prefill_paged(
        cfg, tp, torch.from_numpy(tokens), torch.from_numpy(lens), tk, tv,
        torch.from_numpy(token_pages), torch.from_numpy(offs))
    return dict(j=(np.asarray(jl), np.asarray(jk), np.asarray(jv)),
                t=(tl, tk2, tv2), t_in=(tk, tv), lens=lens, pt=pt, kp=kp)


def test_prefill_paged_matches_jax(prefilled):
    jl, jk, jv = prefilled["j"]
    tl, tk, tv = prefilled["t"]
    assert tk is prefilled["t_in"][0]  # the pools are written in place
    _close(tl[:2], jl[:2], LOGITS_TOL)
    _close(tk[:, 1:], jk[:, 1:], POOL_TOL)  # page 0 is the sink
    _close(tv[:, 1:], jv[:, 1:], POOL_TOL)
    # pages no row owns kept their content
    untouched = [p for p in range(1, P) if p not in (2, 3, 5, 7)]
    np.testing.assert_array_equal(tk[:, untouched].numpy(),
                                  prefilled["kp"][:, untouched])


def test_prefill_chunk_paged_matches_jax(model):
    """A 24-token and a 10-token prompt in three 8-token chunks, with the
    earlier chunks' pages as history; the short row ends in chunk 2."""
    jcfg, jp, cfg, tp = model
    rng = np.random.default_rng(4)
    kp, vp = _pools(cfg, rng)
    C = 8
    tokens = rng.integers(1, cfg.vocab_size, (2, 24)).astype(np.int32)
    lens = np.asarray([24, 10], np.int32)
    pt = np.asarray([[4, 9, 1], [6, 11, 0]], np.int32)
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    for start in range(0, 24, C):
        cp = np.full((2, 1), SENT, np.int32)
        for b in range(2):
            if start < lens[b]:
                cp[b, 0] = pt[b, start // PS]
        n_hist = start // PS
        hp = np.zeros((2, n_hist), np.int32)
        for b in range(2):
            hp[b] = pt[b, :n_hist]
        toks = tokens[:, start:start + C]
        jl, je, jk, jv = jpaged.prefill_chunk_paged(
            jcfg, jp, jnp.asarray(toks), jnp.int32(start), jnp.asarray(lens),
            jk, jv, jnp.asarray(cp), jnp.asarray(hp))
        tl, te, tk, tv = paged.prefill_chunk_paged(
            cfg, tp, torch.from_numpy(toks), start, torch.from_numpy(lens),
            tk, tv, torch.from_numpy(cp), torch.from_numpy(hp))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        rows = np.array(je)
        _close(tl[rows], np.asarray(jl)[rows], LOGITS_TOL)
    _close(tk[:, 1:], np.asarray(jk)[:, 1:], POOL_TOL)
    _close(tv[:, 1:], np.asarray(jv)[:, 1:], POOL_TOL)


def _decode_both(model, prefilled, steps, pos, limit, packed=False):
    """`steps` greedy steps from the prefilled pools on both sides; rows'
    pages extended to cover min(pos + steps + 1, limit) tokens."""
    jcfg, jp, cfg, tp = model
    _, jk, jv = prefilled["j"]
    _, tk, tv = prefilled["t"]
    tk, tv = tk.clone(), tv.clone()
    pt = prefilled["pt"].copy()
    pt[0, 2:4], pt[1, 2:4] = [8, 10], [12, 13]
    pt[2] = 0  # the padding row is inactive: out of the work list
    sl = np.minimum(pos + steps + 1, limit).astype(np.int32)
    sl[2] = 0
    fb, fp, ft, ni = build_work_list(pt, sl, PS)
    token = np.asarray([7, 9, 0], np.int32)
    done = np.asarray([False, False, True])
    stop = {int(cfg.vocab_size) - 1}
    jout = jpaged.decode_chunk_paged(
        jcfg, jp, jnp.asarray(token), jnp.asarray(pos), jnp.asarray(jk),
        jnp.asarray(jv), jnp.asarray(done), jax.random.PRNGKey(0), jstop(stop),
        jnp.asarray(pt), *(jnp.asarray(a) for a in (fb, fp, ft, ni)),
        steps=steps, page_size=PS)
    args = (cfg, tp, torch.from_numpy(token), torch.from_numpy(pos), tk, tv,
            torch.from_numpy(done), None, _stop_array(stop, "cpu"))
    if packed:
        meta = torch.from_numpy(paged.pack_chunk_meta(pt, fb, fp, ft, ni))
        tout = paged.decode_chunk_paged_packed(
            *args, meta, shapes=(3, pt.shape[1], len(fb)), steps=steps,
            page_size=PS)
    else:
        tout = paged.decode_chunk_paged(
            *args, *(torch.from_numpy(a) for a in (pt, fb, fp, ft, ni)),
            steps=steps, page_size=PS)
    return jout, tout


@pytest.mark.parametrize("packed", [False, True])
def test_decode_chunk_paged_matches_jax(model, prefilled, packed):
    pos = prefilled["lens"].copy()
    (jt, jtok, jpos, jk, jv, jdone, _), (tt, ttok, tpos, tk, tv, tdone) = \
        _decode_both(model, prefilled, 6, pos, MAX_LEN, packed)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _close(tk[:, 1:], np.asarray(jk)[:, 1:], POOL_TOL)
    _close(tv[:, 1:], np.asarray(jv)[:, 1:], POOL_TOL)


def test_decode_into_max_len_matches_jax(model, prefilled):
    """Rows at positions 29 and 30 of a 32-token limit decode 5 steps: the
    write page index reaches pos // ps == max_pages of a 32-slot table, and
    both sides clamp it to the last page (JAX's gather clamp)."""
    jcfg, jp, cfg, tp = model
    limit = 32
    pre = dict(prefilled, pt=prefilled["pt"][:, : limit // PS])
    pos = np.asarray([29, 30, 0], np.int32)
    (jt, _, jpos, jk, jv, _, _), (tt, _, tpos, tk, tv, _) = \
        _decode_both(model, pre, 5, pos, limit)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    _close(tk[:, 1:], np.asarray(jk)[:, 1:], POOL_TOL)
    _close(tv[:, 1:], np.asarray(jv)[:, 1:], POOL_TOL)


# prefill_packed_paged: prompt-length mixes, at most ROWS prompts a stream
ROWS = 4
PACKED_MIXES = {
    "one_token": [1],
    "15_16_17": [15, 16, 17],
    "page_edges": [8, 9, 16, 17],   # ends on a page boundary, and one past
    "max_batch": [5, 3, 11, 2],
    "max_len_minus_1": [MAX_LEN - 1],
    "total_on_a_bucket": [20, 12],  # 32 tokens: no padding at all
}


@pytest.mark.parametrize("lens", PACKED_MIXES.values(), ids=PACKED_MIXES.keys())
def test_prefill_packed_paged_matches_jax(model, lens):
    """The prompts packed into one stream, padded to its bucket, against
    JAX's prefill_paged of the same prompts as a [B, bucket] grid: every
    row's last logits, every slot a prompt token writes, and no other slot
    touched but the garbage page's (pad tokens write only there, and
    nothing is written past a prompt's end)."""
    from kuiperllama_tpu_torch.serving.generate import _bucket

    jcfg, jp, cfg, tp = model
    rng = np.random.default_rng(sum(lens))
    kp, vp = _pools(cfg, rng)
    B, N = len(lens), sum(lens)
    n = _bucket(N)
    prompts = [rng.integers(1, cfg.vocab_size, m).astype(np.int32) for m in lens]
    # each prompt on its own shuffled pages
    free = list(rng.permutation(np.arange(1, P)))
    pt = np.zeros((B, MAX_LEN // PS), np.int32)
    for b, m in enumerate(lens):
        for j in range(-(-m // PS)):
            pt[b, j] = free.pop()
    T = _bucket(max(lens))
    tokens = np.zeros((B, T), np.int32)
    token_pages = np.full((B, T), SENT, np.int32)
    for b, (p, m) in enumerate(zip(prompts, lens)):
        tokens[b, :m] = p
        token_pages[b, :m] = pt[b, np.arange(m) // PS]
    offs = np.broadcast_to(np.arange(T, dtype=np.int32) % PS, (B, T)).copy()
    jl, jk, jv = jpaged.prefill_paged(
        jcfg, jp, jnp.asarray(tokens), jnp.asarray(np.asarray(lens, np.int32)),
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(token_pages), jnp.asarray(offs))
    parts = paged.pack_prompts(prompts, pt, n, ROWS, PS)
    assert parts[0].shape == (1, n) and int((parts[2] >= 0).sum()) == N
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tl, tk2, tv2 = paged.prefill_packed_paged(
        cfg, tp, *(torch.from_numpy(a) for a in parts), tk, tv, MAX_LEN)
    assert tk2 is tk and tl.shape == (ROWS, cfg.vocab_size)
    _close(tl[:B], np.asarray(jl), LOGITS_TOL)
    written = np.zeros((P, PS), bool)
    for b, m in enumerate(lens):
        pos = np.arange(m)
        written[pt[b, pos // PS], pos % PS] = True
    for got, want, start in ((tk, jk, kp), (tv, jv, vp)):
        got = got.numpy()
        _close(got[:, written], np.asarray(want)[:, written], POOL_TOL)
        untouched = ~written
        untouched[0] = False  # the garbage page
        np.testing.assert_array_equal(got[:, untouched], start[:, untouched])


def test_attention_packed_sees_only_its_prompt_and_the_past():
    """attention_packed over a stream of four prompts and padding: each
    prompt's rows equal its own dense causal attention (_attention_full);
    tiles of 3 queries, which cut prompts in the middle, and a key span
    bounded by max_len give the one-tile result (the padding rows, which
    attend to padding, are nobody's); and a query's output is
    bit for bit unchanged when every key it must not see (another prompt's,
    a later position's) is replaced by noise."""
    from kuiperllama_tpu_torch.ops.attention import (_attention_full,
                                                     attention_packed, packed_tiles)

    lens, H, KH, hd = [5, 1, 7, 3], 4, 2, 8
    N = 20  # 16 tokens and 4 of padding
    seg = np.full((N,), -1, np.int64)
    pos = np.zeros((N,), np.int64)
    o = 0
    for i, m in enumerate(lens):
        seg[o:o + m], pos[o:o + m] = i, np.arange(m)
        o += m
    seg_t, pos_t = torch.from_numpy(seg), torch.from_numpy(pos)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((N, h, hd), generator=g) for h in (H, KH, KH))
    one = attention_packed(q, k, v, packed_tiles(pos_t, seg_t, N, N))
    o = 0
    for m in lens:
        want = _attention_full(q[None, o:o + m], k[None, o:o + m], v[None, o:o + m],
                               torch.arange(m)[None])[0]
        torch.testing.assert_close(one[o:o + m], want, rtol=1e-6, atol=1e-6)
        o += m
    for max_len in (N, 8):
        tiled = attention_packed(q, k, v, packed_tiles(pos_t, seg_t, max_len, 3))
        torch.testing.assert_close(tiled[:o], one[:o], rtol=1e-6, atol=1e-6)
    tiles = packed_tiles(pos_t, seg_t, 8, 3)
    assert [t[2] for t in tiles] == [0, 0, 0, 1, 4, 7, 10]
    for i in range(o):
        hidden = torch.from_numpy((seg != seg[i]) | (pos > pos[i]))[:, None, None]
        k2 = torch.where(hidden, torch.randn(k.shape, generator=g), k)
        v2 = torch.where(hidden, torch.randn(v.shape, generator=g), v)
        got = attention_packed(q, k2, v2, tiles)
        assert torch.equal(got[i], attention_packed(q, k, v, tiles)[i])
