"""rmsnorm, rope, attention and sampling of the port against the JAX package,
on the same numpy inputs, within 1e-5 in fp32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kuiperllama_tpu.config import ROPE_HALF, ROPE_INTERLEAVED, RopeScaling
from kuiperllama_tpu.ops import attention as jatt
from kuiperllama_tpu.ops import rope as jrope
from kuiperllama_tpu.ops.rmsnorm import rmsnorm as jrmsnorm
from kuiperllama_tpu.ops.sampling import sample_token as jsample
from kuiperllama_tpu_torch.config import RopeScaling as TRopeScaling
from kuiperllama_tpu_torch.ops import attention as tatt
from kuiperllama_tpu_torch.ops import rope as trope
from kuiperllama_tpu_torch.ops.rmsnorm import rmsnorm as trmsnorm
from kuiperllama_tpu_torch.ops.sampling import (filter_logits, sample_greedy,
                                                sample_token)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_rmsnorm(rng):
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    for eps in (1e-5, 1e-6):
        np.testing.assert_allclose(trmsnorm(_t(x), _t(w), eps).numpy(),
                                   np.asarray(jrmsnorm(x, w, eps)), **TOL)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert trmsnorm(xb, _t(w), 1e-5).dtype == torch.bfloat16


SCALINGS = [None,
            ("llama3", dict(factor=32.0, low_freq_factor=1.0,
                            high_freq_factor=4.0,
                            original_max_position_embeddings=64)),
            ("linear", dict(factor=4.0))]


@pytest.mark.parametrize("scaling", SCALINGS, ids=["none", "llama3", "linear"])
@pytest.mark.parametrize("style", [ROPE_INTERLEAVED, ROPE_HALF])
def test_rope(rng, scaling, style):
    js = ts = None
    if scaling is not None:
        js = RopeScaling(rope_type=scaling[0], **scaling[1])
        ts = TRopeScaling(rope_type=scaling[0], **scaling[1])
    theta = 500000.0 if scaling else 10000.0
    jsin, jcos = jrope.rope_cache(128, 32, theta, scaling=js)
    tsin, tcos = trope.rope_cache(128, 32, theta, scaling=ts)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), **TOL)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), **TOL)

    pos = rng.integers(0, 128, (2, 6)).astype(np.int32)
    x = rng.standard_normal((2, 6, 4, 32)).astype(np.float32)
    s, c = jrope.gather_rope(jsin, jcos, jnp.asarray(pos))
    want = np.asarray(jrope.apply_rope(jnp.asarray(x), s, c, style))
    ts_, tc_ = trope.gather_rope(tsin, tcos, _t(pos))
    got = trope.apply_rope(_t(x), ts_, tc_, style).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _attn_inputs(rng, B, T, H, KH, S, hd=16):
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KH, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KH, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", ["causal", "length_mask", "blocked", "decode"])
def test_attention_dense(rng, case):
    B, H, KH, S = 2, 4, 2, 32
    T = {"causal": 8, "length_mask": 8, "blocked": 16, "decode": 1}[case]
    q, k, v = _attn_inputs(rng, B, T, H, KH, S)
    if case == "decode":
        pos = np.array([[5], [17]], np.int32)
    else:
        pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    mask = None
    if case == "length_mask":
        lens = np.array([3, 8])
        mask = np.arange(S)[None, :] < lens[:, None]
    q_block = 4 if case == "blocked" else None
    want = np.asarray(jatt.attention_dense(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        None if mask is None else jnp.asarray(mask), q_block=q_block))
    got = tatt.attention_dense(_t(q), _t(k), _t(v), _t(pos),
                               None if mask is None else _t(mask),
                               q_block=q_block).numpy()
    assert np.isfinite(got).all()  # padded rows (empty mask) stay finite
    np.testing.assert_allclose(got, want, **TOL)


def test_attention_auto_blocks_long_prompts(monkeypatch, rng):
    q, k, v = _attn_inputs(rng, 1, 8, 2, 1, 8)
    pos = torch.arange(8, dtype=torch.int32)[None]
    full = tatt.attention_dense(_t(q), _t(k), _t(v), pos)
    monkeypatch.setattr(tatt, "_BLOCK_THRESHOLD_BYTES", 16)
    monkeypatch.setattr(tatt, "_Q_BLOCK", 2)
    calls = []
    real = tatt._attention_full
    monkeypatch.setattr(tatt, "_attention_full",
                        lambda *a: calls.append(1) or real(*a))
    blocked = tatt.attention_dense(_t(q), _t(k), _t(v), pos)
    assert len(calls) == 4
    torch.testing.assert_close(blocked, full, rtol=1e-6, atol=1e-6)


def test_greedy_matches_jax(rng):
    logits = rng.standard_normal((3, 50)).astype(np.float32)
    logits[1, [7, 9]] = 10.0  # a tie: both take the first index
    want = np.asarray(jsample(jnp.asarray(logits), jax.random.PRNGKey(0)))
    got = sample_greedy(_t(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        sample_token(_t(logits), None, temperature=0.0).numpy(), want)


def _support_jax(logits, **kw):
    """The set of tokens the JAX sampler draws from, read off many draws."""
    keys = jax.random.split(jax.random.PRNGKey(1), 4000)
    draws = jax.vmap(lambda k: jsample(jnp.asarray(logits), k, **kw))(keys)
    return set(np.asarray(draws).ravel().tolist())


def test_top_k_mask_matches_jax():
    logits = np.linspace(0.0, 0.3, 40, dtype=np.float32)[::-1].copy()[None]
    got = filter_logits(_t(logits), temperature=0.7, top_k=5)
    kept = set(np.flatnonzero(np.isfinite(got.numpy()[0])).tolist())
    assert kept == set(range(5))
    assert kept == _support_jax(logits, temperature=0.7, top_k=5)


def test_top_p_keeps_the_nucleus():
    """Reference: keep the smallest prefix of the sorted tokens whose
    exclusive cumulative probability stays below top_p."""
    logits = np.array([[2.0, 1.0, 0.5, 0.2, -1.0, -3.0]], np.float32)
    p = np.exp(logits[0]) / np.exp(logits[0]).sum()
    order = np.argsort(-logits[0])
    excl = np.cumsum(p[order]) - p[order]
    for top_p in (0.3, 0.7, 0.9, 0.99):
        want = set(order[excl < top_p].tolist())
        got = filter_logits(_t(logits), temperature=1.0, top_p=top_p)
        assert set(np.flatnonzero(np.isfinite(got.numpy()[0])).tolist()) == want


def test_sampled_distribution_and_seed():
    logits = torch.tensor([[1.0, 0.0, -0.5, 2.0]]).repeat(20000, 1)
    gen = torch.Generator().manual_seed(123)
    draws = sample_token(logits, gen, temperature=1.0)
    freq = torch.bincount(draws.long(), minlength=4).float() / draws.numel()
    torch.testing.assert_close(freq, torch.softmax(logits[0], -1), atol=0.015,
                               rtol=0)
    again = sample_token(logits, torch.Generator().manual_seed(123), temperature=1.0)
    assert torch.equal(draws, again)
