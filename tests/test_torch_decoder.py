"""The port's decoder against the JAX forward on the tinychar fixtures (v0
fp32 and v3 INT8 group 64), on the same weights carried across by
`convert.from_jax_params`. Tolerances, max-abs error relative to
max|want| of the logits: exact mode 1e-4, fast mode 5e-3."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kuiperllama_tpu.checkpoint.binfmt import load_bin as jload
from kuiperllama_tpu.fuse import fuse_params as jfuse
from kuiperllama_tpu.models import decoder as jdec
from kuiperllama_tpu.ops.pallas import quant_matmul as jqm
from kuiperllama_tpu.params import to_device as jto
from kuiperllama_tpu_torch.checkpoint.binfmt import load_bin
from kuiperllama_tpu_torch.convert import from_jax_params
from kuiperllama_tpu_torch.fuse import fuse_params
from kuiperllama_tpu_torch.models import decoder as tdec
from kuiperllama_tpu_torch.params import to_device
from torch_threads import one_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
TOL = {"exact": 1e-4, "fast": 5e-3}


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _models(rel, family="llama2"):
    jc, jp = jload(os.path.join(ROOT, rel), family=family)
    jparams = jfuse(jto(jp))
    tc, _ = load_bin(os.path.join(ROOT, rel), family=family)
    return jc, jparams, tc, from_jax_params(jparams, device="cpu")


def _jax_forward(cfg, mode):
    """A fresh jit of the JAX forward, so the matmul mode set now is the one
    traced (the module-level `forward` caches its first trace per shape)."""
    jqm.set_quant_matmul_mode(mode)
    return jax.jit(lambda p, t, pos, c, m, lp: jdec.forward_inner(
        cfg, p, t, pos, c, kv_len_mask=m, last_pos=lp))


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("rel", ["tinychar/tinychar.bin",
                                 "tinychar/tinychar.q8.bin"])
def test_prefill_then_decode_logits(rel, mode):
    jc, jparams, tc, tparams = _models(rel)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jc.vocab_size, (1, 12)).astype(np.int32)
    S, T0 = 32, 8
    try:
        fwd = _jax_forward(jc, mode)
        jcache = jdec.init_kv_cache(jc, 1, S)
        tcache = tdec.init_kv_cache(tc, 1, S, device="cpu")
        pos = np.arange(T0, dtype=np.int32)[None]
        want, jcache = fwd(jparams, jnp.asarray(toks[:, :T0]), jnp.asarray(pos),
                           jcache, None, None)
        got, tcache = tdec.forward(tc, tparams, torch.from_numpy(toks[:, :T0]),
                                   torch.from_numpy(pos), tcache, mode=mode)
        assert got.shape == (1, T0, jc.vocab_size) and got.dtype == torch.float32
        assert _rel(got, want) <= TOL[mode], "prefill"
        for t in range(T0, toks.shape[1]):  # B = 1 decode: the GEMV route
            p = np.full((1, 1), t, np.int32)
            want, jcache = fwd(jparams, jnp.asarray(toks[:, t:t + 1]),
                               jnp.asarray(p), jcache, None, None)
            got, _ = tdec.decode_step(tc, tparams, torch.from_numpy(toks[:, t]),
                                      torch.from_numpy(p[:, 0]), tcache,
                                      mode=mode)
            assert _rel(got, np.asarray(want)[:, 0]) <= TOL[mode], f"pos {t}"
        np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                                   rtol=1e-4, atol=1e-3 if mode == "fast" else 1e-4)
    finally:
        jqm.set_quant_matmul_mode("fast")


def test_ragged_prefill_matches_jax():
    jc, jparams, tc, tparams = _models("tinychar_qwen2/tinychar.q8.bin", "qwen2")
    rng = np.random.default_rng(5)
    lens = [5, 16]
    toks = rng.integers(0, jc.vocab_size, (2, 16)).astype(np.int32)
    want, _ = jdec.prefill(jc, jparams, jnp.asarray(toks),
                           jdec.init_kv_cache(jc, 2, 32),
                           prompt_lens=jnp.asarray(lens, jnp.int32))
    got, _ = tdec.prefill(tc, tparams, torch.from_numpy(toks),
                          tdec.init_kv_cache(tc, 2, 32, device="cpu"),
                          prompt_lens=torch.tensor(lens, dtype=torch.int32))
    assert got.shape == (2, jc.vocab_size)
    assert _rel(got, want) <= TOL["fast"]


def test_fused_and_unfused_agree():
    tc, p = load_bin(os.path.join(ROOT, "tinychar/tinychar.q8.bin"))
    plain = to_device(p, device="cpu")
    fused = fuse_params(plain)
    toks = torch.tensor([[1, 5, 9, 20, 33]], dtype=torch.int32)
    a, ca = tdec.prefill(tc, plain, toks, tdec.init_kv_cache(tc, 1, 16, device="cpu"))
    b, cb = tdec.prefill(tc, fused, toks, tdec.init_kv_cache(tc, 1, 16, device="cpu"))
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ca["v"], cb["v"], rtol=1e-5, atol=1e-5)
    assert ca["k"].shape == (tc.n_layers, 1, 16, tc.n_kv_heads, tc.head_dim)


@pytest.mark.parametrize("maker", ["_hf_llama", "_hf_llama32", "_hf_qwen2"])
def test_prefill_logits_match_transformers(maker):
    """The port's forward against a tiny random HF model built locally, as
    tests/test_model_parity.py holds the JAX forward to it; the weights come
    through the JAX package's state-dict reader and `from_jax_params`."""
    import dataclasses

    import test_model_parity as hfp
    from kuiperllama_tpu.checkpoint.hf import config_from_hf, params_from_state_dict
    from kuiperllama_tpu_torch.config import ModelConfig, RopeScaling

    hf = getattr(hfp, maker)()
    jc = config_from_hf(hf.config.to_dict())
    sd = {k.removeprefix("model."): v.detach().numpy()
          for k, v in hf.state_dict().items()}
    params = from_jax_params(params_from_state_dict(jc, sd), device="cpu")
    fields = dataclasses.asdict(jc)
    if fields["rope_scaling"]:
        fields["rope_scaling"] = RopeScaling(**fields["rope_scaling"])
    tc = ModelConfig(**fields)
    toks = np.random.default_rng(7).integers(0, tc.vocab_size, (2, 12))
    with torch.no_grad():
        want = hf(torch.from_numpy(toks).long()).logits.numpy()
    pos = torch.arange(12, dtype=torch.int32).expand(2, 12)
    got, _ = tdec.forward(tc, params, torch.from_numpy(toks), pos,
                          tdec.init_kv_cache(tc, 2, 32, device="cpu"))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)


def test_sentinel_positions_drop_their_writes():
    """An admit prefill's rows of live slots pass the sentinel position S:
    their cache rows stay as they were (JAX's scatter drops the writes) and
    the admitted rows match JAX `forward_inner`, logits and cache."""
    jc, jparams, tc, tparams = _models("tinychar/tinychar.bin")
    rng = np.random.default_rng(9)
    B, T, S = 3, 8, 16
    toks = rng.integers(0, jc.vocab_size, (B, T)).astype(np.int32)
    lens = np.asarray([8, 1, 5], np.int32)
    admit = np.asarray([True, False, True])
    pos = np.where(admit[:, None], np.arange(T, dtype=np.int32), S).astype(np.int32)
    shape = (jc.n_layers, B, S, jc.n_kv_heads, jc.head_dim)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    mask = np.arange(S)[None] < lens[:, None]
    fwd = _jax_forward(jc, "fast")
    want, jcache = fwd(jparams, jnp.asarray(toks), jnp.asarray(pos),
                       dict(k=jnp.asarray(k0), v=jnp.asarray(v0)),
                       jnp.asarray(mask), jnp.asarray(lens - 1))
    tcache = dict(k=torch.from_numpy(k0.copy()), v=torch.from_numpy(v0.copy()))
    got, tcache = tdec.forward(tc, tparams, torch.from_numpy(toks),
                               torch.from_numpy(pos), tcache,
                               torch.from_numpy(mask),
                               last_pos=torch.from_numpy(lens - 1))
    np.testing.assert_array_equal(tcache["k"][:, 1].numpy(), k0[:, 1])
    np.testing.assert_array_equal(tcache["v"][:, 1].numpy(), v0[:, 1])
    rows = np.flatnonzero(admit)
    assert _rel(got[rows], np.asarray(want)[rows]) <= 1e-5
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name][:, rows].numpy(),
                                   np.asarray(jcache[name])[:, rows],
                                   rtol=1e-5, atol=1e-5)


def test_decode_past_the_cache_drops_its_write():
    """A decode step whose row sits at position S (a row that decoded past a
    full cache) leaves that row's cache as it was and gives JAX's logits
    for every row, the dropped one included."""
    jc, jparams, tc, tparams = _models("tinychar/tinychar.bin")
    rng = np.random.default_rng(11)
    S = 8
    toks = np.asarray([[5], [9]], np.int32)
    pos = np.asarray([[3], [S]], np.int32)
    shape = (jc.n_layers, 2, S, jc.n_kv_heads, jc.head_dim)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    want, jcache = _jax_forward(jc, "fast")(
        jparams, jnp.asarray(toks), jnp.asarray(pos),
        dict(k=jnp.asarray(k0), v=jnp.asarray(v0)), None, None)
    tcache = dict(k=torch.from_numpy(k0.copy()), v=torch.from_numpy(v0.copy()))
    got, _ = tdec.decode_step(tc, tparams, torch.from_numpy(toks[:, 0]),
                              torch.from_numpy(pos[:, 0]), tcache)
    for name, start in (("k", k0), ("v", v0)):
        np.testing.assert_array_equal(tcache[name][:, 1].numpy(), start[:, 1])
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                   rtol=1e-5, atol=1e-5)
    assert _rel(got, np.asarray(want)[:, 0]) <= 1e-5
