"""The port's greedy chunk megakernel route (ops/kernels/fused_decode.py
`fused_decode_chunk` and the Generator's KT_FUSED_CHUNK route) against the
JAX package's, on the CPU, and the route knobs of ops/tuning.py.

The JAX side runs `fused_decode_chunk` and the Generator under the Pallas
interpreter, as tests/test_fused_decode.py does; the port runs the chunk
kernel's plain version, which its wrapper takes for CPU tensors. JAX scale
rows are padded to 16, as the JAX `params.to_device` pads them.

Tokens are compared by the tie rule of tests/test_fused_decode.py:142-163:
at the first difference the two tokens' logits (the port's, at that step,
from the same prefix) must lie within 2e-3 of max(1, max|logit|), and
nothing after it is compared. The K/V rows of the steps up to there are
held to max-abs error relative to max|want| 1e-2 per layer, as the
per-step kernel's tests hold them; with int8 activations (dim 256, g 8,
quantized lm_head) 2e-2. The readings: tokens equal in all seven cases;
rows bit-equal with quantized weights and bf16 activations, 4.6e-3 with
dense weights (XLA's dense products sum in another fp32 order), 6.0e-3
with int8 activations.
"""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuiperllama_tpu.checkpoint.binfmt import load_bin as jload
from kuiperllama_tpu.config import tiny_config as jtiny
from kuiperllama_tpu.fuse import fuse_params as jfuse
from kuiperllama_tpu.models import decoder as jdec
from kuiperllama_tpu.ops import tuning as jtuning
from kuiperllama_tpu.ops.pallas import fused_decode as jfd
from kuiperllama_tpu.ops.pallas import fused_decode_big as jbig
from kuiperllama_tpu.ops.pallas import quant_matmul as jqm
from kuiperllama_tpu.params import to_device as jto
from kuiperllama_tpu.serving.generate import Generator as JGenerator
from kuiperllama_tpu_torch.checkpoint.binfmt import load_bin
from kuiperllama_tpu_torch.config import tiny_config
from kuiperllama_tpu_torch.convert import from_jax_params
from kuiperllama_tpu_torch.fuse import fuse_params
from kuiperllama_tpu_torch.models import decoder
from kuiperllama_tpu_torch.ops import linear as tlinear
from kuiperllama_tpu_torch.ops import tuning
from kuiperllama_tpu_torch.ops.kernels import fused_decode as tfd
from kuiperllama_tpu_torch.ops.kernels import fused_decode_big as tfb
from kuiperllama_tpu_torch.params import to_device
from kuiperllama_tpu_torch.serving import generate as tgen
from kuiperllama_tpu_torch.serving.generate import Generator
from test_torch_fused_decode import _assert_greedy_equiv, _jax_params
from torch_threads import one_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
STEPS = 6


@pytest.mark.parametrize("family,quant,g,params_dt,cache_dt,lm_quant,dims", [
    ("llama2", True, 32, jnp.bfloat16, jnp.bfloat16, False, {}),
    ("llama2", False, 0, jnp.bfloat16, jnp.bfloat16, False, {}),
    ("qwen2", True, 32, jnp.bfloat16, jnp.bfloat16, True, {}),
    ("qwen2", False, 0, jnp.bfloat16, jnp.bfloat16, False, {}),
    # fp32 params: step 0 starts from the fp32 x0, later steps from bf16 rows
    ("llama2", True, 32, jnp.float32, jnp.bfloat16, False, {}),
    # an fp32 cache: history p in fp32, the chunk's own rows' p in bf16
    ("qwen2", True, 32, jnp.bfloat16, jnp.float32, False, {}),
    # int8 activations in every GEMV and in the lm_head (32 group rows)
    ("llama2", True, 8, jnp.bfloat16, jnp.bfloat16, True,
     dict(dim=256, n_heads=4, n_kv_heads=2, hidden_dim=512)),
])
def test_chunk_matches_jax(family, quant, g, params_dt, cache_dt, lm_quant, dims):
    jc = jtiny(family, seq_len=64, **dims)
    tc = tiny_config(family, seq_len=64, **dims)
    jp = _jax_params(jc, quant, g, dtype=params_dt, lm_quant=lm_quant)
    tp = from_jax_params(jp, device="cpu", dtype=torch.bfloat16
                         if params_dt == jnp.bfloat16 else torch.float32)
    L, KV, A, pos, tok = jc.n_layers, jc.kv_dim, 32, 5, 7
    rng = np.random.default_rng(13)
    kc = np.asarray(jnp.asarray(rng.standard_normal((L, A, KV)), cache_dt), np.float32)
    vc = np.asarray(jnp.asarray(rng.standard_normal((L, A, KV)), cache_dt), np.float32)
    sin, cos = jdec.build_rope(jc)
    want, kj, vj = jfd.fused_decode_chunk(
        jc, jp, jp["tok_emb"][jnp.asarray([tok])], jnp.asarray(kc, cache_dt),
        jnp.asarray(vc, cache_dt), jnp.int32(pos), sin, cos, STEPS)
    want = np.asarray(want).tolist()
    kj, vj = np.asarray(kj, np.float32), np.asarray(vj, np.float32)
    tdt = torch.bfloat16 if cache_dt == jnp.bfloat16 else torch.float32
    kt, vt = (torch.from_numpy(a).to(tdt) for a in (kc, vc))
    tsin, tcos = decoder.build_rope(tc, "cpu")
    logits = []
    got, kt2, _ = tfd.fused_decode_chunk(
        tc, tp, tp["tok_emb"][[tok]], kt, vt, torch.tensor([pos], dtype=torch.int32),
        tsin, tcos, STEPS)
    assert kt2 is kt and got.dtype == torch.int32
    kt, vt = (torch.from_numpy(a).to(tdt) for a in (kc, vc))
    again, _, _ = tfd.fused_decode_chunk_ref(
        tc, tp, tp["tok_emb"][[tok]], kt, vt, torch.tensor([pos], dtype=torch.int32),
        tsin, tcos, STEPS, logits=logits)
    got = got.tolist()
    assert again.tolist() == got and len(logits) == STEPS
    assert tfd.lm_int8_activation(tp["lm_head"], tc.dim) == (g == 8)
    n = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), STEPS)
    if n < STEPS:
        row = logits[n]
        gap = abs(float(row[got[n]]) - float(row[want[n]]))
        assert gap <= 2e-3 * max(1.0, row.abs().max().item()), (n, got, want)
    tol = 2e-2 if g == 8 else 1e-2
    for t, j in ((kt.float().numpy(), kj), (vt.float().numpy(), vj)):
        assert np.array_equal(t[:, :pos], j[:, :pos])
        assert np.array_equal(t[:, pos + STEPS:], j[:, pos + STEPS:])
        for li in range(L):
            rows_t, rows_j = t[li, pos:pos + n + 1], j[li, pos:pos + n + 1]
            assert np.abs(rows_t - rows_j).max() <= tol * np.abs(rows_j).max()


def test_chunk_plain_rounding_points():
    """The two rounding points of the chunk kernel that a per-step loop
    would miss, shown on the plain version: with fp32 params, step 1 starts
    from the bf16-rounded embedding row, not the fp32 one; with an fp32
    cache, the chunk's own rows' p is rounded to bf16 while history's is
    not."""
    cfg = tiny_config("llama2", seq_len=64)
    jc = jtiny("llama2", seq_len=64)
    tp = from_jax_params(_jax_params(jc, True, 32, dtype=jnp.float32),
                         device="cpu", dtype=torch.float32)
    L, KV, A = cfg.n_layers, cfg.kv_dim, 16
    sin, cos = decoder.build_rope(cfg, "cpu")
    kc, vc = torch.zeros((L, A, KV)), torch.zeros((L, A, KV))
    toks, _, _ = tfd.fused_decode_chunk_ref(
        cfg, tp, tp["tok_emb"][[3]], kc, vc, torch.tensor([0], dtype=torch.int32),
        sin, cos, 2)
    # step 1 by the per-step plain version from the fp32 row differs from the
    # chunk's step 1 (from the bf16 row) in its new K row
    k1, v1 = kc.clone(), vc.clone()
    k1[:, 1] = 0
    tfd.fused_decode_step_ref(cfg, tp, tp["tok_emb"][[int(toks[0])]], k1, v1,
                              torch.tensor([1], dtype=torch.int32), sin, cos)
    emb = tp["tok_emb"][int(toks[0])]
    assert not torch.equal(emb, emb.to(torch.bfloat16).float())
    assert not torch.equal(k1[0, 1], kc[0, 1])
    # bf16 p for the chunk's own rows: the attention of a row against one
    # chunk row differs from the same row taken as fp32 history
    q = torch.randn(4, 16)
    k_new, v_new = torch.randn(2, 16), torch.randn(2, 16)
    kv = torch.randn(3, 32).to(torch.bfloat16).float()
    scale = tfd.attention_scale(16)
    as_hist = tfd._attend_ref(q, k_new, v_new, kv, kv, scale, torch.float32)
    as_rec = tfd._attend_ref(q, k_new, v_new, kv[:0], kv[:0], scale,
                             torch.float32, k_rec=kv, v_rec=kv)
    assert not torch.equal(as_hist, as_rec)
    assert (as_hist - as_rec).abs().max() < 2e-2


@pytest.mark.parametrize("rel,family", [
    ("tinychar/tinychar.q8.bin", "llama2"),
    ("tinychar_g256/tinychar.q8.bin", "llama2"),
    ("tinychar_qwen2/tinychar.q8.bin", "qwen2"),
])
def test_chunk_generator_tokens_equal_jax(rel, family, monkeypatch):
    monkeypatch.setenv("KT_FUSED_CHUNK", "1")
    path = os.path.join(ROOT, rel)
    prompt = [1, 20, 33, 45, 60, 7, 90]
    jc, jp = jload(path, family=family)
    tc, tp = load_bin(path, family=family)
    jparams = jfuse(jto(jp, dtype=jnp.bfloat16))
    jgen = JGenerator(jc, jparams, cache_len=112, cache_dtype=jnp.bfloat16,
                      fused_step=True)
    tgen_ = Generator(tc, fuse_params(to_device(tp, device="cpu",
                                                dtype=torch.bfloat16)),
                      cache_len=112, cache_dtype=torch.bfloat16, fused_step=True)
    chunks = []
    real = tgen.fused_decode_chunk
    monkeypatch.setattr(tgen, "fused_decode_chunk",
                        lambda *a, **k: chunks.append(a[-1]) or real(*a, **k))
    want, _, _ = jgen.generate_ids(prompt, max_new_tokens=20)
    got, _, _ = tgen_.generate_ids(prompt, max_new_tokens=20)
    assert chunks == [19] and len(got) == 20  # the whole decode in one chunk
    _assert_greedy_equiv(jc, jparams, prompt, want, got)


def test_sampling_keeps_the_per_step_route(monkeypatch):
    """temperature > 0 (or top-k, top-p) keeps the per-step megakernel with
    KT_FUSED_CHUNK=1; greedy takes one chunk launch per chunk."""
    monkeypatch.setenv("KT_FUSED_CHUNK", "1")
    cfg = tiny_config("llama2", seq_len=64)
    tp = from_jax_params(_jax_params(jtiny("llama2", seq_len=64), True, 32,
                                      seed=2),
                         device="cpu", dtype=torch.bfloat16)
    seen = []
    for name in ("fused_decode_step", "fused_decode_chunk"):
        real = getattr(tgen, name)
        monkeypatch.setattr(tgen, name, lambda *a, _n=name, _r=real, **k:
                            seen.append(_n) or _r(*a, **k))
    gen = Generator(cfg, tp, cache_len=64, cache_dtype=torch.bfloat16,
                    fused_step=True, chunk=4)
    gen.generate_ids([1, 2, 3], max_new_tokens=5, temperature=0.7)
    assert seen == ["fused_decode_step"] * 4
    seen.clear()
    gen.generate_ids([1, 2, 3], max_new_tokens=5, top_k=3)
    assert seen == ["fused_decode_step"] * 4
    seen.clear()
    gen.generate_ids([1, 2, 3], max_new_tokens=9)
    assert seen == ["fused_decode_chunk"] * 2


def test_chunk_freezes_nothing_and_advances_pos_by_steps(monkeypatch):
    """Inside a chunk a row that emits a stop token is not frozen and pos
    moves by `steps` (generate.py:124-127 in the JAX package); the host's
    truncation at the first stop token gives the list the run without a
    stop token gives, cut there."""
    monkeypatch.setenv("KT_FUSED_CHUNK", "1")
    cfg = tiny_config("llama2", seq_len=64)
    tp = from_jax_params(_jax_params(jtiny("llama2", seq_len=64), True, 32,
                                      seed=2),
                         device="cpu", dtype=torch.bfloat16)
    gen = Generator(cfg, tp, cache_len=64, cache_dtype=torch.bfloat16,
                    fused_step=True, chunk=8)
    ids, _, _ = gen.generate_ids([1, 2, 3], max_new_tokens=9)
    stop = ids[2]
    chunks = []
    real = tgen.decode_chunk
    monkeypatch.setattr(tgen, "decode_chunk",
                        lambda *a, **k: chunks.append(real(*a, **k)) or chunks[-1])
    cut, _, _ = gen.generate_ids([1, 2, 3], max_new_tokens=9, stop_ids=[stop])
    assert cut == ids[:ids.index(stop)]
    if stop in ids[:1]:
        return  # the prefill's token stopped the row: no chunk ran
    (toks, token, pos, _, done), = chunks
    assert toks[0].tolist() == ids[1:9]  # the chunk ran on past the stop
    assert int(pos) == 3 + 8 and int(token) == ids[8] and bool(done)


def test_knob_defaults_equal_jax(monkeypatch):
    for knob in ("KT_FUSED_STEP", "KT_FUSED_CHUNK", "KT_FUSED_BIG"):
        monkeypatch.delenv(knob, raising=False)
    assert tuning.fused_step_env() is None
    assert not tuning.fused_chunk_on() and not tuning.fused_big_on()
    assert tuning.BIG_INT8 == jbig._BIG_INT8
    assert tuning.GEMV_INT8_MIN_GROUPS == jtuning.GEMV_INT8_MIN_GROUPS
    assert all(tuning.gemv_int8_auto(n) == jtuning.gemv_int8_auto(n)
               for n in range(1, 129))
    assert tfb._TILE_BUDGET == jbig._TILE_BUDGET == 9 * (1 << 20)
    assert tfd._VMEM_LIMIT == jfd._VMEM_LIMIT == tfb._VMEM_LIMIT
    assert tlinear.GEMV_MAX_GROUPS == jqm._DIAG_MAX_GROUPS == 64
    jlinear = importlib.import_module("kuiperllama_tpu.ops.linear")
    assert tlinear.PREFILL_DEQUANT_ROWS == jlinear._XLA_PREFILL_M == 256
    for knob, on in (("KT_FUSED_CHUNK", tuning.fused_chunk_on),
                     ("KT_FUSED_BIG", tuning.fused_big_on)):
        monkeypatch.setenv(knob, "1")
        assert on()
        monkeypatch.setenv(knob, "0")
        assert not on()
    monkeypatch.setenv("KT_FUSED_STEP", "0")
    assert tuning.fused_step_env() is False
    monkeypatch.setenv("KT_FUSED_STEP", "1")
    assert tuning.fused_step_env() is True


def test_fused_step_knob_overrides_auto(monkeypatch):
    """KT_FUSED_STEP=1 takes the megakernel route on the CPU where auto
    would not; 0 turns it off; an explicit fused_step wins over both."""
    cfg = tiny_config("llama2", seq_len=64)
    tp = from_jax_params(_jax_params(jtiny("llama2", seq_len=64), True, 32,
                                      seed=2),
                         device="cpu", dtype=torch.bfloat16)
    monkeypatch.delenv("KT_FUSED_STEP", raising=False)
    assert not Generator(cfg, tp)._fused_ok(1)
    monkeypatch.setenv("KT_FUSED_STEP", "1")
    assert Generator(cfg, tp)._fused_ok(1)
    assert not Generator(cfg, tp, fused_step=False)._fused_ok(1)
    monkeypatch.setenv("KT_FUSED_STEP", "0")
    assert not Generator(cfg, tp)._fused_ok(1)
    assert Generator(cfg, tp, fused_step=True)._fused_ok(1)
