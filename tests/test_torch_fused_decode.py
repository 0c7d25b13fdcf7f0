"""The port's B = 1 decode megakernel route (ops/kernels/fused_decode.py and
the Generator's fused_step) against the JAX package's, on the CPU.

The JAX side runs `_fused_step` / the fused Generator under the Pallas
interpreter, as tests/test_fused_decode.py does; the port runs the
megakernel's plain version, which its wrapper takes for CPU tensors. The
JAX quantized weights carry scale rows padded to 16, as the JAX
`params.to_device` pads them, because the padded row count decides the
GEMV activation type in both megakernels.

Tolerances: x_final and every layer's new K/V row max-abs error relative
to max|want| 1e-2; layer 0's new rows, made from the same input on both
sides, within one bf16 ulp (a K row at the magnitude of its head's row:
rope sums two products, so a one-ulp difference in a large input can land
on a small output). Both sides round to bf16 at the same points and every
GEMV matches the JAX helpers bit for bit; what differs is the fp32
summation order of the dense products and the attention (XLA contracts over
the masked KV lanes in its own blocking). One bf16 ulp of difference there
can flip a rounding of the int8-activation quantization downstream.
Measured x_final errors: 0 (bit-equal) on 9 of the 14 step geometries,
7.7e-4 and 6.3e-3 with dense weights, up to 5.4e-3 with int8 activations.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuiperllama_tpu.checkpoint.binfmt import load_bin as jload
from kuiperllama_tpu.config import preset_config as jpreset
from kuiperllama_tpu.config import tiny_config as jtiny
from kuiperllama_tpu.fuse import fuse_params as jfuse
from kuiperllama_tpu.models import decoder as jdec
from kuiperllama_tpu.ops import tuning as jtuning
from kuiperllama_tpu.ops.pallas import fused_decode as jfd
from kuiperllama_tpu.ops.rope import rope_cache as jrope_cache
from kuiperllama_tpu.params import random_params as jrandom
from kuiperllama_tpu.params import to_device as jto
from kuiperllama_tpu.quant import QuantArray, pad_scale_rows
from kuiperllama_tpu.quant import quantize_q80 as jq80
from kuiperllama_tpu.serving.generate import Generator as JGenerator
from kuiperllama_tpu_torch.checkpoint.binfmt import load_bin
from kuiperllama_tpu_torch.config import preset_config, tiny_config
from kuiperllama_tpu_torch.convert import from_jax_params
from kuiperllama_tpu_torch.fuse import fuse_params
from kuiperllama_tpu_torch.models import decoder
from kuiperllama_tpu_torch.ops import tuning
from kuiperllama_tpu_torch.ops.kernels import fused_decode as tfd
from kuiperllama_tpu_torch.ops.rope import rope_cache
from kuiperllama_tpu_torch.params import random_params, to_device
from kuiperllama_tpu_torch.quant import QuantTensor, quantize_q80
from kuiperllama_tpu_torch.serving.generate import Generator
from torch_threads import one_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
QUANT_NAMES = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def _jax_params(cfg, quant, g, seed=5, dtype=jnp.bfloat16, lm_quant=False):
    """JAX params in `dtype` (bf16 by default); quantized weights (and the
    lm_head when `lm_quant`) with scale rows padded to 16."""
    params = jto(jrandom(cfg, seed=seed), dtype=dtype)

    def q(w):
        qa = jq80(w, group_size=g)
        return QuantArray(q=qa.q, s=pad_scale_rows(qa.s, 16), group_size=g)

    if quant:
        blocks = dict(params["blocks"])
        for name in QUANT_NAMES:
            blocks[name] = q(blocks[name])
        params = dict(params, blocks=blocks)
    if lm_quant:
        params = dict(params, lm_head=q(params["lm_head"]))
    return jfuse(params)


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _step_pair(family, quant, g, nt, pos=5, A=32, **dims):
    """One megakernel step on both sides from the same inputs. Returns
    (jax x_final, port x_final, jax caches, port caches, port blocks)."""
    jc = jtiny(family, seq_len=64, **dims)
    tc = tiny_config(family, seq_len=64, **dims)
    jp = _jax_params(jc, quant, g)
    tp = from_jax_params(jp, device="cpu", dtype=torch.bfloat16)
    L, KV = jc.n_layers, jc.kv_dim
    rng = np.random.default_rng(11)
    kc = rng.standard_normal((L, A, KV)).astype(np.float32)
    vc = rng.standard_normal((L, A, KV)).astype(np.float32)
    token = 7
    sin, cos = jdec.build_rope(jc)
    xj, kj, vj = jfd._fused_step(
        jp["tok_emb"][jnp.asarray([token])], jnp.asarray(kc, jnp.bfloat16),
        jnp.asarray(vc, jnp.bfloat16), jnp.int32(pos), sin[pos], cos[pos], jp,
        H=jc.n_heads, KH=jc.n_kv_heads, hd=jc.head_dim, g=g if quant else 0,
        eps=jc.norm_eps, quant=quant, rope_style=jc.rope_style, n_tiles=nt)
    tsin, tcos = decoder.build_rope(tc, "cpu")
    kt = torch.from_numpy(kc).to(torch.bfloat16)
    vt = torch.from_numpy(vc).to(torch.bfloat16)
    xt, kt2, vt2 = tfd.fused_decode_step_ref(
        tc, tp, tp["tok_emb"][[token]], kt, vt,
        torch.tensor([pos], dtype=torch.int32), tsin, tcos, n_tiles=nt)
    assert kt2 is kt and vt2 is vt  # the new rows land in place
    return (np.asarray(xj, np.float32), xt.float().numpy(),
            (np.asarray(kj, np.float32), np.asarray(vj, np.float32)),
            (kt.float().numpy(), vt.float().numpy()), tp["blocks"])


def _check_step(family, quant, g, nt, **dims):
    """Holds one step to the stated tolerances; returns the port's blocks."""
    pos = 5
    xj, xt, (kj, vj), (kt, vt), blocks = _step_pair(family, quant, g, nt, pos,
                                                    **dims)
    assert xt.shape == xj.shape and np.isfinite(xt).all()
    rel = np.abs(xt - xj).max() / np.abs(xj).max()
    assert rel <= 1e-2, rel
    hd = xt.shape[-1] // dims.get("n_heads", 4)
    for got, want, roped in ((kt, kj, True), (vt, vj, False)):
        # history slots are untouched
        assert np.array_equal(got[:, :pos], want[:, :pos])
        assert np.array_equal(got[:, pos + 1:], want[:, pos + 1:])
        row_g, row_w = got[:, pos], want[:, pos]
        # every layer's new row within the x_final tolerance; layer 0's,
        # computed from the same input on both sides, within one bf16 ulp
        assert np.abs(row_g - row_w).max() <= 1e-2 * np.abs(row_w).max()
        if roped:
            # rope sums two products: one ulp of difference in an input lands
            # on its partner, which may be far smaller, so a K row is held to
            # one ulp at the magnitude of its head's row
            heads = np.abs(row_w[0]).reshape(-1, hd)
            ulp = np.repeat(_bf16_ulp(heads.max(axis=-1)), hd)
        else:
            ulp = _bf16_ulp(row_w[0])
        assert (np.abs(row_g[0] - row_w[0]) <= ulp).all()
    return blocks


@pytest.mark.parametrize("family", ["llama2", "qwen2"])
@pytest.mark.parametrize("quant", [True, False])
def test_step_matches_jax(family, quant):
    _check_step(family, quant, 32, 1)


@pytest.mark.parametrize("family", ["llama2", "qwen2"])
@pytest.mark.parametrize("nt", [1, 2])
def test_step_ffn_tiles_match_jax(family, nt):
    _check_step(family, True, 32, nt, dim=256, n_heads=4, n_kv_heads=2,
                hidden_dim=256)


@pytest.mark.parametrize("family,nt,hidden,want", [
    ("llama2", 1, 512, (True, True, True, True)),
    ("llama2", 2, 512, (True, True, True, True)),
    ("qwen2", 1, 256, (True, True, True, True)),
    ("qwen2", 2, 256, (True, True, True, False)),
])
def test_step_int8_activation_matches_jax(family, nt, hidden, want):
    """dim 256 at g = 8: 32 group rows, so the GEMVs quantize the activation
    per group (w2 only while its tile keeps >= 32 rows)."""
    dims = dict(dim=256, n_heads=4, n_kv_heads=2, hidden_dim=hidden)
    blocks = _check_step(family, True, 8, nt, **dims)
    assert tfd.gemv_int8_flags(blocks, nt) == want


@pytest.mark.parametrize("family", ["llama2", "qwen2"])
def test_step_padded_group_rows_match_jax(family):
    """dim 192 at g = 8: 24 group rows, 32 once padded to 16 as the JAX
    package pads them. The padded count picks the int8 activation; the
    unpadded one would pick bf16 and round differently."""
    dims = dict(dim=192, n_heads=4, n_kv_heads=2, hidden_dim=192)
    blocks = _check_step(family, True, 8, 1, **dims)
    assert blocks["wqkv"].s.shape[-2] == 24  # the port keeps K/g rows
    assert not tuning.gemv_int8_auto(24)
    assert tfd.gemv_int8_flags(blocks, 1) == (True, True, True, False)


def test_step_at_slot_zero_and_fp32_cache():
    """pos 0 (no history: the new token alone) with an fp32 cache."""
    cfg = tiny_config("llama2", seq_len=64)
    jc = jtiny("llama2", seq_len=64)
    jp = _jax_params(jc, True, 32)
    tp = from_jax_params(jp, device="cpu", dtype=torch.bfloat16)
    L, A, KV = cfg.n_layers, 16, cfg.kv_dim
    sin, cos = jdec.build_rope(jc)
    xj, kj, _ = jfd._fused_step(
        jp["tok_emb"][jnp.asarray([3])], jnp.zeros((L, A, KV), jnp.float32),
        jnp.zeros((L, A, KV), jnp.float32), jnp.int32(0), sin[0], cos[0], jp,
        H=jc.n_heads, KH=jc.n_kv_heads, hd=jc.head_dim, g=32, eps=jc.norm_eps,
        quant=True, rope_style=jc.rope_style, n_tiles=1)
    kt = torch.zeros((L, A, KV))
    vt = torch.zeros((L, A, KV))
    tsin, tcos = decoder.build_rope(cfg, "cpu")
    xt, kt, _ = tfd.fused_decode_step(cfg, tp, tp["tok_emb"][[3]], kt, vt,
                                      torch.tensor([0], dtype=torch.int32),
                                      tsin, tcos)
    xj = np.asarray(xj, np.float32)
    assert np.abs(xt.float().numpy() - xj).max() <= 1e-2 * np.abs(xj).max()
    assert np.array_equal(kt.numpy(), np.asarray(kj, np.float32))


@pytest.mark.parametrize("style", ["half", "interleaved"])
def test_rope_matrix_matches_jax(style):
    hd = 16
    sin, cos = rope_cache(32, hd, 10000.0)
    jsin, jcos = jrope_cache(32, hd, 10000.0)
    for p in (0, 7, 31):
        got = tfd.rope_matrix(sin[p], cos[p], style, hd).numpy()
        want = np.asarray(jfd.rope_matrix(jsin[p], jcos[p], style, hd))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the matrix is the two-product rotation the plain version applies
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, hd))
                         .astype(np.float32))
    from kuiperllama_tpu_torch.ops.rope import apply_rope

    R = tfd.rope_matrix(sin[7], cos[7], style, hd).double()
    want = apply_rope(x[None], sin[7], cos[7], style)[0]
    np.testing.assert_allclose((x.double() @ R).numpy(), want.numpy(),
                               rtol=0, atol=1e-6)


class _Spec:
    """Shape and dtype only: what the JAX plan reads from an array."""

    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.size = int(np.prod(shape))


def _stand_ins(name, quant, g, s_bf16):
    """Fused blocks of preset `name` as shape-only stand-ins on both sides:
    JAX scale rows padded to 16, the port's exactly K/g."""
    cfg = preset_config(name)
    L, d, h, kv = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.kv_dim
    shapes = dict(wqkv=(d, d + 2 * kv), wo=(d, d), w13=(d, 2 * h), w2=(h, d))
    jb, tb = {}, {}
    for n, (K, N) in shapes.items():
        if quant:
            s_dt = jnp.bfloat16 if s_bf16 else jnp.float32
            jb[n] = QuantArray(q=_Spec((L, K, N), np.int8),
                               s=_Spec((L, -(-(K // g) // 16) * 16, N), s_dt),
                               group_size=g)
            tb[n] = QuantTensor(
                q=torch.empty((L, K, N), dtype=torch.int8, device="meta"),
                s=torch.empty((L, K // g, N), device="meta",
                              dtype=torch.bfloat16 if s_bf16 else torch.float32),
                group_size=g)
        else:
            jb[n] = _Spec((L, K, N), jnp.bfloat16)
            tb[n] = torch.empty((L, K, N), dtype=torch.bfloat16, device="meta")
    return jb, tb


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "llama3.2-1b",
                                  "qwen2.5-0.5b", "llama2-7b"])
@pytest.mark.parametrize("kind,g", [("int8", 64), ("int8", 256),
                                    ("int8_bf16s", 64), ("int8_bf16s", 256),
                                    ("bf16", 0)])
@pytest.mark.parametrize("active_len", [256, 1024])
def test_plan_tiles_matches_jax(name, kind, g, active_len):
    jb, tb = _stand_ins(name, kind != "bf16", g, kind == "int8_bf16s")
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        want = jfd.plan_tiles(jb, jdt, active_len)
        got = tfd.plan_tiles(tb, tdt, active_len)
        assert got == want, (name, kind, g, active_len, jdt)
        if got is None:
            continue
        # the activation type of every GEMV, from JAX's padded row counts
        rows = [jb[n].s.shape[-2] for n in ("wqkv", "wo", "w13")] if kind != "bf16" else []
        if rows:
            ht = jb["w2"].q.shape[-2] // got
            rows.append(-(-(ht // g) // 8) * 8)
            assert tfd.gemv_int8_flags(tb, got) == tuple(
                jtuning.gemv_int8_auto(r) for r in rows)
    if name == "llama2-7b":
        assert tfd.plan_tiles(tb, torch.bfloat16, active_len) is None


def _assert_greedy_equiv(cfg, params, prompt, want, got):
    """Greedy outputs must match UNLESS the divergence step is an exact
    logit tie (a copy of tests/test_fused_decode.py's check): on the first
    mismatch, teacher-force the `want` prefix through the JAX oracle and
    require the two candidate tokens' logits to be within bf16 noise; stop
    comparing after (sequences legitimately differ past a tie)."""
    if got == want:
        return
    i = next(k for k, (a, b) in enumerate(zip(want, got)) if a != b)
    ids = list(prompt) + list(want[:i])
    cache = jdec.init_kv_cache(cfg, batch=1, max_len=128, dtype=jnp.bfloat16)
    logits, _ = jdec.prefill(cfg, params, jnp.asarray([ids], jnp.int32), cache)
    v = np.asarray(logits[0])
    gap = abs(float(v[want[i]]) - float(v[got[i]]))
    assert gap <= 2e-3 * max(1.0, abs(float(v.max()))), (
        f"divergence at step {i} is not a tie: {want[i]} vs {got[i]}, "
        f"logit gap {gap}")


@pytest.mark.parametrize("rel,family", [
    ("tinychar/tinychar.q8.bin", "llama2"),
    ("tinychar_qwen2/tinychar.q8.bin", "qwen2"),
])
def test_fused_generator_tokens_equal_jax(rel, family):
    path = os.path.join(ROOT, rel)
    prompt = [1, 20, 33, 45, 60, 7, 90]
    jc, jp = jload(path, family=family)
    tc, tp = load_bin(path, family=family)
    jparams = jfuse(jto(jp, dtype=jnp.bfloat16))
    jgen = JGenerator(jc, jparams, cache_len=128, cache_dtype=jnp.bfloat16,
                      fused_step=True)
    tgen = Generator(tc, fuse_params(to_device(tp, device="cpu",
                                               dtype=torch.bfloat16)),
                     cache_len=128, cache_dtype=torch.bfloat16, fused_step=True)
    assert jgen._fused_ok(1) and tgen._fused_ok(1)
    before = tfd.fused_decode_step.launches
    want, _, _ = jgen.generate_ids(prompt, max_new_tokens=16)
    got, _, _ = tgen.generate_ids(prompt, max_new_tokens=16)
    assert tfd.fused_decode_step.launches == before  # the CPU runs no kernel
    assert len(got) == 16
    _assert_greedy_equiv(jc, jparams, prompt, want, got)


@pytest.mark.parametrize("quant", [True, False])
def test_fused_generator_equals_unfused(quant):
    """End-to-end greedy generation on a tiny bf16 llama2: the port's fused
    Generator equals its unfused one (as the JAX package's own test holds
    its two routes)."""
    cfg = tiny_config("llama2", seq_len=64)
    params = to_device(random_params(cfg, seed=5), device="cpu",
                       dtype=torch.bfloat16)
    if quant:
        blocks = dict(params["blocks"])
        for name in QUANT_NAMES:
            blocks[name] = quantize_q80(blocks[name].float(), group_size=32)
        params = dict(params, blocks=blocks)
    params = fuse_params(params)
    prompt = [1, 7, 3, 2]
    base = Generator(cfg, params, cache_len=64, cache_dtype=torch.bfloat16,
                     fused_step=False)
    fast = Generator(cfg, params, cache_len=64, cache_dtype=torch.bfloat16,
                     fused_step=True)
    want, _, _ = base.generate_ids(prompt, max_new_tokens=12)
    got, _, _ = fast.generate_ids(prompt, max_new_tokens=12)
    assert got == want, (got, want)


def test_fused_route_choice():
    """Auto takes the route only on a CUDA device; B > 1, unfused weights and
    a model beyond the plan stay layered."""
    cfg = tiny_config("llama2", seq_len=64)
    params = fuse_params(to_device(random_params(cfg, seed=1), device="cpu",
                                   dtype=torch.bfloat16))
    assert not Generator(cfg, params)._fused_ok(1)  # auto on the CPU
    assert Generator(cfg, params, fused_step=True)._fused_ok(1)
    assert not Generator(cfg, params, fused_step=True)._fused_ok(2)
    assert not Generator(cfg, params, fused_step=False)._fused_ok(1)
    unfused = to_device(random_params(cfg, seed=1), device="cpu")
    assert not Generator(cfg, unfused, fused_step=True)._fused_ok(1)
    _, big = _stand_ins("llama2-7b", True, 256, True)
    assert not tfd.fits_vmem(big, torch.bfloat16, 256)
    _, small = _stand_ins("tinyllama-1.1b", True, 256, True)
    assert tfd.plan_tiles(small, torch.bfloat16, 256) == 2  # as in JAX
    assert tfd.plan_tiles(small, torch.bfloat16, 1024) == 2


def test_chunk_leaves_route_when_window_outgrows_plan(monkeypatch):
    """decode_chunk re-checks the plan for its window and takes the layered
    step when the plan says no (generate.py:87-96 in the JAX package)."""
    from kuiperllama_tpu_torch.serving import generate as tgen

    cfg = tiny_config("llama2", seq_len=64)
    params = fuse_params(to_device(random_params(cfg, seed=1), device="cpu",
                                   dtype=torch.bfloat16))
    seen = []
    monkeypatch.setattr(tgen, "fits_vmem",
                        lambda blocks, dt, alen: seen.append(alen) or alen < 64)
    calls = []
    real = tgen._fused_logits
    monkeypatch.setattr(tgen, "_fused_logits",
                        lambda *a: calls.append(1) or real(*a))
    gen = Generator(cfg, params, cache_len=64, cache_dtype=torch.bfloat16,
                    fused_step=True, chunk=4)
    monkeypatch.setattr(Generator, "_fused_ok", lambda self, B: True)
    ids, _, _ = gen.generate_ids([1, 2, 3], max_new_tokens=9)
    assert len(ids) == 9
    assert seen and all(a == 64 for a in seen)  # window = the whole cache
    assert not calls  # every chunk left the route


def test_plain_version_rejects_model_beyond_plan():
    """A model beyond the plan (Llama-2-7B) raises rather than running."""
    cfg = preset_config("llama2-7b", n_layers=1)
    _, blocks = _stand_ins("llama2-7b", True, 256, True)
    with pytest.raises(ValueError):
        tfd.fused_decode_step_ref(cfg, dict(blocks=blocks), None,
                                  torch.zeros((1, 256, 4096)), None,
                                  torch.tensor([0]), None, None)


def test_phase_times_sums_each_phase_over_layers():
    """`phase_times` reads a trace of 2 + 5 L timestamps (ns): the start,
    the end of each layer's five phases, and the end of the final rmsnorm."""
    L = 2
    trace = torch.tensor([0, 1000, 2000, 3000, 4000, 5000,  # layer 0: 1 us each
                          7000, 9000, 11000, 13000, 15000,  # layer 1: 2 us each
                          15500],                           # final rmsnorm
                         dtype=torch.int64)
    got = tfd.phase_times(trace, L)
    assert got == {**{name: 3.0 for name in tfd.PHASES}, "final": 0.5,
                   "total": 15.5}
