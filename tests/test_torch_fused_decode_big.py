"""The port's big-model megakernel route (ops/kernels/fused_decode_big.py and
the Generator's KT_FUSED_BIG route) against the JAX package's, on the CPU.

The JAX side runs `fused_decode_step_big` and the fused Generator under the
Pallas interpreter, as tests/test_fused_decode_big.py does; the port runs
the kernel's plain version, which its wrapper takes for CPU tensors. JAX
scale rows are padded to 16, as the JAX `params.to_device` pads them: the
big plan needs the padded count to equal d / g, so the step geometry is
dim 512 at group 32 (16 group rows), and the tile budget is patched on both
sides to 192 KiB so that the plan splits into NQ = 4 qkv tiles, NO = 2 wo
row tiles (fp32 scales) and NT = 4 FFN tiles.

Tolerances: x_final and every layer's new K/V row max-abs error relative to
max|want|, 1e-2 with bf16 activations (as tests/test_torch_fused_decode.py),
where layer 0's new rows, made from the same input on both sides, are also
held within one bf16 ulp (a K row at its head's magnitude); 2e-2 with int8
activations. Both sides round to bf16 and requantize to int8 at the same
points and sum the wo and w2 tiles in tile order. With bf16 activations the
readings are 0 (bit-equal, every case); with int8 activations XLA fuses the
jitted `(Pi * d) * s` sum into another fp32 order (up to 8.6e-6 apart from
the same helper run eagerly, which the port matches bit for bit), a last-bit
difference flips an int8 rounding downstream, and x_final read 1.06e-2
(llama2) and 9.3e-3 (qwen2), layer 1's rows up to 8.3e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuiperllama_tpu.config import tiny_config as jtiny
from kuiperllama_tpu.models import decoder as jdec
from kuiperllama_tpu.ops.linear import linear as jlinear
from kuiperllama_tpu.ops.pallas import fused_decode as jfd
from kuiperllama_tpu.ops.pallas import fused_decode_big as jbig
from kuiperllama_tpu.serving.generate import Generator as JGenerator
from kuiperllama_tpu_torch.config import preset_config, tiny_config
from kuiperllama_tpu_torch.convert import from_jax_params
from kuiperllama_tpu_torch.models import decoder
from kuiperllama_tpu_torch.ops.kernels import fused_decode as tfd
from kuiperllama_tpu_torch.ops.kernels import fused_decode_big as tfb
from kuiperllama_tpu_torch.ops.linear import linear
from kuiperllama_tpu_torch.serving import generate as tgen
from kuiperllama_tpu_torch.serving.generate import Generator
from test_torch_fused_decode import (_assert_greedy_equiv, _bf16_ulp,
                                     _jax_params, _stand_ins)
from torch_threads import one_thread  # noqa: F401

DIMS = dict(dim=512, n_heads=4, n_kv_heads=2, hidden_dim=512, vocab_size=256)
G = 32
BUDGET = 192 * 1024
PRESETS = ("tinyllama-1.1b", "llama3.2-1b", "qwen2.5-0.5b", "llama2-7b",
           "llama3-8b")


@pytest.fixture
def small_tiles(monkeypatch):
    monkeypatch.setattr(jbig, "_TILE_BUDGET", BUDGET)
    monkeypatch.setattr(tfb, "_TILE_BUDGET", BUDGET)


def _pair(family, seed=5, seq_len=64, **over):
    dims = dict(DIMS, **over)
    jc = jtiny(family, seq_len=seq_len, **dims)
    tc = tiny_config(family, seq_len=seq_len, **dims)
    jp = _jax_params(jc, True, G, seed=seed)
    tp = from_jax_params(jp, device="cpu", dtype=torch.bfloat16)
    return jc, tc, jp, tp


def _big_step(jc, tc, jp, tp, x0_id, kc, vc, pos, int8_a):
    """One big-kernel step on both sides from the same caches (numpy [L, A,
    KV] in the caches' dtype). Returns (jax x, port x, jax caches, port
    caches)."""
    sin, cos = jdec.build_rope(jc)
    jk, jv = (jnp.asarray(a) for a in (kc, vc))
    xj, kj, vj = jbig.fused_decode_step_big(
        jc, jp, jp["tok_emb"][jnp.asarray([x0_id])], jk, jv, jnp.int32(pos),
        sin, cos, int8_a=int8_a)
    tsin, tcos = decoder.build_rope(tc, "cpu")
    kt = torch.from_numpy(np.asarray(kc, np.float32)).to(_torch_dtype(kc))
    vt = torch.from_numpy(np.asarray(vc, np.float32)).to(_torch_dtype(vc))
    xt, kt2, vt2 = tfb.fused_decode_step_big(
        tc, tp, tp["tok_emb"][[x0_id]], kt, vt,
        torch.tensor([pos], dtype=torch.int32), tsin, tcos, int8_a=int8_a)
    assert kt2 is kt and vt2 is vt  # the new rows land in place
    return (np.asarray(xj, np.float32), xt.float().numpy(),
            (np.asarray(kj, np.float32), np.asarray(vj, np.float32)),
            (kt.float().numpy(), vt.float().numpy()))


def _torch_dtype(a):
    return torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32


def _hold(xj, xt, caches_j, caches_t, pos, hd, int8_a):
    tol = 2e-2 if int8_a else 1e-2
    assert xt.shape == xj.shape and np.isfinite(xt).all()
    rel = np.abs(xt - xj).max() / np.abs(xj).max()
    assert rel <= tol, rel
    for (got, want), roped in zip(zip(caches_t, caches_j), (True, False)):
        assert np.array_equal(got[:, :pos], want[:, :pos])
        assert np.array_equal(got[:, pos + 1:], want[:, pos + 1:])
        row_g, row_w = got[:, pos], want[:, pos]
        for li in range(row_w.shape[0]):
            assert np.abs(row_g[li] - row_w[li]).max() <= tol * np.abs(row_w[li]).max()
        if int8_a:
            continue
        if roped:
            heads = np.abs(row_w[0]).reshape(-1, hd)
            ulp = np.repeat(_bf16_ulp(heads.max(axis=-1)), hd)
        else:
            ulp = _bf16_ulp(row_w[0])
        assert (np.abs(row_g[0] - row_w[0]) <= ulp).all()


@pytest.mark.parametrize("family", ["llama2", "qwen2"])
@pytest.mark.parametrize("int8_a", [True, False])
def test_big_step_matches_jax(family, int8_a, small_tiles):
    jc, tc, jp, tp = _pair(family)
    plan = tfb.plan_big(tp["blocks"], torch.bfloat16, 32)
    assert plan == jbig.plan_big(jp["blocks"], jnp.bfloat16, 32)
    assert plan["NQ"] >= 2 and plan["NO"] >= 2 and plan["NT"] >= 4, plan
    L, KV, A, pos = jc.n_layers, jc.kv_dim, 32, 9
    rng = np.random.default_rng(11)
    kc = jnp.asarray(rng.standard_normal((L, A, KV)), jnp.bfloat16)
    vc = jnp.asarray(rng.standard_normal((L, A, KV)), jnp.bfloat16)
    xj, xt, cj, ct = _big_step(jc, tc, jp, tp, 7, np.asarray(kc), np.asarray(vc),
                               pos, int8_a)
    _hold(xj, xt, cj, ct, pos, jc.head_dim, int8_a)


def test_big_step_at_slot_zero_and_fp32_cache(small_tiles):
    """pos 0 (no history: the new token alone) with an fp32 cache."""
    jc, tc, jp, tp = _pair("llama2", seed=6)
    L, KV, A = jc.n_layers, jc.kv_dim, 16
    z = np.zeros((L, A, KV), np.float32)
    xj, xt, cj, ct = _big_step(jc, tc, jp, tp, 3, z, z.copy(), 0, False)
    _hold(xj, xt, cj, ct, 0, jc.head_dim, False)
    assert np.array_equal(ct[0], cj[0]) and np.array_equal(xt, xj)


def test_big_multi_step_teacher_forced(small_tiles):
    """Six consecutive big-kernel steps on both sides, each side threading
    its own cache, fed the same tokens (the JAX side's greedy picks): the
    logits stay within the step tolerance at every step, so the rows each
    step writes are read back correctly by the next."""
    jc, tc, jp, tp = _pair("llama2", seed=9)
    L, A = jc.n_layers, 32
    cache = jdec.init_kv_cache(jc, batch=1, max_len=A, dtype=jnp.bfloat16)
    last, cache = jdec.prefill(jc, jp, jnp.asarray([[3, 1, 4]], jnp.int32), cache)
    KH, hd = jc.n_kv_heads, jc.head_dim
    jk = cache["k"].reshape(L, A, KH * hd)
    jv = cache["v"].reshape(L, A, KH * hd)
    kt = torch.from_numpy(np.asarray(jk, np.float32)).to(torch.bfloat16)
    vt = torch.from_numpy(np.asarray(jv, np.float32)).to(torch.bfloat16)
    sin, cos = jdec.build_rope(jc)
    tsin, tcos = decoder.build_rope(tc, "cpu")
    token = int(jnp.argmax(last[0]))
    for pos in range(3, 9):
        xj, jk, jv = jbig.fused_decode_step_big(
            jc, jp, jp["tok_emb"][jnp.asarray([token])], jk, jv, jnp.int32(pos),
            sin, cos, int8_a=True)
        want = np.asarray(jlinear(xj, jp["lm_head"]), np.float32)
        xt, _, _ = tfb.fused_decode_step_big(
            tc, tp, tp["tok_emb"][[token]], kt, vt,
            torch.tensor([pos], dtype=torch.int32), tsin, tcos, int8_a=True)
        got = linear(xt, tp["lm_head"]).float().numpy()
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel <= 2e-2, (pos, rel)
        token = int(np.argmax(want))  # teacher forcing


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("kind,g", [("int8", 64), ("int8", 256),
                                    ("int8_bf16s", 64), ("int8_bf16s", 256),
                                    ("bf16", 0)])
def test_plan_big_matches_jax(name, kind, g, monkeypatch):
    jb, tb = _stand_ins(name, kind != "bf16", g, kind == "int8_bf16s")
    for budget in (None, 2 * (1 << 20)):
        if budget:
            monkeypatch.setattr(jbig, "_TILE_BUDGET", budget)
            monkeypatch.setattr(tfb, "_TILE_BUDGET", budget)
        for active_len in (256, 1024):
            for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                             (jnp.float32, torch.float32)):
                want = jbig.plan_big(jb, jdt, active_len)
                assert tfb.plan_big(tb, tdt, active_len) == want, (
                    name, kind, g, budget, active_len, jdt)
                assert tfb.fits_vmem_big(tb, tdt, active_len) == (want is not None)


def test_plan_big_cases_of_the_route():
    """The plans the route rests on: Llama-2-7B and Llama-3-8B plan at group
    64 (bf16 scales) and at group 256 with fp32 scales, not at group 256
    with bf16 scales (the wo row tile would be 4096 x 4096); dense weights
    never plan."""
    _, b64 = _stand_ins("llama2-7b", True, 64, True)
    assert tfb.plan_big(b64, torch.bfloat16, 256) == dict(
        TQ=2048, NQ=6, TR=2048, NO=2, ht=256, NT=43)
    _, b8 = _stand_ins("llama3-8b", True, 64, True)
    plan8 = tfb.plan_big(b8, torch.bfloat16, 256)
    assert (plan8["NQ"], plan8["NO"], plan8["ht"], plan8["NT"]) == (3, 2, 512, 28)
    for name in ("llama2-7b", "llama3-8b"):
        _, bf = _stand_ins(name, True, 256, True)
        assert tfb.plan_big(bf, torch.bfloat16, 256) is None
        _, f32 = _stand_ins(name, True, 256, False)
        assert tfb.plan_big(f32, torch.bfloat16, 256) is not None
        _, dense = _stand_ins(name, False, 0, False)
        assert tfb.plan_big(dense, torch.bfloat16, 256) is None


def _tiny_vmem(monkeypatch):
    """The small plan's budget shrunk on both sides (the big plan keeps its
    own, bound at import), so that a tiny model takes the big route."""
    monkeypatch.setattr(jfd, "_VMEM_LIMIT", 1024)
    monkeypatch.setattr(tfd, "_VMEM_LIMIT", 1024)


def test_big_generator_tokens_equal_jax(monkeypatch):
    monkeypatch.setenv("KT_FUSED_BIG", "1")
    _tiny_vmem(monkeypatch)
    jc, tc, jp, tp = _pair("qwen2", seed=3, seq_len=128, vocab_size=320)
    jgen = JGenerator(jc, jp, cache_len=96, cache_dtype=jnp.bfloat16,
                      fused_step=True, chunk=5)
    tgen_ = Generator(tc, tp, cache_len=96, cache_dtype=torch.bfloat16,
                      fused_step=True, chunk=5)
    assert jgen._fused_ok(1) and tgen_._fused_ok(1)
    assert not tfd.fits_vmem(tp["blocks"], torch.bfloat16, 256)
    calls = []
    real = tgen.fused_decode_step_big
    monkeypatch.setattr(tgen, "fused_decode_step_big",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    prompt = [1, 20, 33, 45, 60, 7]
    want, _, _ = jgen.generate_ids(prompt, max_new_tokens=12)
    got, _, _ = tgen_.generate_ids(prompt, max_new_tokens=12)
    assert len(got) == 12 and len(calls) == 11  # one big step per decode step
    _assert_greedy_equiv(jc, jp, prompt, want, got)


def _route_model():
    cfg = tiny_config("llama2", seq_len=64, **DIMS)
    jc = jtiny("llama2", seq_len=64, **DIMS)
    tp = from_jax_params(_jax_params(jc, True, G, seed=1), device="cpu",
                         dtype=torch.bfloat16)
    return cfg, tp


def _record_routes(monkeypatch):
    seen = []
    for name in ("fused_decode_step", "fused_decode_step_big"):
        real = getattr(tgen, name)
        monkeypatch.setattr(tgen, name, lambda *a, _n=name, _r=real, **k:
                            seen.append(_n) or _r(*a, **k))
    return seen


def test_small_plan_wins_when_both_fit(monkeypatch):
    monkeypatch.setenv("KT_FUSED_BIG", "1")
    cfg, tp = _route_model()
    assert tfd.fits_vmem(tp["blocks"], torch.bfloat16, 256)
    assert tfb.fits_vmem_big(tp["blocks"], torch.bfloat16, 256)
    seen = _record_routes(monkeypatch)
    gen = Generator(cfg, tp, cache_len=64, cache_dtype=torch.bfloat16,
                    fused_step=True, chunk=4)
    gen.generate_ids([1, 2, 3], max_new_tokens=5)
    assert seen == ["fused_decode_step"] * 4


def test_big_off_keeps_the_layered_route(monkeypatch):
    monkeypatch.delenv("KT_FUSED_BIG", raising=False)
    _tiny_vmem(monkeypatch)
    cfg, tp = _route_model()
    seen = _record_routes(monkeypatch)
    gen = Generator(cfg, tp, cache_len=64, cache_dtype=torch.bfloat16,
                    fused_step=True, chunk=4)
    assert not gen._fused_ok(1)
    monkeypatch.setenv("KT_FUSED_BIG", "0")
    assert not gen._fused_ok(1)
    monkeypatch.setenv("KT_FUSED_BIG", "1")
    assert gen._fused_ok(1)
    monkeypatch.setenv("KT_FUSED_BIG", "0")
    monkeypatch.setattr(Generator, "_fused_ok", lambda self, B: True)
    ids, _, _ = gen.generate_ids([1, 2, 3], max_new_tokens=5)
    assert len(ids) == 5 and not seen


def test_big_chunk_leaves_route_when_window_outgrows_plan(monkeypatch):
    """decode_chunk re-checks the big plan for its window and decodes
    layered when it says no (generate.py:87-96 in the JAX package)."""
    monkeypatch.setenv("KT_FUSED_BIG", "1")
    _tiny_vmem(monkeypatch)
    cfg, tp = _route_model()
    windows = []
    monkeypatch.setattr(tgen, "fits_vmem_big",
                        lambda blocks, dt, alen: windows.append(alen) or alen < 64)
    seen = _record_routes(monkeypatch)
    gen = Generator(cfg, tp, cache_len=64, cache_dtype=torch.bfloat16,
                    fused_step=True, chunk=4)
    monkeypatch.setattr(Generator, "_fused_ok", lambda self, B: True)
    ids, _, _ = gen.generate_ids([1, 2, 3], max_new_tokens=9)
    assert len(ids) == 9
    assert windows and all(a == 64 for a in windows)  # window = the whole cache
    assert not seen  # every chunk left the route


def test_plain_version_rejects_model_beyond_plan():
    cfg = preset_config("llama2-7b", n_layers=1)
    _, blocks = _stand_ins("llama2-7b", True, 256, True)
    with pytest.raises(ValueError):
        tfb.fused_decode_step_big_ref(cfg, dict(blocks=blocks), None,
                                      torch.zeros((1, 256, 4096)), None,
                                      torch.tensor([0]), None, None)
