"""The ablation and geometry tools (kuiperllama_tpu_torch/tools/{exp_step,
exp_diag,exp_big,exp_ablate}.py) on the CPU at a tiny config.

  * exp_step: its variants and JSON keys (the JAX tool's `ms_per_step`,
    `component_cost_ms`); every patched name (decoder.attention_dense,
    rmsnorm, apply_rope, sampling.sample_token, generate.sample_token) is
    the original object again after `run` and after an exception inside a
    variant; a megakernel route is refused, before the runs and when the
    rounds' launch counters show one.
  * exp_diag: the route at each cap equals the JAX package's rule, read off
    JAX `quant_matmul` itself (the block-diagonal GEMV iff K // 64 <= cap,
    its `_DIAG_MAX_GROUPS` patched), the JSON keeps the JAX tool's keys, and
    `ops/linear.py` GEMV_MAX_GROUPS is 64 again afterwards, an exception
    included.
  * exp_big: the route read from the launch counters (tools.route_of) into
    the JSON, which is what holds it (no --expect-big option), and a tiny
    run's JSON.
  * exp_ablate: every part of its JSON at --device cpu.
"""

import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuiperllama_tpu.ops.pallas import quant_matmul as jqm
from kuiperllama_tpu.quant import QuantArray
from kuiperllama_tpu_torch.config import tiny_config
from kuiperllama_tpu_torch.models import decoder
from kuiperllama_tpu_torch.ops import linear, sampling
from kuiperllama_tpu_torch.serving import generate
from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd
from kuiperllama_tpu_torch.tools import exp_ablate, exp_big, exp_diag, exp_step, route_of
from torch_threads import one_thread  # noqa: F401

CPU = torch.device("cpu")
PATCHED = [(decoder, "attention_dense"), (decoder, "rmsnorm"), (decoder, "apply_rope"),
           (sampling, "sample_token"), (generate, "sample_token")]


def _cfg(**kw):
    return tiny_config("llama2", dim=128, hidden_dim=256, vocab_size=256, seq_len=256, **kw)


def _originals():
    return [getattr(m, n) for m, n in PATCHED]


def test_exp_step_variants_and_restores(capsys, monkeypatch):
    monkeypatch.delenv("KT_FUSED_STEP", raising=False)
    before = _originals()
    out = exp_step.run(CPU, cfg=_cfg(), steps=4, cache_len=64, group=64)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert list(line["ms_per_step"]) == ["baseline", "no_attention", "no_rmsnorm",
                                         "no_rope", "no_argmax",
                                         "matmuls_plus_cache_only"]
    assert list(line["component_cost_ms"]) == ["attention", "rmsnorm", "rope", "argmax",
                                               "matmuls_plus_cache_only"]
    assert line["route"] == "layered" and line["baseline_tokens_equal"]
    assert all(a is b for a, b in zip(_originals(), before))

    assert all(len(r) == exp_step.ROUNDS for r in line["ms_per_step_rounds"].values())
    real = exp_step.decode_once

    def fails_without_norm(*a, **k):
        if decoder.rmsnorm is exp_step._identity_norm:
            raise RuntimeError("inside a variant")
        return real(*a, **k)

    monkeypatch.setattr(exp_step, "decode_once", fails_without_norm)
    with pytest.raises(RuntimeError, match="inside a variant"):
        exp_step.run(CPU, cfg=_cfg(), steps=4, cache_len=64, group=64)
    assert all(a is b for a, b in zip(_originals(), before))


def test_exp_step_ablations_reach_the_decode():
    """Each replacement is called by the Generator's decode, so each name is
    patched where the decode looks it up; the sampler's token is 7."""
    cfg = _cfg()
    params = exp_step.fuse_params(exp_step.random_params_device(
        cfg, device=CPU, quantize=True, dtype=torch.bfloat16))
    for tag, patches in exp_step.VARIANTS[1:5]:
        calls = {}
        with pytest.MonkeyPatch.context() as mp:
            for m, n, v in patches:
                def counted(*a, _v=v, _k=(m.__name__, n), **k):
                    calls[_k] = calls.get(_k, 0) + 1
                    return _v(*a, **k)
                mp.setattr(m, n, counted)
            gen = exp_step.generator(cfg, params, 6, 1, 64)
            _, rows = exp_step.decode_once(gen, 6, 1)
        assert len(calls) == len(patches) and min(calls.values()) > 0, tag
        if tag == "no_argmax":
            assert rows == [[7] * 6]


def test_exp_step_refuses_a_megakernel_route(monkeypatch):
    monkeypatch.setenv("KT_FUSED_STEP", "1")
    before = _originals()
    with pytest.raises(SystemExit, match="megakernel"):
        exp_step.run(CPU, cfg=_cfg(), steps=4, cache_len=64, group=64)
    assert all(a is b for a, b in zip(_originals(), before))

    # a Generator that says layered but launches a megakernel in the rounds
    monkeypatch.delenv("KT_FUSED_STEP", raising=False)
    monkeypatch.setattr(fd.fused_decode_step, "launches", fd.fused_decode_step.launches)
    real = exp_step.decode_once

    def launches_the_megakernel(*a, **k):
        fd.fused_decode_step.launches += 1
        return real(*a, **k)

    monkeypatch.setattr(exp_step, "decode_once", launches_the_megakernel)
    with pytest.raises(SystemExit, match="small megakernel route"):
        exp_step.run(CPU, cfg=_cfg(), steps=4, cache_len=64, group=64)
    assert all(a is b for a, b in zip(_originals(), before))


def _jax_route(K, N, cap, monkeypatch):
    """Which path JAX `quant_matmul` takes for one row at `cap`."""
    taken = []
    monkeypatch.setattr(jqm, "_DIAG_MAX_GROUPS", cap)
    monkeypatch.setattr(jqm, "_diag_gemv_xla",
                        lambda x2, q, s, g, *a: taken.append("diag") or jnp.zeros((1, N)))
    monkeypatch.setattr(jqm, "_quant_matmul_2d",
                        lambda x2, q, s, g, **k: taken.append("generic") or jnp.zeros((1, N)))
    w = QuantArray(jnp.zeros((K, N), jnp.int8), jnp.ones((K // 64, N), jnp.float32), 64)
    jqm.quant_matmul(jnp.ones((1, K), jnp.bfloat16), w)
    return taken[0]


@pytest.mark.parametrize("cap", exp_diag.CAPS)
def test_exp_diag_route_is_jax_rule(cap, monkeypatch):
    for K, _ in exp_diag.SHAPES:
        tag = _jax_route(K, 128, cap, monkeypatch)
        assert exp_diag.jax_tag(K, cap) == tag
        monkeypatch.setattr(linear, "GEMV_MAX_GROUPS", cap)
        assert linear.takes_gemv(1, K, 64) == (tag == "diag")
        assert not linear.takes_gemv(2, K, 64) and not linear.takes_gemv(1, K, 64, "exact")


def test_exp_diag_json_and_restores_the_cap(capsys, monkeypatch):
    shapes = [(K, 128) for K, _ in exp_diag.SHAPES]
    calls = []
    real = exp_diag.bench_quant_shape

    def spy(dev, K, N, M, **kw):
        calls.append((K, linear.GEMV_MAX_GROUPS, kw))
        return real(dev, K, N, M, **kw)

    monkeypatch.setattr(exp_diag, "bench_quant_shape", spy)
    out = exp_diag.run(CPU, shapes=shapes)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert linear.GEMV_MAX_GROUPS == 64
    for K, N in shapes:
        row = line[f"K{K}_N{N}"]
        assert row["groups"] == K // 64
        assert row["cap64_generic"]["kernel"] == "quant_gemm"
        assert row["cap176_diag"]["kernel"] == "quant_gemv"
        assert {"GBps", "us"} <= set(row["cap64_generic"])
    assert [(K, cap) for K, cap, _ in calls] == [(K, c) for K, _ in shapes for c in (64, 176)]
    assert all(kw == dict(group_size=64, variant="kernel-layered",
                          scales_dtype=torch.bfloat16, n_layers=4) for *_, kw in calls)

    monkeypatch.setattr(exp_diag, "bench_quant_shape",
                        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
    with pytest.raises(RuntimeError, match="boom"):
        exp_diag.run(CPU, shapes=shapes)
    assert linear.GEMV_MAX_GROUPS == 64


def test_exp_big_route_and_expect_big(capsys):
    """The route is measured and carried in the JSON; there is no
    --expect-big option (chip_smoke.py holds `route`)."""
    none = dict.fromkeys(("quant_gemv", "quant_gemm", "fused_decode_step",
                          "fused_decode_chunk", "fused_decode_step_big",
                          "paged_attention_flat"), 0)
    assert route_of(dict(none, quant_gemv=5)) == "layered"
    assert route_of(dict(none, fused_decode_step=3)) == "small"
    assert route_of(dict(none, fused_decode_chunk=1)) == "small"
    assert route_of(dict(none, fused_decode_step_big=3, quant_gemv=3)) == "big"
    assert exp_big.route_of is route_of and exp_step.route_of is route_of

    out = exp_big.run(CPU, cfg=_cfg(), hidden=320, layers=1, steps=6, cache_len=64)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["hidden_dim"] == 320 and line["n_layers"] == 1
    assert line["route"] == "layered" and line["plan"] is None
    # the JAX tool's byte count: weights and scales but the bf16 embedding,
    # plus a 256-slot bf16 KV window
    assert out["bytes_per_step"] > 256 * 2 * 2
    for key in ("tok_s", "effective_GBps", "ms_per_step", "pct_of_sheet_bw"):
        assert line[key] > 0
    assert out["route"] == route_of(out["launches"])

    with pytest.raises(SystemExit) as e:
        exp_big.main(["--device", "cpu", "--expect-big"])
    assert e.value.code == 2  # argparse: no such option


def test_exp_ablate_json_has_every_part(capsys):
    out = exp_ablate.run(CPU, cfg=_cfg(), steps=3)
    printed = capsys.readouterr().out
    line = json.loads(printed.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert list(line["shapes"]) == ["wqkv", "wo", "w13", "w2", "lm_head"]
    assert sorted(line["int8_chunk"], key=int) == ["256", "1024", "2048"]
    assert line["bf16_chunk"]["weight_bytes"] > line["weight_bytes_per_token"]
    assert line["small_vocab_chunk"]["vocab_size"] == 2048
    assert line["roofline_tok_s"] == pytest.approx(
        3350e9 / line["weight_bytes_per_token"])
    for text in ("weight bytes/token", "int8 chunk  cache=  256", "bf16 chunk",
                 "int8 tiny-vocab"):
        assert text in printed
    assert not re.search(r"819(\.0)?\s*GB", printed)  # no TPU bandwidth
    assert np.isfinite(line["int8_chunk"]["1024"]["ms_per_token"])
