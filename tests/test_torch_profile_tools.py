"""The step-profiling tools (kuiperllama_tpu_torch/tools/{profile_decode,
profile2,profile_paged}.py) on the CPU at a tiny config, and the paged
decoder's `_DEBUG_SKIP_WRITES` against the JAX package's.

  * `_DEBUG_SKIP_WRITES`: with the flag on, the port's `decode_chunk_paged`
    leaves the pools bit-equal to before, and its greedy tokens equal JAX
    `decode_chunk_paged`'s with JAX's flag on (its paged Pallas kernel
    interpreted, the setup of tests/test_torch_paged.py); both flags are
    restored in `finally`, JAX's jit cache cleared on both sides of it.
  * profile_decode and profile2 at --device cpu: the JSON carries the JAX
    tool's printed quantities under their names; the graph-chained helper
    (`tools.chain_time`) through a graph cache (CpuGraph, the CPU stand-in
    of tests/test_torch_graphs.py) returns the x of the eager loop exactly.
  * profile_paged: its three variants, the attribution, and every patched
    name is the original object again after `run`, and after an exception
    inside a variant.
  * every one of the ten tools defaults to the card: without one it exits
    non-zero and writes nothing.
"""

import importlib
import json
import os
import re

import numpy as np
import pytest
import torch

from kuiperllama_tpu.models import paged as jpaged
from kuiperllama_tpu_torch.config import tiny_config
from kuiperllama_tpu_torch.models import paged
from kuiperllama_tpu_torch.ops.linear import linear
from kuiperllama_tpu_torch.quant import quantize_q80
from kuiperllama_tpu_torch.serving import graphs
from kuiperllama_tpu_torch.tools import chain_time, profile2, profile_decode, profile_paged

from test_torch_graphs import CpuGraph
from test_torch_paged import MAX_LEN, _decode_both, model, prefilled  # noqa: F401
from torch_threads import one_thread  # noqa: F401

CPU = torch.device("cpu")


def _cfg():
    return tiny_config("llama2", dim=128, hidden_dim=256, vocab_size=256, seq_len=256)


def _last_json(capsys):
    out = capsys.readouterr().out
    return out, json.loads(out.strip().splitlines()[-1])


def test_skip_writes_matches_jax_and_keeps_pools(model, prefilled):  # noqa: F811
    pos = prefilled["lens"].copy()
    before_k, before_v = (t.clone() for t in prefilled["t"][1:])
    try:
        jpaged._DEBUG_SKIP_WRITES = True
        paged._DEBUG_SKIP_WRITES = True
        jpaged.decode_chunk_paged.clear_cache()
        (jt, _, jpos, _, _, _, _), (tt, _, tpos, tk, tv, _) = \
            _decode_both(model, prefilled, 6, pos, MAX_LEN)
    finally:
        jpaged._DEBUG_SKIP_WRITES = False
        paged._DEBUG_SKIP_WRITES = False
        jpaged.decode_chunk_paged.clear_cache()
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    assert torch.equal(tk, before_k) and torch.equal(tv, before_v)
    # and the flag off writes: the same chunk moves the pools
    _, (_, _, _, tk2, _, _) = _decode_both(model, prefilled, 6, pos, MAX_LEN)
    assert not torch.equal(tk2, before_k)


def test_chain_time_graph_equals_eager_loop(monkeypatch):
    monkeypatch.setattr(graphs, "STEP_GRAPH", CpuGraph)
    gen = torch.Generator().manual_seed(0)
    ws = [quantize_q80(torch.randn((128, 64), generator=gen), 64) for _ in range(3)]
    x0 = torch.randn((1, 128), generator=gen).to(torch.bfloat16)

    def step(x, i):
        return profile2.feedback(linear(x, ws[i % len(ws)]), x)

    want = x0.clone()
    for i in range(7):
        want = step(want, i)
    cache = graphs.GraphCache(CPU)
    dt, got = chain_time(step, x0, iters=7, reps=2, graphs=cache)
    assert torch.equal(got, want) and dt > 0
    assert cache.prefill.captures == 1 and cache.prefill.replays == 2
    _, eager = chain_time(step, x0, iters=7, reps=1)
    assert torch.equal(eager, want)


def test_profile_decode_json_carries_the_jax_quantities(capsys):
    out = profile_decode.run(CPU, cfg=_cfg(), cache_len=64, iters=2)
    printed, line = _last_json(capsys)
    assert line == json.loads(json.dumps(out))
    for text in ("== quant_matmul microbench (M=1) ==", "sum(layers) + lm_head",
                 "== full decode_step:", "== donated decode_step:"):
        assert text in printed
    assert list(line["shapes"]) == ["wqkv", "wo", "w13", "w2", "lm_head"]
    for row in line["shapes"].values():
        assert {"K", "N", "kernel", "us", "GBps"} <= set(row)
    for key in ("sum_layers_ms", "full_decode_step_ms", "donated_decode_step_ms"):
        assert line[key] > 0
    assert line["device"] == "cpu" and line["card"] is None
    assert line["tokens_equal"] and not line["donated_is_graph_replay"]
    assert set(line["launches"]) == {"quant_gemv", "quant_gemm", "fused_decode_step",
                                     "fused_decode_chunk", "fused_decode_step_big",
                                     "paged_attention_flat"}


def test_profile_decode_names_the_kernel_of_each_route():
    """TinyLlama's w2 (88 groups at g 64) takes the GEMM at one row; the
    others the GEMV; at two rows every shape takes the GEMM."""
    cfg = tiny_config("llama2", dim=128, hidden_dim=5632, vocab_size=256, n_layers=1)
    rows, _ = profile_decode.microbench(CPU, cfg, 1)
    assert {k: r["kernel"] for k, r in rows.items()} == dict(
        wqkv="gemv", wo="gemv", w13="gemv", w2="gemm", lm_head="gemv")
    rows, _ = profile_decode.microbench(CPU, cfg, 2)
    assert {r["kernel"] for r in rows.values()} == {"gemm"}


def test_profile2_json_and_trace(capsys, tmp_path):
    out = profile2.run(CPU, cfg=_cfg(), cache_len=64, iters=3, trace_dir=str(tmp_path))
    printed, line = _last_json(capsys)
    assert "== chained quant_matmul (B=1) ==" in printed
    assert "== decode_chunk/step:" in printed and "trace written to" in printed
    assert list(line["shapes"]) == ["wqkv", "wo", "w13", "w2", "lm_head"]
    for key in ("sum_layers_ms", "decode_chunk_ms_per_step", "roofline_ms",
                "pct_of_roofline", "weight_bytes"):
        assert line[key] > 0
    assert line["trace"] == out["trace"] == str(tmp_path / "trace.json")
    assert (tmp_path / "trace.json").is_file()
    assert not re.search(r"819(\.0)?\s*GB", printed)  # no TPU bandwidth
    assert "data sheet" in line["bandwidth_share_of"]


def test_profile_paged_restores_its_patches(capsys, monkeypatch):
    flag, attn = paged._DEBUG_SKIP_WRITES, paged.paged_attention_flat
    kw = dict(cfg=_cfg(), batch=2, max_len=32, page_size=8, steps=3, prompt_len=4)
    out = profile_paged.run(CPU, **kw)
    printed, line = _last_json(capsys)
    assert "[prof] attribution: attention" in printed
    assert list(line["ms_per_step"]) == [t for t, _ in profile_paged.VARIANTS]
    a = line["attribution_ms"]
    ms = line["ms_per_step"]
    assert a["rest"] == pytest.approx(ms["no scatter, attention stubbed"])
    assert a["scatter"] == pytest.approx(ms["full step"] - ms["no KV scatter"])
    assert out["tokens_equal_eager"] and len(out["tokens"]) == 2
    # from zeroed pools only the full step writes them; the stubbed variant
    # launches no paged attention (on the CPU no variant launches a kernel)
    assert line["writes_pools"] == {"full step": True, "no KV scatter": False,
                                    "no scatter, attention stubbed": False}
    assert list(line["launches_by_variant"]) == list(ms)
    assert all(set(n) == set(line["launches"]) and not any(n.values())
               for n in line["launches_by_variant"].values())
    assert paged._DEBUG_SKIP_WRITES is flag and paged.paged_attention_flat is attn

    real = paged.run_chunk_paged

    def fails_when_stubbed(*a, **k):
        if paged.paged_attention_flat is profile_paged.attention_stub:
            raise RuntimeError("inside a variant")
        return real(*a, **k)

    monkeypatch.setattr(paged, "run_chunk_paged", fails_when_stubbed)
    with pytest.raises(RuntimeError, match="inside a variant"):
        profile_paged.run(CPU, **kw)
    assert paged._DEBUG_SKIP_WRITES is flag and paged.paged_attention_flat is attn


def test_attention_stub_is_the_flash_identity():
    q = torch.randn((3, 4, 16), dtype=torch.bfloat16)
    acc, m, l = profile_paged.attention_stub(q, None)
    assert acc.shape == (3, 4, 16) and m.shape == l.shape == (3, 4)
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    assert not acc.any() and not m.any() and bool((l == 1).all())


@pytest.mark.parametrize("tool,argv", [
    ("profile_decode", []), ("profile2", []), ("profile_paged", []), ("exp_step", []),
    ("exp_ablate", []), ("exp_diag", []), ("exp_big", []), ("exp_cache", []),
    ("bench_matrix", ["--out", "m.json"]), ("train_tiny", ["--out", "run"])])
def test_every_tool_defaults_to_the_card(tool, argv, tmp_path, monkeypatch):
    """Without a card the default --device cuda exits non-zero before any
    work; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default route runs")
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"kuiperllama_tpu_torch.tools.{tool}")
    with pytest.raises(SystemExit) as e:
        mod.main(argv)
    assert e.value.code not in (0, None) and "no CUDA device" in str(e.value.code)
    assert os.listdir(tmp_path) == []
