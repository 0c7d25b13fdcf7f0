"""The port's bench (bench_torch.py) against bench.py on the CPU:
  * the roofline byte counts equal bench.py's `_streamed_bytes_per_token`
    and `_kv_bytes_per_step` on the same tiny configuration (fp and INT8
    with bf16 scales; scale rows a multiple of 16, so the JAX package's
    padded scale rows add nothing);
  * the prefill MFU's FLOP count is 2 x the projection weights x the padded
    tokens plus 2 x the lm_head x the prefilled rows: no norm, no bias, no
    embedding, and no T multiple of the lm_head, where bench.py:514-522's
    count (computed here as it computes it) drops the lm_head and, under
    --fp, takes Qwen2's stacked biases in;
  * the flags and their defaults are bench.py's (the port adds --device), and
    --engine without --batch takes 8 slots;
  * a run at a tiny preset on the CPU prints the one-line contract;
  * --selftest refuses the CPU.
"""

import argparse
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch

import bench
import bench_torch
from kuiperllama_tpu.config import tiny_config as jtiny
from kuiperllama_tpu.fuse import fuse_params as jfuse
from kuiperllama_tpu.params import random_params_device as jrandom_device
from kuiperllama_tpu.quant import cast_scales as jcast
from kuiperllama_tpu_torch.config import tiny_config
from kuiperllama_tpu_torch.fuse import fuse_params
from kuiperllama_tpu_torch.params import random_params_device
from kuiperllama_tpu_torch.quant import cast_scales
from torch_threads import one_thread  # noqa: F401

SHAPE = dict(dim=256, hidden_dim=512, n_heads=4, n_kv_heads=2, vocab_size=512,
             seq_len=256)
GROUP = 16  # 16 and 32 scale rows: no padding on the JAX side


def _pair(fp: bool, family="llama2"):
    jcfg, cfg = jtiny(family, **SHAPE), tiny_config(family, **SHAPE)
    jp = jfuse(jrandom_device(jcfg, quantize=not fp, dtype=jnp.bfloat16,
                              group_size=GROUP))
    tp = fuse_params(random_params_device(cfg, device="cpu", quantize=not fp,
                                          group_size=GROUP, dtype=torch.bfloat16))
    if not fp:
        jp, tp = jcast(jp, jnp.bfloat16), cast_scales(tp, torch.bfloat16)
    return jcfg, jp, cfg, tp


@pytest.mark.parametrize("fp", [True, False], ids=["fp", "int8"])
def test_byte_counts_match_bench_py(fp):
    jcfg, jp, cfg, tp = _pair(fp)
    assert bench_torch.streamed_bytes_per_token(tp) == bench._streamed_bytes_per_token(jp)
    for steps, batch, cache_len in ((128, 1, 1024), (300, 8, 512), (8, 2, 128)):
        args = SimpleNamespace(prompt_len=32, steps=steps, batch=batch,
                               cache_len=cache_len)
        assert (bench_torch.kv_bytes_per_step(cfg, args)
                == bench._kv_bytes_per_step(jcfg, args))


def _bench_py_flops(params, fp: bool, padded_tokens: int) -> float:
    """bench.py:514-522's FLOP count, as it computes it."""
    emb = params["tok_emb"]
    n = sum(leaf.size for leaf in jax.tree.leaves(params)
            if leaf.dtype in (jnp.int8, emb.dtype) and leaf is not emb
            and leaf.ndim >= 2 and (fp or leaf.dtype == jnp.int8))
    lm = params["lm_head"]
    n -= lm.q.size if hasattr(lm, "q") else lm.size
    return 2.0 * n * padded_tokens


@pytest.mark.parametrize("fp", [True, False], ids=["fp", "int8"])
def test_prefill_flops_count_the_lm_head_once_per_row(fp):
    jcfg, jp, cfg, tp = _pair(fp)
    T, rows = 384, 8  # 8 slots of one admission, padded to 48 tokens each
    L, d, h, kv, V = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.kv_dim, cfg.vocab_size
    projections = L * (d * (d + 2 * kv) + d * d + d * 2 * h + h * d)
    assert bench_torch.projection_params(tp) == projections
    want = 2.0 * (projections * T + d * V * rows)
    assert bench_torch.prefill_flops(tp, T, rows) == want
    # bench.py drops the lm_head altogether (and under --fp would count any
    # >= 2-D leaf of the embedding's dtype, such as Qwen2's stacked biases)
    assert _bench_py_flops(jp, fp, T) == 2.0 * projections * T != want


def test_prefill_flops_leave_out_norms_and_qwen_biases():
    jcfg, jp, cfg, tp = _pair(True, "qwen2")
    assert {"bqkv", "attn_norm", "ffn_norm"} <= set(tp["blocks"])
    L, d, h, kv = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.kv_dim
    projections = L * (d * (d + 2 * kv) + d * d + 3 * d * h)
    assert bench_torch.projection_params(tp) == projections
    # bench.py's --fp count takes the bf16 biases [L, d + 2 kv] in
    assert _bench_py_flops(jp, True, 1) - 2.0 * projections == 2.0 * L * (d + 2 * kv)


def _bench_py_parser(monkeypatch):
    """bench.py's ArgumentParser, caught as its main() parses."""
    caught = {}

    class _Caught(Exception):
        pass

    def grab(self, args=None, namespace=None):
        caught["parser"] = self
        raise _Caught

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Caught):
            bench.main()
    return caught["parser"]


def test_flags_and_defaults_are_bench_py(monkeypatch):
    want = vars(_bench_py_parser(monkeypatch).parse_args([]))
    got = vars(bench_torch.parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want
    assert want["model"] == "llama2-7b" and want["group"] == 256
    assert bench_torch.parse_args(["--engine"]).batch == 8
    assert bench_torch.parse_args(["--engine", "--batch", "2"]).batch == 2
    assert bench_torch.parse_args(["--engine", "--batch=4"]).batch == 4
    assert bench_torch.parse_args(["--batch", "3"]).batch == 3


def test_cpu_run_prints_the_contract(capsys):
    assert bench_torch.main(["--model", "stories15m", "--fp", "--device", "cpu",
                             "--steps", "8", "--cache-len", "256"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"metric", "value", "unit", "vs_baseline"} <= set(line)
    assert line["unit"] == "tokens/s" and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / bench_torch.REFERENCE_TOKS_PER_S, 2)
    # no probe on the CPU: the measured share is absent, not a constant
    assert line["probes"] == {} and line["pct_of_roofline"] is None
    spec = line["roofline_toks_spec_bw"]
    assert spec > 0
    assert abs(line["pct_of_spec_bw_roofline"] - 100 * line["value"] / spec) <= 0.01


def test_selftest_refuses_the_cpu():
    with pytest.raises(SystemExit, match="card"):
        bench_torch.main(["--selftest", "--device", "cpu"])


@pytest.mark.parametrize("extra", [[], ["--arrival-rate", "50"],
                                   ["--engine-backend", "dense"]],
                         ids=["burst", "poisson", "dense"])
def test_cpu_engine_run(extra, capsys):
    assert bench_torch.main(["--engine", "--model", "stories15m", "--fp",
                             "--device", "cpu", "--steps", "4", "--cache-len", "256",
                             "--requests", "3", *extra]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"metric", "value", "unit", "vs_baseline", "p50_ttft_ms", "p99_ttft_ms"} <= set(line)
    assert line["slots"] == 8 and line["n_requests"] == 3 and line["total_tokens"] == 12
    assert line["hbm_budget_gb"] is None
    if extra:
        # staggered arrivals: no prefill MFU (the admission waits behind
        # the chunk in flight)
        assert ("prefill_rows" in line) == (extra[0] != "--arrival-rate")
        return
    # one single-shot admission of the three 32-token prompts: one packed
    # stream of 96 tokens padded to its 128 bucket, the lm_head on 8 rows
    assert line["prefill_rows"] == 8 and line["prefill_padded_tokens"] == 128
    assert line["prefill_tokens"] == 3 * 32
    assert line["prefill_mfu_pct"] is None  # no probe on the CPU
