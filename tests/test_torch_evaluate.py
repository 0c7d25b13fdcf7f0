"""The port's perplexity gate (evaluate.py, tools/ppl.py, tools/gate_group.py)
against the JAX package's, on the CPU:
  * window_nll and perplexity on fp32 params equal to JAX's on its XLA
    matmul path (as tests/test_evaluate.py runs it) within 1e-5 relative;
  * on INT8 params in fast mode (the committed tinychar .q8.bin, 128-token
    windows of the held-out split), ppl within 2e-5 relative of JAX's with
    its Pallas quant matmul under the interpreter (readings: 2.4e-6);
  * the uniform-model check (ppl near the vocab size);
  * gate_group's delta on each committed fixture within 1e-3 of the
    committed GATE_PPL*.json (the one report made on a TPU: of the JAX
    package's gate run here);
  * tools/ppl.py exits 1 when the gate fails and 0 when it passes.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuiperllama_tpu import evaluate as jev
from kuiperllama_tpu.checkpoint.binfmt import load_bin as jload_bin
from kuiperllama_tpu.config import tiny_config as jtiny
from kuiperllama_tpu.ops.linear import set_use_pallas
from kuiperllama_tpu.params import random_params as jrandom, to_device as jto
from kuiperllama_tpu_torch import evaluate
from kuiperllama_tpu_torch.checkpoint.binfmt import load_bin, write_v0, write_v3
from kuiperllama_tpu_torch.config import tiny_config
from kuiperllama_tpu_torch.params import random_params, to_device
from kuiperllama_tpu_torch.tools import gate_group, ppl
from torch_threads import one_thread  # noqa: F401

FP32_TOL = 1e-5
INT8_TOL = 2e-5
DELTA_TOL = 1e-3
# (fixture, fp checkpoint, in-memory group, v3 file, family, committed report)
GATES = [
    ("tinychar g64", "checkpoints/tinychar/tinychar.bin", None,
     "checkpoints/tinychar/tinychar.q8.bin", "llama2", "checkpoints/tinychar/GATE_PPL.json"),
    ("tinychar_g256 g256", "checkpoints/tinychar_g256/tinychar.bin", 256, None, "llama2",
     "checkpoints/tinychar_g256/GATE_PPL_G256_r05.json"),
    ("tinychar_g256 g128", "checkpoints/tinychar_g256/tinychar.bin", 128, None, "llama2",
     "checkpoints/tinychar_g256/GATE_PPL_G128_r05.json"),
    ("tinychar_qwen2 g64", "checkpoints/tinychar_qwen2/tinychar.bin", None,
     "checkpoints/tinychar_qwen2/tinychar.q8.bin", "qwen2",
     "checkpoints/tinychar_qwen2/GATE_PPL.json"),
]


@pytest.fixture
def xla_path():
    set_use_pallas(False)
    yield
    set_use_pallas(True)


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_window_nll_and_perplexity_fp32_match_jax(xla_path):
    cfg, jcfg = tiny_config("llama2", seq_len=64), jtiny("llama2", seq_len=64)
    raw = random_params(cfg, seed=5)
    stream = np.random.default_rng(2).integers(0, cfg.vocab_size, 256).astype(np.int32)
    tp = to_device(raw, device="cpu")
    jp = jto(jrandom(jcfg, seed=5), dtype=jnp.float32)
    toks = stream[:128].reshape(2, 64)
    nll, count = evaluate.window_nll(cfg, tp, torch.from_numpy(toks))
    jnll, jcount = jev.window_nll(jcfg, jp, jnp.asarray(toks))
    assert count == jcount == 126
    assert _rel(float(nll), float(jnll)) <= FP32_TOL
    got = evaluate.perplexity(cfg, tp, stream, window=64)
    want = jev.perplexity(jcfg, jp, stream, window=64)
    assert _rel(got, want) <= FP32_TOL, (got, want)


def test_perplexity_int8_fast_matches_jax_pallas_interpret():
    """The committed v3 fixture, fp32 activations: the port's INT8 GEMM
    plain version (fast mode) against JAX's Pallas kernel in interpret mode
    (its default on the CPU)."""
    ids = gate_group.heldout_ids()
    path = "checkpoints/tinychar/tinychar.q8.bin"
    cfg, raw = load_bin(path, quantized=True)
    jcfg, jraw = jload_bin(path, quantized=True)
    got = evaluate.perplexity(cfg, to_device(raw, device="cpu"), ids, window=cfg.seq_len)
    want = jev.perplexity(jcfg, jto(jraw, dtype=jnp.float32), ids, window=jcfg.seq_len)
    assert _rel(got, want) <= INT8_TOL, (got, want)


def test_ppl_uniform_model_near_vocab():
    # a zeroed model emits uniform logits -> ppl == vocab_size
    cfg = tiny_config("llama2", seq_len=64)
    raw = random_params(cfg, seed=0, scale=0.0)
    raw["tok_emb"] += 0.001  # break symmetry without information
    stream = np.random.default_rng(1).integers(0, cfg.vocab_size, 128).astype(np.int32)
    got = evaluate.perplexity(cfg, to_device(raw, device="cpu"), stream, window=32)
    assert abs(got - cfg.vocab_size) / cfg.vocab_size < 0.05, got


@pytest.mark.parametrize("case", GATES, ids=[g[0] for g in GATES])
def test_gate_group_reproduces_committed_delta(case):
    label, ckpt, group, qfile, family, committed = case
    report = gate_group.gate(ckpt, group=group, quant_model=qfile, family=family,
                             device="cpu")
    with open(committed) as f:
        ref = json.load(f)
    assert report["passes_gate"] and report["kernel_mode"] == "torch-plain-fast"
    assert report["heldout_tokens"] == ref["heldout_tokens"] == 662
    assert report["window"] == 128
    if ref["kernel_mode"] == "pallas-fast-interpret":
        want = ref["delta"]
    else:
        # made on a TPU, whose fp32 matmuls ran at its default precision
        # (ppl_fp 11.90694 there, 11.90418 in fp32): held to the JAX
        # package's own gate on the CPU
        assert ref["kernel_mode"] == "pallas-fast-compiled" and label == "tinychar g64"
        c0, pf = jload_bin(ckpt, family=family)
        c3, pq = jload_bin(qfile, family=family, quantized=True)
        want = jev.quantization_ppl_delta(
            c0, jto(pf, dtype=jnp.float32), c3, jto(pq, dtype=jnp.float32),
            gate_group.heldout_ids(), window=c0.seq_len)["delta"]
        assert abs(want - ref["delta"]) > DELTA_TOL  # the TPU report differs
    assert abs(report["delta"] - want) <= DELTA_TOL, (report["delta"], want)


def test_gate_group_cli_writes_only_to_out(tmp_path, capsys):
    out = tmp_path / "g.json"
    before = {p: os.path.getmtime(p) for p in (g[5] for g in GATES)}
    code = gate_group.main(["--ckpt", "checkpoints/tinychar_g256/tinychar.bin",
                            "--group", "256", "--device", "cpu", "--out", str(out)])
    assert code == 0
    report = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == report
    assert report["quant"].startswith("group=256")
    assert before == {p: os.path.getmtime(p) for p in before}
    assert gate_group.encode_bytes("a\xff").tolist() == [97, 63]


@pytest.fixture(scope="module")
def ppl_models(tmp_path_factory):
    """v0 and v3 files of random tiny weights (a passing gate), and a v3 file
    of the same weights with the lm_head scaled by 50 (a failing one)."""
    d = tmp_path_factory.mktemp("ppl")
    cfg = tiny_config("llama2", seq_len=64)
    raw = random_params(cfg, seed=5)
    loud = dict(raw, lm_head=raw["lm_head"] * 50)
    paths = {n: str(d / f"{n}.bin") for n in ("fp", "q8", "loud")}
    write_v0(paths["fp"], cfg, raw)
    write_v3(paths["q8"], cfg, raw)
    write_v3(paths["loud"], cfg, loud)
    return paths


@pytest.mark.parametrize("quant, code", [("q8", 0), ("loud", 1)])
def test_ppl_cli_exit_code_follows_the_gate(ppl_models, quant, code, capsys):
    got = ppl.main(["--model", ppl_models["fp"], "--quant-model", ppl_models[quant],
                    "--window", "64", "--device", "cpu"])
    report = json.loads(capsys.readouterr().out)
    assert got == code and report["passes_gate"] == (code == 0)
    assert (abs(report["delta"]) <= evaluate.GATE) == (code == 0)


def test_ppl_cli_single_model(ppl_models, capsys):
    assert ppl.main(["--model", ppl_models["fp"], "--window", "64",
                     "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["ppl"] > 1.0
