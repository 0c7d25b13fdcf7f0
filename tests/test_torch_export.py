"""The port's exporter (tools/export.py) against the JAX one on the same
input, on the CPU: `--random llama2` and `--hf DIR` (random weights in HF
naming, written with the `safetensors` package), v0 and v3, write
byte-identical `.bin` files, and the port's load_bin reads them back."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from kuiperllama_tpu_torch.checkpoint.binfmt import load_bin
from kuiperllama_tpu_torch.checkpoint.hf import load_hf
from kuiperllama_tpu_torch.config import tiny_config
from kuiperllama_tpu_torch.params import random_params
from kuiperllama_tpu_torch.tools import export
from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_export(argv):
    """tools/export.py's main with `argv`, in this process (sys.argv and
    sys.path restored)."""
    spec = importlib.util.spec_from_file_location(
        "_jax_export_tool", os.path.join(REPO, "tools", "export.py"))
    mod = importlib.util.module_from_spec(spec)
    saved = sys.argv, list(sys.path)
    try:
        spec.loader.exec_module(mod)
        sys.argv = ["export.py", *argv]
        mod.main()
    finally:
        sys.argv, sys.path[:] = saved


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """An HF llama directory of random fp32 weights, written with the
    `safetensors` package in HF naming and [out, in] orientation."""
    from safetensors.numpy import save_file

    d = tmp_path_factory.mktemp("hf_export")
    cfg = tiny_config("llama2", n_layers=2)
    p = random_params(cfg, seed=3)
    b = p["blocks"]
    names = dict(wq="self_attn.q_proj", wk="self_attn.k_proj", wv="self_attn.v_proj",
                 wo="self_attn.o_proj", w1="mlp.gate_proj", w2="mlp.down_proj",
                 w3="mlp.up_proj")
    sd = {"model.embed_tokens.weight": p["tok_emb"], "model.norm.weight": p["final_norm"],
          "lm_head.weight": np.ascontiguousarray(p["lm_head"].T)}
    for i in range(cfg.n_layers):
        sd[f"model.layers.{i}.input_layernorm.weight"] = b["attn_norm"][i]
        sd[f"model.layers.{i}.post_attention_layernorm.weight"] = b["ffn_norm"][i]
        for k, hf_name in names.items():
            sd[f"model.layers.{i}.{hf_name}.weight"] = np.ascontiguousarray(b[k][i].T)
    save_file(sd, str(d / "model.safetensors"))
    with open(d / "config.json", "w") as f:
        json.dump({"model_type": "llama", "hidden_size": cfg.dim,
                   "intermediate_size": cfg.hidden_dim, "num_hidden_layers": cfg.n_layers,
                   "num_attention_heads": cfg.n_heads,
                   "num_key_value_heads": cfg.n_kv_heads, "vocab_size": cfg.vocab_size,
                   "max_position_embeddings": cfg.seq_len, "rope_theta": 10000.0,
                   "tie_word_embeddings": False}, f)
    return str(d)


@pytest.mark.parametrize("version", [0, 3])
@pytest.mark.parametrize("source", ["random", "hf"])
def test_export_matches_jax_byte_for_byte(tmp_path, hf_dir, source, version, capsys):
    src = ["--random", "llama2"] if source == "random" else ["--hf", hf_dir]
    ours, theirs = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    assert export.main([ours, *src, "--version", str(version)]) == 0
    _jax_export([theirs, *src, "--version", str(version)])
    out = capsys.readouterr().out
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert out.count(f"({os.path.getsize(ours)} bytes)") == 2

    cfg, params = load_bin(ours, quantized=version == 3)
    if source == "random":
        want_cfg, want = tiny_config("llama2"), random_params(tiny_config("llama2"))
    else:
        want_cfg, want = load_hf(hf_dir)
    for k in ("dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads", "vocab_size",
              "seq_len", "tied_embedding"):
        assert getattr(cfg, k) == getattr(want_cfg, k), k
    assert cfg.group_size == (64 if version == 3 else None)
    if version == 0:
        np.testing.assert_array_equal(params["blocks"]["wq"], want["blocks"]["wq"])
        np.testing.assert_array_equal(params["lm_head"], want["lm_head"])
    else:
        wq = params["blocks"]["wq"]
        deq = (wq["q"].astype(np.float32).reshape(cfg.n_layers, -1, 64, cfg.dim)
               * wq["s"][:, :, None, :]).reshape(want["blocks"]["wq"].shape)
        assert np.abs(deq - want["blocks"]["wq"]).max() <= np.abs(
            want["blocks"]["wq"]).max() / 127


def test_export_needs_a_source(tmp_path):
    with pytest.raises(SystemExit):
        export.main([str(tmp_path / "x.bin")])
