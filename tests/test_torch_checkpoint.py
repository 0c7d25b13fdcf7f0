"""Checkpoint I/O and weight conversion of the port against the JAX package."""

import dataclasses
import os

import numpy as np
import pytest
import torch


from kuiperllama_tpu.checkpoint import binfmt as jbin
from kuiperllama_tpu.config import tiny_config as jtiny
from kuiperllama_tpu.fuse import fuse_params as jfuse
from kuiperllama_tpu.params import random_params as jrandom, to_device as jto
from kuiperllama_tpu.quant import cast_scales as jcast
from kuiperllama_tpu_torch.checkpoint import binfmt as tbin
from kuiperllama_tpu_torch.config import tiny_config
from kuiperllama_tpu_torch.convert import from_jax_params
from kuiperllama_tpu_torch.fuse import fuse_params
from kuiperllama_tpu_torch.params import (param_bytes, random_params,
                                          random_params_device, to_device)
from kuiperllama_tpu_torch.quant import QuantTensor
from torch_threads import one_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
FIXTURES = [
    ("tinychar/tinychar.bin", "llama2"),
    ("tinychar/tinychar.q8.bin", "llama2"),
    ("tinychar_g256/tinychar.bin", "llama2"),
    ("tinychar_g256/tinychar.q8.bin", "llama2"),
    ("tinychar_qwen2/tinychar.bin", "qwen2"),
    ("tinychar_qwen2/tinychar.q8.bin", "qwen2"),
]


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict) and "q" not in v:
            yield from _flat(v, f"{prefix}{k}.")
        elif isinstance(v, dict):
            for part in ("q", "s", "group_size"):
                yield f"{prefix}{k}.{part}", v[part]
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("rel,family", FIXTURES)
def test_load_bin_equal(rel, family):
    path = os.path.join(ROOT, rel)
    jc, jp = jbin.load_bin(path, family=family)
    tc, tp = tbin.load_bin(path, family=family)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    want, got = dict(_flat(jp)), dict(_flat(tp))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(np.asarray(got[name]),
                                      np.asarray(want[name]), err_msg=name)


@pytest.mark.parametrize("family", ["llama2", "qwen2"])
def test_writers_byte_equal(tmp_path, family):
    cfg = jtiny(family, seq_len=32)
    params = jrandom(cfg, seed=4)
    for writer, name in ((jbin.write_v0, "v0"), (jbin.write_v3, "v3")):
        jpath, tpath = tmp_path / f"j{name}.bin", tmp_path / f"t{name}.bin"
        writer(str(jpath), cfg, params)
        getattr(tbin, writer.__name__)(str(tpath), tiny_config(family, seq_len=32),
                                       params)
        assert tpath.read_bytes() == jpath.read_bytes()


def test_to_device_keeps_norms_fp32_and_exact_scale_rows():
    _, p = tbin.load_bin(os.path.join(ROOT, "tinychar/tinychar.q8.bin"))
    tp = to_device(p, device="cpu", dtype=torch.bfloat16)
    b = tp["blocks"]
    assert b["attn_norm"].dtype == torch.float32
    assert tp["final_norm"].dtype == torch.float32
    assert tp["tok_emb"].dtype == torch.bfloat16
    wq = b["wq"]
    assert isinstance(wq, QuantTensor) and wq.q.dtype == torch.int8
    assert wq.s.shape[-2] == wq.q.shape[-2] // wq.group_size
    fused = fuse_params(tp)["blocks"]
    assert "wq" not in fused and fused["wqkv"].q.shape[-1] == 128 + 2 * 64


@pytest.mark.parametrize("rel,family", [FIXTURES[1], FIXTURES[5], FIXTURES[2]])
def test_from_jax_params_slices_padded_scale_rows(rel, family):
    path = os.path.join(ROOT, rel)
    _, p = jbin.load_bin(path, family=family)
    jp = jcast(jfuse(jto(p)))  # padded bf16 scale rows, fused
    got = from_jax_params(jp, device="cpu", dtype=torch.float32)
    want = fuse_params(to_device(tbin.load_bin(path, family=family)[1],
                                 device="cpu"))
    for name, w in want["blocks"].items():
        g = got["blocks"][name]
        if isinstance(w, QuantTensor):
            assert g.s.dtype == torch.bfloat16
            assert g.s.shape == w.s.shape  # padding gone
            assert torch.equal(g.q, w.q)
            assert torch.equal(g.s, w.s.to(torch.bfloat16))
        else:
            assert torch.equal(g, w), name
    assert torch.equal(got["tok_emb"], want["tok_emb"])
    assert got["blocks"]["attn_norm"].dtype == torch.float32


def test_random_params():
    cfg = tiny_config("qwen2", seq_len=32)
    a, b = random_params(cfg, seed=3), jrandom(jtiny("qwen2", seq_len=32), seed=3)
    for (n1, x1), (n2, x2) in zip(_flat(a), _flat(b)):
        assert n1 == n2
        np.testing.assert_array_equal(x1, x2)
    d1 = random_params_device(cfg, device="cpu", seed=5, quantize=True,
                              group_size=32)
    d2 = random_params_device(cfg, device="cpu", seed=5, quantize=True,
                              group_size=32)
    w = d1["blocks"]["w2"]
    assert w.q.dtype == torch.int8 and w.s.shape == (2, 192 // 32, 64)
    assert torch.equal(w.q, d2["blocks"]["w2"].q)
    assert int(w.q.min()) >= -127 and int(w.q.max()) <= 127
    assert d1["tok_emb"].dtype == torch.bfloat16
    assert d1["blocks"]["bq"].shape == (2, 64)
    assert param_bytes(d1) > 0


def test_from_jax_params_takes_dict_leaves():
    """Quantized leaves given as numpy dicts {q, s, group_size}, with scale
    rows padded to a multiple of 16 as the JAX package pads them."""
    path = os.path.join(ROOT, "tinychar_qwen2/tinychar.q8.bin")
    _, p = jbin.load_bin(path, family="qwen2")
    padded = dict(p, blocks={
        k: (dict(v, s=np.pad(v["s"], ((0, 0), (0, -v["s"].shape[1] % 16), (0, 0))))
            if isinstance(v, dict) else v)
        for k, v in p["blocks"].items()})
    assert padded["blocks"]["w2"]["s"].shape[1] == 16
    got = from_jax_params(padded, device="cpu")
    want = to_device(tbin.load_bin(path, family="qwen2")[1], device="cpu")
    for name, w in want["blocks"].items():
        g = got["blocks"][name]
        if isinstance(w, QuantTensor):
            assert torch.equal(g.q, w.q) and torch.equal(g.s, w.s), name
        else:
            assert torch.equal(g, w), name
    assert torch.equal(got["lm_head"].s, want["lm_head"].s)
