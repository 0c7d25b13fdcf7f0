"""HuggingFace checkpoint ingestion (config.json + safetensors), a port of
kuiperllama_tpu/checkpoint/hf.py.

A self-contained safetensors parser (the format is an 8-byte little-endian
header length, a JSON header, then the raw tensor buffer) on `np.memmap`,
plus a state-dict -> params converter. The output is numpy arrays in
[in, out] orientation, what `load_bin` gives; `params.to_device` places
them. HF Llama/Qwen weights use the rotate-half RoPE convention, which maps
to rope_style="half" with no weight permutation.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict

import numpy as np

from ..config import ModelConfig, RopeScaling

_SAFETENSORS_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
    # BF16 has no numpy dtype: widened to fp32 through uint16 bits
    "BF16": None,
}


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Parse a .safetensors file into {name: ndarray}, zero-copy views of
    the mapped file except BF16 tensors, which are widened to fp32."""
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    (hlen,) = struct.unpack("<Q", bytes(mm[:8]))
    header = json.loads(bytes(mm[8: 8 + hlen]).decode("utf-8"))
    base = 8 + hlen
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype_tag = meta["dtype"]
        shape = meta["shape"]
        lo, hi = meta["data_offsets"]
        raw = mm[base + lo: base + hi]
        if dtype_tag == "BF16":
            u16 = np.frombuffer(raw, dtype=np.uint16)
            f32 = (u16.astype(np.uint32) << 16).view(np.float32)
            out[name] = f32.reshape(shape)
        else:
            dt = _SAFETENSORS_DTYPES.get(dtype_tag)
            if dt is None:
                raise ValueError(f"unsupported safetensors dtype {dtype_tag}")
            out[name] = np.frombuffer(raw, dtype=dt).reshape(shape)
    return out


def config_from_hf(hf_cfg: dict) -> ModelConfig:
    """Build a ModelConfig from an HF config.json dict."""
    model_type = hf_cfg.get("model_type", "llama")
    if model_type == "qwen2":
        family = "qwen2"
        qkv_bias = True
    elif model_type == "llama":
        # llama2 vs llama3 only matters for tokenizer defaults; HF weights
        # are always rotate-half, so the llama3 preset with the numerics
        # overridden from the config
        family = "llama3"
        qkv_bias = hf_cfg.get("attention_bias", False)
    else:
        raise ValueError(f"unsupported model_type {model_type!r}")
    n_heads = hf_cfg["num_attention_heads"]
    return ModelConfig.from_header(
        family=family,
        dim=hf_cfg["hidden_size"],
        hidden_dim=hf_cfg["intermediate_size"],
        n_layers=hf_cfg["num_hidden_layers"],
        n_heads=n_heads,
        n_kv_heads=hf_cfg.get("num_key_value_heads", n_heads),
        vocab_size=hf_cfg["vocab_size"],
        seq_len=hf_cfg.get("max_position_embeddings", 2048),
        tied_embedding=hf_cfg.get("tie_word_embeddings", False),
        rope_theta=float(hf_cfg.get("rope_theta", 10000.0)),
        norm_eps=float(hf_cfg.get("rms_norm_eps", 1e-5)),
        qkv_bias=qkv_bias,
        # Llama-3.1/3.2 frequency-dependent scaling: ignoring it diverges
        # from HF on any 3.1+ checkpoint
        rope_scaling=RopeScaling.from_hf(hf_cfg.get("rope_scaling")),
    )


def params_from_state_dict(cfg: ModelConfig, sd: Dict[str, np.ndarray]) -> dict:
    """HF llama/qwen2 state dict -> stacked [in, out] fp32 numpy params."""

    def get(name):
        for prefix in ("", "model."):
            if prefix + name in sd:
                return np.asarray(sd[prefix + name], np.float32)
        raise KeyError(name)

    L = cfg.n_layers

    def stack(fmt, transpose=True):
        ws = []
        for i in range(L):
            w = get(fmt.format(i=i))
            ws.append(w.T if transpose else w)
        return np.ascontiguousarray(np.stack(ws).astype(np.float32))

    blocks = dict(
        attn_norm=stack("layers.{i}.input_layernorm.weight", transpose=False),
        ffn_norm=stack("layers.{i}.post_attention_layernorm.weight", transpose=False),
        wq=stack("layers.{i}.self_attn.q_proj.weight"),
        wk=stack("layers.{i}.self_attn.k_proj.weight"),
        wv=stack("layers.{i}.self_attn.v_proj.weight"),
        wo=stack("layers.{i}.self_attn.o_proj.weight"),
        w1=stack("layers.{i}.mlp.gate_proj.weight"),
        w2=stack("layers.{i}.mlp.down_proj.weight"),
        w3=stack("layers.{i}.mlp.up_proj.weight"),
    )
    if cfg.qkv_bias:
        blocks.update(
            bq=stack("layers.{i}.self_attn.q_proj.bias", transpose=False),
            bk=stack("layers.{i}.self_attn.k_proj.bias", transpose=False),
            bv=stack("layers.{i}.self_attn.v_proj.bias", transpose=False),
        )
    tok_emb = get("embed_tokens.weight")
    if cfg.tied_embedding or "lm_head.weight" not in sd:
        lm_head = np.ascontiguousarray(tok_emb.T)
    else:
        lm_head = np.ascontiguousarray(np.asarray(sd["lm_head.weight"], np.float32).T)
    return dict(
        tok_emb=tok_emb,
        blocks=blocks,
        final_norm=get("norm.weight"),
        lm_head=lm_head,
    )


def load_hf(model_dir: str):
    """Load an HF model directory (config.json + one or more .safetensors).

    Returns (config, numpy params dict)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    sd: Dict[str, np.ndarray] = {}
    shards = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    if not shards:
        raise FileNotFoundError(f"no .safetensors files in {model_dir}")
    for shard in shards:
        sd.update(load_safetensors(os.path.join(model_dir, shard)))
    sd = {k.removeprefix("model."): v for k, v in sd.items()}
    return cfg, params_from_state_dict(cfg, sd)
