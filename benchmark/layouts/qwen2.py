"""The raw weights of the Qwen2 decoder (Qwen2.5): their sizes, their
matrices and the order they are drawn in. Nothing here imports the program.

The raw layout (stacked on a leading layer axis, [in, out] matrices):
  tok_emb [V, d]; final_norm [d]; lm_head [d, V] or None when tied;
  layers: attn_norm, ffn_norm [L, d]; wq, wk, wv, wo, w1, w3, w2; bq, bk,
  bv. A matrix is a bf16 tensor or a dict {"q": int8, "s": bf16 [.., K/g,
  N], "g": g}.
"""

from __future__ import annotations

import torch

from benchmark.harness.weights import BIAS_STD, GAIN, NORM_STD

# a CPU-sized copy for the tests: every kind of layer, at small widths
TINY = dict(hidden_size=256, intermediate_size=1024, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=4096)
TINY_GROUP = 32


def shapes(config: dict) -> dict:
    """The sizes the weights need, from the configuration's published keys."""
    d = config["hidden_size"]
    H = config["num_attention_heads"]
    KH = config["num_key_value_heads"]
    hd = config.get("head_dim") or d // H
    return dict(d=d, h=config["intermediate_size"], L=config["num_hidden_layers"],
                H=H, KH=KH, hd=hd, kv=KH * hd, V=config["vocab_size"],
                tied=bool(config["tie_word_embeddings"]),
                bias=bool(config["benchmark"]["qkv_bias"]),
                eps=float(config["rms_norm_eps"]),
                theta=float(config["rope_theta"]))


def matrices(s: dict) -> dict:
    """(K, N) of each per-layer matrix, in drawing order."""
    d, h, kv = s["d"], s["h"], s["kv"]
    return {"wq": (d, d), "wk": (d, kv), "wv": (d, kv), "wo": (d, d),
            "w1": (d, h), "w3": (d, h), "w2": (h, d)}


def draw(config: dict, w) -> dict:
    """Every tensor in its fixed order from the drawing handle `w`
    (`weights.Draw`): norms, matrices, biases, embedding, final norm,
    lm_head."""
    s = shapes(config)
    L, d, V = s["L"], s["d"], s["V"]
    layers = {
        "attn_norm": w.normal((L, d), NORM_STD, torch.float32).add_(1.0),
        "ffn_norm": w.normal((L, d), NORM_STD, torch.float32).add_(1.0),
    }
    for name, (K, N) in matrices(s).items():
        layers[name] = w.matrix((L, K, N))
    if s["bias"]:
        for name, n in (("bq", d), ("bk", s["kv"]), ("bv", s["kv"])):
            layers[name] = w.normal((L, n), BIAS_STD, torch.bfloat16)
    tok_emb = w.normal((V, d), GAIN * d ** -0.5, torch.bfloat16)
    final_norm = w.normal((d,), NORM_STD, torch.float32).add_(1.0)
    lm_head = None if s["tied"] else w.matrix((d, V))
    return dict(tok_emb=tok_emb, final_norm=final_norm, lm_head=lm_head,
                layers=layers)


def tiny(config: dict) -> dict:
    """A copy of `config` at CPU size (TINY, INT8 groups of TINY_GROUP) for
    the benchmark's own tests."""
    out = dict(config, **TINY)
    if "group_size" in config["benchmark"]:
        out["benchmark"] = dict(config["benchmark"], group_size=TINY_GROUP)
    return out
