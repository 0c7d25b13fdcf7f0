"""The benchmark's own weights, made on the device from the seed.

One torch.Generator on the device, seeded with the run's seed, draws every
tensor in a fixed order and in a few large calls, in the type it is served
in: INT8 payloads uniform over [-127, 127] with bf16 group scales spread
over [0.5, 1.5) of a base, or bf16 normal weights. Each matrix [K, N] has
a standard deviation of GAIN / sqrt(K) (fan-in scaled) and the embedding
GAIN / sqrt(d). At the models' own initializer range, 0.02 for every
matrix, Qwen2.5-0.5B's 896-wide layers shrink their input and greedy
decoding falls into repetition loops (23 distinct tokens in 1,003 served),
which leaves the comparison little to see; at a gain of 1 short loops
remain at small widths, at 1.5 none are left. bf16 biases; fp32 norm
weights near 1. The same seed on the same device gives
the same bytes, so the reference makes them again after the program is
freed. Nothing here imports the program.

The raw layout (stacked on a leading layer axis, [in, out] matrices):
  tok_emb [V, d]; final_norm [d]; lm_head [d, V] or None when tied;
  layers: attn_norm, ffn_norm [L, d]; wq, wk, wv, wo, w1, w3, w2; bq, bk,
  bv. A matrix is a bf16 tensor or a dict {"q": int8, "s": bf16 [.., K/g,
  N], "g": g}.
"""

from __future__ import annotations

import torch

GAIN = 1.5
BIAS_STD = 0.1
NORM_STD = 0.1
# uniform int8 over [-127, 127] has a standard deviation of 127 / sqrt(3)
INT8_STD = 127 / 3 ** 0.5
_SEED_MOD = 2 ** 63


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


def make(config: dict, seed: int, device) -> dict:
    s = shapes(config)
    quant = config["benchmark"]["weights"]
    g = config["benchmark"].get("group_size")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % _SEED_MOD)
    L, d, V = s["L"], s["d"], s["V"]

    def normal(shape, std, dtype):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(std).to(dtype)

    def matrix(shape):
        K, N = shape[-2], shape[-1]
        std = GAIN * K ** -0.5
        if quant == "int8":
            q = torch.randint(-127, 128, shape, generator=gen, device=device,
                              dtype=torch.int8)
            sc = torch.rand(shape[:-2] + (K // g, N), generator=gen, device=device,
                            dtype=torch.float32)
            sc = sc.add_(0.5).mul_(std / INT8_STD).to(torch.bfloat16)
            return {"q": q, "s": sc, "g": g}
        if quant == "bfloat16":
            return normal(shape, std, torch.bfloat16)
        raise ValueError(f"weights {quant!r}")

    layers = {
        "attn_norm": normal((L, d), NORM_STD, torch.float32).add_(1.0),
        "ffn_norm": normal((L, d), NORM_STD, torch.float32).add_(1.0),
    }
    for name, (K, N) in matrices(s).items():
        layers[name] = matrix((L, K, N))
    if s["bias"]:
        for name, n in (("bq", d), ("bk", s["kv"]), ("bv", s["kv"])):
            layers[name] = normal((L, n), BIAS_STD, torch.bfloat16)
    tok_emb = normal((V, d), GAIN * d ** -0.5, torch.bfloat16)
    final_norm = normal((d,), NORM_STD, torch.float32).add_(1.0)
    lm_head = None if s["tied"] else matrix((d, V))
    return dict(tok_emb=tok_emb, final_norm=final_norm, lm_head=lm_head,
                layers=layers)


def dequantize(w, layer=None) -> torch.Tensor:
    """A raw matrix (or layer `layer` of a stacked one) in float32."""
    if isinstance(w, dict):
        q, sc, g = w["q"], w["s"], w["g"]
        if layer is not None:
            q, sc = q[layer], sc[layer]
        K, N = q.shape[-2], q.shape[-1]
        return (q.view(K // g, g, N).float() * sc.float()[:, None, :]).view(K, N)
    return (w if layer is None else w[layer]).float()
