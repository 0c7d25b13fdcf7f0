"""Parameter dict construction and device placement.

The weight set is a plain dict of tensors with every per-layer tensor
stacked along a leading L axis: `tok_emb`, `blocks` (attn_norm, ffn_norm,
wq, wk, wv, wo, w1, w2, w3 and, for Qwen2, bq, bk, bv), `final_norm` and
`lm_head`. Matmul weights are [in, out]; quantized ones are QuantTensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .quant import QuantTensor


def is_quant_leaf(x) -> bool:
    return isinstance(x, dict) and set(x.keys()) >= {"q", "s", "group_size"}


def to_device(params, device="cuda", dtype=torch.float32):
    """Move a numpy params dict (as `load_bin` returns it) onto `device`.

    Float weights are cast to `dtype` (bf16 for the fast path); norm weights
    stay fp32 for accumulation accuracy; quant dict leaves become QuantTensor
    (int8 q, fp32 s with exactly in // g rows). Leaves that are already
    tensors or QuantTensors (such as `random_params_device`'s) move and cast
    by the same rules; QuantTensor scales keep their dtype.
    """

    def convert(name, x):
        if isinstance(x, QuantTensor):
            return QuantTensor(q=x.q.to(device), s=x.s.to(device),
                               group_size=x.group_size)
        if torch.is_tensor(x):
            if x.is_floating_point():
                return x.to(device=device,
                            dtype=torch.float32 if "norm" in name else dtype)
            return x.to(device)
        if is_quant_leaf(x):
            return QuantTensor(
                q=torch.from_numpy(np.ascontiguousarray(x["q"])).to(device),
                s=torch.from_numpy(np.asarray(x["s"], np.float32)).to(device),
                group_size=int(x["group_size"]),
            )
        x = np.asarray(x)
        if x.dtype in (np.float32, np.float64):
            target = torch.float32 if "norm" in name else dtype
            t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
            return t.to(device=device, dtype=target)
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    out = {}
    for key, val in params.items():
        if key == "blocks":
            out[key] = {k: convert(k, v) for k, v in val.items()}
        else:
            out[key] = convert(key, val)
    return out


def random_params(
    cfg: ModelConfig,
    seed: int = 0,
    dtype=np.float32,
    scale: float = 0.02,
) -> dict:
    """Random-normal params (numpy, [in, out] orientation) for tests/benches;
    the same draws as the JAX package's `random_params` for the same seed."""
    rng = np.random.default_rng(seed)
    L, d, h, kv = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.kv_dim

    def mat(*shape):
        return (rng.standard_normal(shape) * scale).astype(dtype)

    blocks = dict(
        attn_norm=np.ones((L, d), dtype),
        ffn_norm=np.ones((L, d), dtype),
        wq=mat(L, d, d),
        wk=mat(L, d, kv),
        wv=mat(L, d, kv),
        wo=mat(L, d, d),
        w1=mat(L, d, h),
        w2=mat(L, h, d),
        w3=mat(L, d, h),
    )
    if cfg.qkv_bias:
        blocks.update(bq=mat(L, d), bk=mat(L, kv), bv=mat(L, kv))
    tok_emb = mat(cfg.vocab_size, d)
    lm_head = (
        np.ascontiguousarray(tok_emb.T)
        if cfg.tied_embedding
        else mat(d, cfg.vocab_size)
    )
    return dict(
        tok_emb=tok_emb, blocks=blocks, final_norm=np.ones((d,), dtype), lm_head=lm_head
    )


def random_params_device(
    cfg: ModelConfig,
    device="cuda",
    seed: int = 0,
    quantize: bool = False,
    group_size: int = 64,
    dtype=torch.bfloat16,
    scale: float = 0.02,
) -> dict:
    """Random params drawn directly on `device` from a seeded
    torch.Generator. With quantize=True the matmul weights are drawn as int8
    payloads plus constant scales, so a 7B model never passes through fp32,
    on the host or on the device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    L, d, h, kv = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.kv_dim

    def normal(*shape, dt=dtype):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(scale).to(dt)

    def mat(*shape, quant=quantize):
        if quant:
            q = torch.randint(-127, 128, shape, generator=gen, device=device,
                              dtype=torch.int8)
            s = torch.full(shape[:-2] + (shape[-2] // group_size, shape[-1]),
                           scale / 127.0, dtype=torch.float32, device=device)
            return QuantTensor(q=q, s=s, group_size=group_size)
        return normal(*shape)

    ones = lambda *shape: torch.ones(shape, dtype=torch.float32, device=device)
    blocks = dict(
        attn_norm=ones(L, d),
        ffn_norm=ones(L, d),
        wq=mat(L, d, d),
        wk=mat(L, d, kv),
        wv=mat(L, d, kv),
        wo=mat(L, d, d),
        w1=mat(L, d, h),
        w2=mat(L, h, d),
        w3=mat(L, d, h),
    )
    if cfg.qkv_bias:
        blocks.update(bq=mat(L, d, quant=False), bk=mat(L, kv, quant=False),
                      bv=mat(L, kv, quant=False))
    tok_emb = normal(cfg.vocab_size, d)
    lm_head = mat(d, cfg.vocab_size)
    return dict(tok_emb=tok_emb, blocks=blocks, final_norm=ones(d),
                lm_head=lm_head)


def param_bytes(params) -> int:
    """Bytes of every tensor in a params dict (int8 payloads and scales included)."""
    def walk(x):
        if isinstance(x, QuantTensor):
            return walk(x.q) + walk(x.s)
        if isinstance(x, dict):
            return sum(walk(v) for v in x.values())
        return x.numel() * x.element_size()

    return walk(params)
