"""FLOP and byte arithmetic of the Qwen2 decoder (Qwen2.5), from the
configuration's published sizes alone: the work a step must do whatever
implements it. Frozen in the benchmark; adapted from `bench_torch.py`'s
`streamed_bytes_per_token`, `kv_bytes_per_step` and `prefill_flops`.

Counted: the layers' projections (q, k, v, o, gate, up, down) and the
lm_head at 2 FLOPs a weight a row; attention at 4 FLOPs a (query, key,
head, head-dim lane) pair (scores and the weighted sum), causal. Norms,
rope, biases and the softmax's exponentials are left out (under 1%).
Bytes: every weight a step reads (INT8 payloads, bf16 group scales, bf16
matrices, fp32 norms, bf16 biases), the embedding row of each token, and
the K/V cache rows read or written (bf16).
"""

from __future__ import annotations

from benchmark.layouts.qwen2 import matrices, shapes

ACT_BYTES = 2  # bf16 activations, embedding and KV cache


def _matrix_bytes(config: dict, K: int, N: int) -> int:
    b = config["benchmark"]
    if b["weights"] == "int8":
        return K * N + (K // b["group_size"]) * N * 2
    return K * N * 2


def projection_params(config: dict) -> int:
    """Weights of the layers' projections (every token multiplies through
    them)."""
    s = shapes(config)
    return s["L"] * sum(K * N for K, N in matrices(s).values())


def lm_head_params(config: dict) -> int:
    s = shapes(config)
    return s["d"] * s["V"]


def projection_bytes(config: dict) -> int:
    s = shapes(config)
    return s["L"] * sum(_matrix_bytes(config, K, N) for K, N in matrices(s).values())


def lm_head_bytes(config: dict) -> int:
    """The lm_head a step reads: the INT8 matrix and its scales, or the bf16
    one (the embedding matrix when tied)."""
    s = shapes(config)
    if s["tied"]:
        return s["d"] * s["V"] * ACT_BYTES
    return _matrix_bytes(config, s["d"], s["V"])


def small_bytes(config: dict) -> int:
    """Norm weights (fp32) and q/k/v biases (bf16)."""
    s = shapes(config)
    norms = (2 * s["L"] + 1) * s["d"] * 4
    bias = s["L"] * (s["d"] + 2 * s["kv"]) * ACT_BYTES if s["bias"] else 0
    return norms + bias


def stream_bytes(config: dict) -> int:
    """Bytes one decode step must read once, whatever its batch: every
    weight and scale but the embedding table."""
    return projection_bytes(config) + lm_head_bytes(config) + small_bytes(config)


def int8_stream_bytes(config: dict) -> int:
    """The INT8 payloads and scales a decode step's projections and lm_head
    read: the weight-stream kernels' share of `stream_bytes`. 0 for a bf16
    configuration."""
    if config["benchmark"]["weights"] != "int8":
        return 0
    return projection_bytes(config) + lm_head_bytes(config)


def kv_bytes_per_token(config: dict) -> int:
    """K and V of one token in every layer (bf16)."""
    s = shapes(config)
    return s["L"] * s["kv"] * 2 * ACT_BYTES


def attention_flops(config: dict, pairs: float) -> float:
    """FLOPs of `pairs` (query, key) pairs over every layer and head."""
    s = shapes(config)
    return 4.0 * pairs * s["L"] * s["H"] * s["hd"]


def decode_work(config: dict, tokens: int, ctx_sum: float, steps: int) -> tuple:
    """(FLOPs, bytes) of `steps` decode steps that produce `tokens` tokens
    whose queries attend `ctx_sum` cached positions in all."""
    s = shapes(config)
    flops = (2.0 * (projection_params(config) + lm_head_params(config)) * tokens
             + attention_flops(config, ctx_sum))
    nbytes = (steps * stream_bytes(config) + tokens * s["d"] * ACT_BYTES
              + (ctx_sum + tokens) * kv_bytes_per_token(config))
    return flops, nbytes


def prefill_work(config: dict, prompt_lens, calls: int) -> tuple:
    """(FLOPs, bytes) of `calls` prefill forwards over prompts of
    `prompt_lens` tokens (real tokens, padding left out): causal attention,
    the lm_head at each prompt's last token, the weights read once a call
    and each token's K/V written once."""
    s = shapes(config)
    P = [int(p) for p in prompt_lens]
    pairs = sum(p * (p + 1) / 2 for p in P)
    flops = (2.0 * projection_params(config) * sum(P)
             + 2.0 * lm_head_params(config) * len(P) + attention_flops(config, pairs))
    nbytes = (calls * stream_bytes(config)
              + sum(P) * (s["d"] * ACT_BYTES + kv_bytes_per_token(config)))
    return flops, nbytes
