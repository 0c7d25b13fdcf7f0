"""The program under test, `kuiperllama_tpu_torch`, as the drivers take it:
its model configuration and weights built from the benchmark's own, and
the counters it keeps (kernel launches, graph captures)."""

from __future__ import annotations

import torch

from kuiperllama_tpu_torch.config import ModelConfig
from kuiperllama_tpu_torch.fuse import fuse_params
from kuiperllama_tpu_torch.quant import QuantTensor
from kuiperllama_tpu_torch.serving import graphs
from kuiperllama_tpu_torch.serving.generate import _bucket, _bucket_len


def model_config(config: dict, seq_len: int) -> ModelConfig:
    """The port's ModelConfig of a benchmark configuration; `seq_len` is the
    cell's context (the rope table's length)."""
    b = config["benchmark"]
    return ModelConfig.from_header(
        family=b["family"], dim=config["hidden_size"],
        hidden_dim=config["intermediate_size"],
        n_layers=config["num_hidden_layers"],
        n_heads=config["num_attention_heads"],
        n_kv_heads=config["num_key_value_heads"],
        vocab_size=config["vocab_size"], seq_len=seq_len,
        tied_embedding=bool(config["tie_word_embeddings"]),
        group_size=b.get("group_size"), rope_theta=float(config["rope_theta"]),
        norm_eps=float(config["rms_norm_eps"]))


def _matrix(w):
    if isinstance(w, dict):
        return QuantTensor(q=w["q"], s=w["s"], group_size=w["g"])
    return w


def params(raw: dict) -> dict:
    """The port's params from the benchmark's raw weights: INT8 matrices as
    QuantTensors (bf16 scales), q|k|v and gate|up fused, a tied lm_head as
    the embedding's transpose. Takes the raw tensors over: the caller drops
    `raw`, so the unfused matrices are freed."""
    blocks = {n: _matrix(w) for n, w in raw["layers"].items()}
    lm = raw["lm_head"]
    lm_head = raw["tok_emb"].t().contiguous() if lm is None else _matrix(lm)
    return fuse_params(dict(tok_emb=raw["tok_emb"], blocks=blocks,
                            final_norm=raw["final_norm"], lm_head=lm_head))


def prompt_bucket(n: int, limit: int) -> int:
    """The rows a prefill of an n-token prompt pads to, as the Generator and
    the engine pad them (for planning the warm-up)."""
    return min(_bucket(n), limit)


def attention_window(n: int, limit: int) -> int:
    """The Generator's attention window over n cached positions."""
    return min(_bucket_len(n), limit)


def counters() -> dict:
    """Every counted kernel's launches so far, by wrapper name."""
    return {w.__name__: w.launches for w in graphs.counted_kernels()}


def graph_captures(cache) -> int:
    """Decode and prefill captures of a GraphCache so far (0 without one)."""
    if cache is None:
        return 0
    st = cache.stats()
    return st["n_captures"] + st["n_prefill_captures"]


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
