"""The port's model configuration and weights of the Qwen2 decoder
(Qwen2.5), built from the benchmark's configuration and raw weights
(layouts/qwen2.py)."""

from __future__ import annotations

from kuiperllama_tpu_torch.config import ModelConfig
from kuiperllama_tpu_torch.fuse import fuse_params
from kuiperllama_tpu_torch.quant import QuantTensor


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
