"""Model hyperparameter configuration.

A copy of the JAX package's `config.py`: the model family's knobs (RoPE
theta and pairing, rmsnorm eps, qkv bias, tied lm_head) are runtime data
carried by one frozen dataclass, derived from the llama2.c checkpoint
header plus per-family presets.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional


# RoPE pairing conventions:
#   "interleaved": llama2.c-v0 style — rotate adjacent pairs (i, i+1);
#   "half":        HF / llama3 / qwen2 style — rotate pairs (i, i + head_size/2).
ROPE_INTERLEAVED = "interleaved"
ROPE_HALF = "half"


@dataclass(frozen=True)
class RopeScaling:
    """Llama-3.x frequency-dependent RoPE scaling (HF rope_scaling dict,
    rope_type="llama3"), plus the trivial "linear" variant."""

    rope_type: str  # "llama3" | "linear"
    factor: float
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192

    @staticmethod
    def from_hf(d: Optional[dict]) -> Optional["RopeScaling"]:
        """Parse an HF config.json rope_scaling dict (None/default passthrough)."""
        if not d:
            return None
        rope_type = d.get("rope_type", d.get("type", "default"))
        if rope_type == "default":
            return None
        if rope_type == "linear":
            return RopeScaling(rope_type="linear", factor=float(d["factor"]))
        if rope_type == "llama3":
            return RopeScaling(
                rope_type="llama3",
                factor=float(d["factor"]),
                low_freq_factor=float(d["low_freq_factor"]),
                high_freq_factor=float(d["high_freq_factor"]),
                original_max_position_embeddings=int(
                    d["original_max_position_embeddings"]
                ),
            )
        raise ValueError(f"unsupported rope_scaling type {rope_type!r}")


@dataclass(frozen=True)
class ModelConfig:
    """Runtime model description. All family-specific knobs are data."""

    family: str  # "llama2" | "llama3" | "qwen2"
    dim: int
    hidden_dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    vocab_size: int
    seq_len: int  # maximum context length
    rope_theta: float
    rope_style: str  # ROPE_INTERLEAVED or ROPE_HALF
    norm_eps: float
    qkv_bias: bool  # Qwen2 carries q/k/v projection biases
    tied_embedding: bool  # lm_head shares the token-embedding matrix
    group_size: Optional[int] = None  # INT8 weight-quant group size (None = fp)
    rope_scaling: Optional[RopeScaling] = None  # Llama-3.1+/3.2 scaling

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def kv_mul(self) -> int:
        """GQA group size: queries per kv head."""
        return self.n_heads // self.n_kv_heads

    def __post_init__(self):
        assert self.dim % self.n_heads == 0, (self.dim, self.n_heads)
        assert self.n_heads % self.n_kv_heads == 0, (self.n_heads, self.n_kv_heads)
        assert self.rope_style in (ROPE_INTERLEAVED, ROPE_HALF), self.rope_style
        assert self.family in _FAMILY_PRESETS, self.family

    @staticmethod
    def from_header(
        family: str,
        dim: int,
        hidden_dim: int,
        n_layers: int,
        n_heads: int,
        n_kv_heads: int,
        vocab_size: int,
        seq_len: int,
        tied_embedding: bool,
        group_size: Optional[int] = None,
        **overrides,
    ) -> "ModelConfig":
        """Build a config from llama2.c-style header fields + family presets."""
        preset = dict(_FAMILY_PRESETS[family])
        preset.update(overrides)
        return ModelConfig(
            family=family,
            dim=dim,
            hidden_dim=hidden_dim,
            n_layers=n_layers,
            n_heads=n_heads,
            n_kv_heads=n_kv_heads,
            vocab_size=vocab_size,
            seq_len=seq_len,
            tied_embedding=tied_embedding,
            group_size=group_size,
            **preset,
        )

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "ModelConfig":
        d = json.loads(s)
        if d.get("rope_scaling"):
            d["rope_scaling"] = RopeScaling(**d["rope_scaling"])
        return ModelConfig(**d)


# Family presets:
#   llama2: theta 10000, eps 1e-5, interleaved pairs
#   llama3: theta 500000, eps 1e-5, half-split pairs
#   qwen2:  theta 1000000, eps 1e-6, half-split pairs, qkv bias
_FAMILY_PRESETS = {
    "llama2": dict(
        rope_theta=10000.0, rope_style=ROPE_INTERLEAVED, norm_eps=1e-5, qkv_bias=False
    ),
    "llama3": dict(
        rope_theta=500000.0, rope_style=ROPE_HALF, norm_eps=1e-5, qkv_bias=False
    ),
    "qwen2": dict(
        rope_theta=1000000.0, rope_style=ROPE_HALF, norm_eps=1e-6, qkv_bias=True
    ),
}


# Well-known model shapes (for benches and synthetic checkpoints; real runs
# take these from the checkpoint header).
MODEL_SHAPES = {
    "stories15m": dict(family="llama2", dim=288, hidden_dim=768, n_layers=6,
                       n_heads=6, n_kv_heads=6, vocab_size=32000, seq_len=256,
                       tied_embedding=True),
    "tinyllama-1.1b": dict(family="llama2", dim=2048, hidden_dim=5632,
                           n_layers=22, n_heads=32, n_kv_heads=4,
                           vocab_size=32000, seq_len=2048,
                           tied_embedding=False),
    "llama2-7b": dict(family="llama2", dim=4096, hidden_dim=11008,
                      n_layers=32, n_heads=32, n_kv_heads=32,
                      vocab_size=32000, seq_len=2048, tied_embedding=False),
    "llama3.2-1b": dict(family="llama3", dim=2048, hidden_dim=8192,
                        n_layers=16, n_heads=32, n_kv_heads=8,
                        vocab_size=128256, seq_len=8192, tied_embedding=True,
                        # HF meta-llama/Llama-3.2-1B config.json rope_scaling
                        rope_scaling=RopeScaling(
                            rope_type="llama3", factor=32.0,
                            low_freq_factor=1.0, high_freq_factor=4.0,
                            original_max_position_embeddings=8192)),
    "llama3-8b": dict(family="llama3", dim=4096, hidden_dim=14336,
                      n_layers=32, n_heads=32, n_kv_heads=8,
                      vocab_size=128256, seq_len=8192, tied_embedding=False),
    "qwen2.5-0.5b": dict(family="qwen2", dim=896, hidden_dim=4864,
                         n_layers=24, n_heads=14, n_kv_heads=2,
                         vocab_size=151936, seq_len=4096, tied_embedding=True),
}


def preset_config(name: str, **overrides) -> ModelConfig:
    spec = dict(MODEL_SHAPES[name])
    spec.update(overrides)
    family = spec.pop("family")
    return ModelConfig.from_header(family=family, **spec)


def tiny_config(family: str = "llama2", **overrides) -> ModelConfig:
    """A small config for tests (shapes aligned enough to exercise real paths)."""
    base = dict(
        dim=64,
        hidden_dim=192,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        vocab_size=512,
        seq_len=128,
        tied_embedding=False,
    )
    hdr = {k: overrides.pop(k, v) for k, v in base.items()}
    return ModelConfig.from_header(family=family, **hdr, **overrides)
