"""Tensor- and data-parallel forward, a port of kuiperllama_tpu/parallel/sharded.py.

The JAX package wraps its decoder body in shard_map so its kernels run on
local shards. Here each rank runs `decoder.forward` on its own slices
(parallel/shardings.shard_params): head counts come from the local weight
shapes, `group` adds the two all-reduces per layer (after wo and w2) and
the logits all-gather. Every rank passes the same global inputs; on the
data axis a rank keeps its own B / dp rows, and its logits stay local, as
the JAX `out_specs=P(DATA_AXIS, ...)` leaves them: pure data parallelism
issues no collective.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import ModelConfig
from ..models import decoder
from .mesh import MODEL_AXIS
from .shardings import _group_size, validate_tp


class ShardedForward:
    """A callable with `decoder.forward`'s signature that runs this rank's
    share of it. Built once per (cfg, mesh, params structure)."""

    def __init__(self, cfg: ModelConfig, mesh, params_example):
        validate_tp(cfg, mesh.shape[MODEL_AXIS], _group_size(params_example))
        self.cfg = cfg
        self.mesh = mesh

    @property
    def group(self):
        return self.mesh.model_group

    def local_rows(self, x):
        """This rank's data rows of a global [B, ...] tensor."""
        if self.mesh.dp == 1:
            return x
        n = x.shape[0] // self.mesh.dp
        return x[self.mesh.dp_rank * n: (self.mesh.dp_rank + 1) * n]

    def __call__(self, cfg, params, tokens, positions, kv_cache, kv_len_mask=None,
                 last_pos=None, *, rope=None, mode: str = "fast",
                 drop_past_end: bool = True):
        """tokens/positions [B, T], kv_len_mask [B, S] and last_pos [B] are
        the global batch (the same on every rank); params and kv_cache are
        this rank's (shard_params, shard_cache). Returns (logits
        [B / dp, T_or_1, vocab] of this rank's rows, kv_cache)."""
        if not (cfg is self.cfg or cfg == self.cfg):
            raise ValueError("ShardedForward called with another config")
        B = tokens.shape[0]
        if B % self.mesh.dp:
            raise ValueError(f"batch {B} does not split over dp={self.mesh.dp}")
        rows = self.local_rows
        return decoder.forward(
            cfg, params, rows(tokens), rows(positions), kv_cache,
            None if kv_len_mask is None else rows(kv_len_mask),
            None if last_pos is None else rows(last_pos), rope=rope,
            mode=mode, drop_past_end=drop_past_end, group=self.group)

    # -- placement

    def shard_cache(self, kv_cache):
        """This rank's part of a dense cache {k, v} [L, B, S, KH, hd]: its
        data rows and its kv heads, each a contiguous tensor."""
        tp, t = self.mesh.tp, self.mesh.tp_rank

        def part(x):
            x = self.local_rows(x.transpose(0, 1)).transpose(0, 1)
            kh = x.shape[3] // tp
            return x[:, :, :, t * kh:(t + 1) * kh].contiguous()

        return {k: part(v) for k, v in kv_cache.items()}

    def init_cache(self, batch: int, max_len: Optional[int] = None,
                   dtype=torch.float32, device="cuda"):
        """Zeros of this rank's cache part for a global batch of `batch`."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch // self.mesh.dp, max_len or cfg.seq_len,
                 cfg.n_kv_heads // self.mesh.tp, cfg.head_dim)
        return dict(k=torch.zeros(shape, dtype=dtype, device=device),
                    v=torch.zeros(shape, dtype=dtype, device=device))

    @property
    def key(self) -> tuple:
        return ("tp",) + self.mesh.key
