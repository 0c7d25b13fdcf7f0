"""Tensor-parallel paged serving, a port of
kuiperllama_tpu/parallel/sharded_paged.py.

The JAX package runs its paged decode and prefill bodies under shard_map;
here each rank calls them (models/paged.py) on its own slices with the
model group, and the kernels run at shard shapes:
  * weights: Megatron slices (parallel/shardings.py); wo and w2 summed
    over the group inside each layer;
  * page pools [L, P, ps, KH*hd]: split over the lane dim, which is
    kv-head-major, so each rank holds a contiguous block of kv heads of
    every page and the host's page tables and work lists stay global;
  * scheduler state (tokens, positions, page tables, work lists, the
    sampling generator's seed): the same on every rank, which makes the same
    admission decisions;
  * logits: vocab-split, gathered before sampling, so every rank samples
    the same token.
Collectives per decode step: 2 L all-reduces and 1 logits all-gather.
"""

from __future__ import annotations

from ..config import ModelConfig
from ..kvcache import init_paged_cache
from ..models import paged
from .mesh import MODEL_AXIS
from .shardings import _group_size, validate_tp


class ShardedPagedStep:
    """This rank's counterpart of models/paged.py's entry points; built once
    per (cfg, mesh, params structure). `decode_chunk`, `prefill` and
    `prefill_chunk` take the signatures of decode_chunk_paged,
    prefill_paged and prefill_chunk_paged on this rank's params and pools;
    `run_chunk` is the engine's in-place decode chunk."""

    seqpar = False

    def __init__(self, cfg: ModelConfig, mesh, params_example):
        self._validate(cfg, mesh.shape[MODEL_AXIS], _group_size(params_example))
        self.cfg = cfg
        self.mesh = mesh

    @staticmethod
    def _validate(cfg, n, g):
        validate_tp(cfg, n, g)

    @property
    def group(self):
        return self.mesh.model_group

    def _check(self, cfg):
        if not (cfg is self.cfg or cfg == self.cfg):
            raise ValueError(f"{type(self).__name__} called with another config")

    def _kw(self):
        return dict(group=self.group, seqpar=self.seqpar)

    @property
    def key(self) -> tuple:
        """What the engine's prefill graph keys carry for this rank's step:
        its kind and its mesh's key (parallel/mesh.py Mesh.key)."""
        return ("seqpar" if self.seqpar else "tp",) + self.mesh.key

    # -- the entry points of models/paged.py

    def decode_chunk(self, cfg, params, token, pos, k_pages, v_pages, done,
                     generator, stop_ids, page_table_dev, flat_b, flat_page,
                     flat_tok0, n_items, steps, page_size=128, temperature=0.0,
                     top_k=0, top_p=1.0, *, rope=None, mode="fast", covered=None):
        self._check(cfg)
        if self.seqpar and covered is None:
            raise ValueError("seqpar decode needs the covered rows")
        return paged.decode_chunk_paged(
            cfg, params, token, pos, k_pages, v_pages, done, generator, stop_ids,
            page_table_dev, flat_b, flat_page, flat_tok0, n_items, steps,
            page_size, temperature, top_k, top_p, rope=rope, mode=mode,
            covered=covered, **self._kw())

    def prefill(self, cfg, params, tokens, prompt_lens, k_pages, v_pages,
                token_pages, token_offs=None, *, rope=None, mode="fast"):
        self._check(cfg)
        return paged.prefill_paged(cfg, params, tokens, prompt_lens, k_pages,
                                   v_pages, token_pages, token_offs, rope=rope,
                                   mode=mode, **self._kw())

    def prefill_chunk(self, cfg, params, tokens_chunk, chunk_start, row_lens,
                      k_pages, v_pages, chunk_pages, hist_pages, *, rope=None,
                      mode="fast"):
        self._check(cfg)
        return paged.prefill_chunk_paged(
            cfg, params, tokens_chunk, chunk_start, row_lens, k_pages, v_pages,
            chunk_pages, hist_pages, rope=rope, mode=mode, **self._kw())

    def run_chunk(self, cfg, params, state, k_pages, v_pages, generator, meta,
                  steps, page_size=128, temperature=0.0, top_k=0, top_p=1.0, *,
                  rope=None, mode="fast", graphs=None):
        """models/paged.run_chunk_paged on this rank, its graphs keyed by the
        mesh too."""
        self._check(cfg)
        return paged.run_chunk_paged(
            cfg, params, state, k_pages, v_pages, generator, meta, steps,
            page_size, temperature, top_k, top_p, rope=rope, mode=mode,
            graphs=graphs, mesh_key=self.mesh.key, **self._kw())

    # -- placement

    def shard_pages(self, k_pages, v_pages):
        """This rank's block of kv-head lanes of full pools [L, P, ps,
        KH*hd], contiguous."""
        n, t = self.mesh.tp, self.mesh.tp_rank
        lanes = k_pages.shape[-1] // n
        return tuple(p[..., t * lanes:(t + 1) * lanes].contiguous()
                     for p in (k_pages, v_pages))

    def init_pages(self, n_pages: int, page_size: int, dtype, device):
        """Zeroed pools of this rank's part: n_pages pages of its kv heads."""
        cache = init_paged_cache(self.cfg, n_pages, page_size, dtype,
                                 n_kv_heads=self.cfg.n_kv_heads // self.mesh.tp,
                                 device=device)
        return cache.k_pages, cache.v_pages
