"""Generation loops over a dense KV cache, a port of
kuiperllama_tpu/serving/generate.py.

  * prefill is ONE batched forward over the whole (bucket-padded) prompt;
  * decode runs in chunks of N steps with sampling on the device: tokens
    reach the host once per chunk, never once per token;
  * stop tokens are handled on the device: a `done` flag freezes finished
    rows, the host truncates after fetching the chunk;
  * the prompt is padded to `_bucket` rows and the attention window to
    `_bucket_len` slots, as in the JAX package, so row counts, and with them
    the INT8 kernel routes, are the same on both sides;
  * at B = 1 the decode step takes one of three megakernels, chosen per
    chunk as the JAX `decode_chunk` chooses (the KT_* knobs of
    ops/tuning.py):
      - a model whose layer fits the small plan (TinyLlama-1.1B,
        Llama-3.2-1B, Qwen2.5-0.5B) takes ops/kernels/fused_decode.py: one
        launch for the layer stack per step, then the lm_head and the
        sampling glue;
      - with KT_FUSED_CHUNK=1 and greedy sampling, such a model takes the
        chunk megakernel instead: one launch for all the chunk's steps,
        lm_head and argmax included;
      - with KT_FUSED_BIG=1 a model beyond the small plan whose layer fits
        the big plan (Llama-2-7B and Llama-3-8B at group 64, or with fp32
        scales) takes ops/kernels/fused_decode_big.py per step, then the
        lm_head; without it, and at group 256 with bf16 scales, such a
        model decodes layered.

Spans (utils/profiling.py), recorded only while a torch profiler records:
`kt.gen.request` around each `generate_batch_ids` call, and inside it
`kt.gen.prefill` (its graph key, prompt tokens and computed ones, `replay`,
`capture` or `eager`) with the first-token fetch inside it as
`kt.gen.sync`; then for each decode chunk `kt.gen.chunk` (steps, route:
`small`, `big`, `layered` or `chunk`, attention window), `kt.gen.sync` (the
fetch of its tokens) and `kt.gen.collect` (`on_chunk` and the kept lists;
one follows the prefill too, for its token). No span is taken per decode
step or per graph replay.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig
from ..models import decoder
from ..ops import linear as linear_mod
from ..ops import tuning
from ..ops.kernels.fused_decode import (fits_vmem, fused_decode_chunk,
                                        fused_decode_step)
from ..ops.kernels.fused_decode_big import fits_vmem_big, fused_decode_step_big
from ..ops.linear import linear
from ..ops.sampling import DecodeState, sample_token
from ..utils.profiling import span, tracing
from .graphs import GraphCache, run_once, run_steps

MAX_STOP_IDS = 8


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _bucket_len(n: int, quantum: int = 256) -> int:
    return -(-n // quantum) * quantum


def _stop_array(stop_ids, device) -> torch.Tensor:
    ids = sorted(set(int(i) for i in stop_ids))[:MAX_STOP_IDS]
    arr = np.full((MAX_STOP_IDS,), -1, np.int32)
    arr[: len(ids)] = ids
    return torch.from_numpy(arr).to(device)


def _flat_cache(cache):
    """[L, A, KH*hd] views of a B = 1 (windowed) cache: the megakernels
    write through them."""
    L, _, A, KH, hd = cache["k"].shape
    return cache["k"].view(L, A, KH * hd), cache["v"].view(L, A, KH * hd)


def _fused_logits(cfg: ModelConfig, params, token, pos, cache, rope,
                  big=False):
    """One B = 1 decode step through a per-step megakernel (the big-model
    one when `big`): the embedding row, one launch for the layer stack (the
    new K/V rows land in the cache in place), then the lm_head in fp32
    logits."""
    x0 = params["tok_emb"][token.long()]  # [1, d]
    step = fused_decode_step_big if big else fused_decode_step
    x_fin, _, _ = step(cfg, params, x0, *_flat_cache(cache), pos, *rope)
    return linear(x_fin, params["lm_head"]).float()


def _greedy(temperature: float, top_k: int, top_p: float) -> bool:
    return temperature <= 0.0 and top_k == 0 and top_p >= 1.0


def chunk_route(params, cache_dtype, window: int, fused: bool,
                greedy: bool) -> str:
    """The route of a decode chunk over a `window`-slot attention window:
    "layered" unless `fused`; else the small plan's per-step megakernel
    ("small"), or its chunk kernel ("chunk", greedy under
    KT_FUSED_CHUNK=1), then under KT_FUSED_BIG=1 the big plan's ("big"),
    and "layered" where no plan fits."""
    if not fused:
        return "layered"
    blocks = params["blocks"]
    if fits_vmem(blocks, cache_dtype, window):
        return "chunk" if greedy and tuning.fused_chunk_on() else "small"
    if tuning.fused_big_on() and fits_vmem_big(blocks, cache_dtype, window):
        return "big"
    return "layered"


def decode_chunk(cfg: ModelConfig, params, state: DecodeState, kv_cache,
                 generator, steps: int, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0, active_len: int = 0,
                 rope=None, fused: bool = False, drop_past_end: bool = True,
                 graphs: Optional[GraphCache] = None, forward_fn=None):
    """Run `steps` decode iterations on the device.

    state: the batch's token, pos (int32 [B]), done (bool [B], rows already
      finished: their pos stays frozen) and stop ids, updated IN PLACE.
    active_len: cap on the cache slots attention reads this chunk (0 = all).
      The window is a view of the cache, so the steps' in-place writes land
      in the full cache and need no write-back.
    fused: take a B = 1 decode megakernel. The chunk re-checks the plans
      for its own window, as the JAX `decode_chunk` does: the small plan
      first, then under KT_FUSED_BIG=1 the big one; when neither fits it
      decodes layered. With the small plan, greedy sampling and
      KT_FUSED_CHUNK=1 the whole chunk is one launch of the chunk kernel;
      finished rows are then not frozen inside the chunk and pos moves by
      `steps` (the host truncates at the first stop token, as with the
      other routes).
    drop_past_end: a position at or past the window drops its cache write
      (decoder.forward); False promises that no row gets there.
    graphs: replay each step as a CUDA graph (serving/graphs.py), keyed as
      the JAX package keys its jitted chunk: (route, B, window, cache
      dtype, sampling, mode, drop_past_end), and a forward_fn's mesh key.
      The chunk kernel's route is one launch a chunk already and stays
      eager.
    forward_fn: runs each step's forward in place of `decoder.forward`
      (parallel/sharded.py ShardedForward, on this rank's weights and
      cache; the megakernels do not apply).
    Returns (tokens int32 [B, steps], token, pos, kv_cache, done), all on
    the device; token, pos and done are the state's. Emitted tokens after a
    row finishes repeat the stop token.
    """
    S = kv_cache["k"].shape[2]
    cache = kv_cache
    if active_len and active_len < S:
        cache = dict(k=kv_cache["k"][:, :, :active_len],
                     v=kv_cache["v"][:, :, :active_len])
    if fused and forward_fn is not None:
        raise ValueError("decode_chunk: the megakernels take no forward_fn")
    route = chunk_route(params, kv_cache["k"].dtype, cache["k"].shape[2], fused,
                        _greedy(temperature, top_k, top_p))
    fused, big = route in ("small", "big", "chunk"), route == "big"
    if fused and rope is None:
        rope = decoder.build_rope(cfg, state.token.device)
    if route == "chunk":
        x0 = params["tok_emb"][state.token.long()]  # [1, d]
        toks1, _, _ = fused_decode_chunk(cfg, params, x0, *_flat_cache(cache),
                                         state.pos, *rope, steps)
        state.done.copy_(state.done | (toks1[:, None] == state.stop[None, :]).any())
        state.token.copy_(toks1[-1:])
        state.pos.add_(steps)
        return toks1[None], state.token, state.pos, kv_cache, state.done

    def step():
        if fused:
            logits = _fused_logits(cfg, params, state.token, state.pos, cache,
                                   rope, big)
        else:
            logits, _ = decoder.decode_step(cfg, params, state.token, state.pos,
                                            cache, rope=rope,
                                            drop_past_end=drop_past_end,
                                            forward_fn=forward_fn)
        state.emit(logits, generator, temperature, top_k, top_p)

    key = (route, state.token.shape[0], cache["k"].shape[2], kv_cache["k"].dtype,
           temperature, top_k, top_p, "fast", drop_past_end,
           getattr(forward_fn, "key", None))
    static = (cache["k"], cache["v"], *(rope or ()))
    toks = run_steps(state, step, steps, graphs, key, static, rng=temperature > 0)
    return toks, state.token, state.pos, kv_cache, state.done


@dataclass
class GenerateResult:
    text: str
    tokens: List[int]
    prompt_tokens: int
    prefill_s: float
    decode_s: float

    @property
    def tokens_per_s(self) -> float:
        n = len(self.tokens)
        return n / self.decode_s if self.decode_s > 0 else float("inf")


class Generator:
    """Single- and batched-request generation over a dense KV cache, on the
    device that holds `params`.

    fused_step: the B = 1 decode megakernels. None (auto) takes them when
    the params lie on a CUDA device, the model fits a plan and the kernels
    are on (`ops.linear.set_use_kernels`; KT_FUSED_STEP=0/1 overrides
    auto); True forces them (on the CPU that
    runs their plain versions, as the tests do); False turns them off.

    graphs: replay the prefill and each decode step as CUDA graphs
    (serving/graphs.py; the chunk kernel's route stays eager). None (auto)
    takes them when the params lie on a CUDA device and the kernels are on;
    False keeps the eager route; True on the CPU raises ValueError. Both
    routes run the same step functions (`_prefill_step`, `decode_chunk`)
    and give the same tokens. The prefill's graph is keyed as the JAX
    package keys its jitted prefill: (B, bucketed T, cache length and
    dtype, sampling, mode, forward_fn's mesh key).

    The cache, the decode state and the prefill's last logits
    (`prefill_logits[B]`, fp32 [B, vocab]) of each batch size are kept
    across calls (a graph keeps their pointers), the cache zeroed at the
    start of each call, and so are the prompt buffers of each (B, T); one
    torch.Generator is reseeded with each call's seed.

    forward_fn: a tensor-parallel forward (parallel/sharded.py
    ShardedForward) over this rank's `params`, as the JAX Generator takes
    one: every rank of the model group runs the same calls with the same
    prompts and seed, and samples the same token from the same gathered
    logits. The cache is `forward_fn.shard_cache`'s part, the megakernels
    are off, and decode graphs are taken only where the group's
    collectives can be captured (NCCL): under gloo the route is eager
    (graphs=True there raises). Its mesh must have dp = 1: the Generator's
    state is the whole batch."""

    def __init__(self, cfg: ModelConfig, params, tokenizer=None,
                 cache_len: Optional[int] = None, cache_dtype=torch.float32,
                 chunk: int = 64, fused_step: Optional[bool] = None,
                 graphs: Optional[bool] = None, forward_fn=None):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.cache_len = cache_len or cfg.seq_len
        self.cache_dtype = cache_dtype
        self.chunk = chunk
        self.fused_step = fused_step
        self.forward_fn = forward_fn
        self.device = params["tok_emb"].device
        if graphs and self.device.type != "cuda":
            raise ValueError(f"graphs=True needs the params on a CUDA device, "
                             f"not {self.device}")
        mesh = getattr(forward_fn, "mesh", None)
        if mesh is not None and mesh.dp != 1:
            raise ValueError(f"Generator: a forward_fn over dp={mesh.dp} data "
                             "ranks; each data rank runs its own Generator on "
                             "a tp-only mesh")
        if graphs and mesh is not None and not mesh.graphs_capturable():
            raise ValueError(f"graphs=True: the {mesh.backend} group's "
                             "collectives cannot be captured in a CUDA graph")
        self.graphs = graphs
        self.rope = decoder.build_rope(cfg, self.device)
        self.rng = torch.Generator(device=self.device)
        self.graph_cache = GraphCache(self.device, self.rng)
        self._decode: dict = {}  # B -> (cache, DecodeState)
        self.prefill_logits: dict = {}  # B -> fp32 [B, vocab]
        self._prompts: dict = {}  # (B, T) -> int32 [B * T + B]: tokens, lengths
        self._calls = itertools.count()  # a call's id on its spans

    def graphs_on(self) -> bool:
        """Whether decode steps replay CUDA graphs (see `graphs`)."""
        if self.graphs is not None:
            return self.graphs
        mesh = getattr(self.forward_fn, "mesh", None)
        return (self.device.type == "cuda" and linear_mod.kernels_on()
                and (mesh is None or mesh.graphs_capturable()))

    def _batch(self, B: int, stop_ids):
        """The B-row cache and decode state, zeroed, with `stop_ids`."""
        entry = self._decode.get(B)
        if entry is None:
            dev = self.device
            cache = decoder.init_kv_cache(self.cfg, batch=B, max_len=self.cache_len,
                                          dtype=self.cache_dtype, device=dev)
            if self.forward_fn is not None:
                cache = self.forward_fn.shard_cache(cache)
            state = DecodeState(torch.zeros((B,), dtype=torch.int32, device=dev),
                                torch.zeros((B,), dtype=torch.int32, device=dev),
                                torch.zeros((B,), dtype=torch.bool, device=dev),
                                _stop_array((), dev), self.chunk)
            self._decode[B] = entry = (cache, state)
            self.prefill_logits[B] = torch.zeros((B, self.cfg.vocab_size),
                                                 dtype=torch.float32, device=dev)
        else:
            entry[0]["k"].zero_()
            entry[0]["v"].zero_()
        entry[1].stop.copy_(_stop_array(stop_ids, self.device))
        return entry

    def _prefill_step(self, tokens: np.ndarray, lens, temperature: float,
                      top_k: int, top_p: float):
        """The prefill of [B, T] prompt `tokens` (lengths `lens`) into the
        B-row cache as one step function over fixed tensors: the prompt
        buffer of (B, T), filled here by one host-to-device copy, the cache,
        the decode state (token, done flag, pos) and the last logits, which
        it writes in place. Returns (fn, key, static)."""
        B, T = tokens.shape
        dev = self.device
        buf = self._prompts.get((B, T))
        if buf is None:
            buf = self._prompts[(B, T)] = torch.zeros((B * T + B,),
                                                      dtype=torch.int32, device=dev)
        buf.copy_(torch.from_numpy(np.concatenate(
            [tokens.ravel(), np.asarray(lens, np.int32)])))
        toks, lens_dev = buf[:B * T].view(B, T), buf[B * T:]
        cache, state = self._decode[B]
        logits = self.prefill_logits[B]

        def fn():
            last, _ = decoder.prefill(self.cfg, self.params, toks, cache,
                                      prompt_lens=lens_dev, rope=self.rope,
                                      forward_fn=self.forward_fn)
            logits.copy_(last)
            token = sample_token(last, self.rng, temperature, top_k, top_p)
            state.token.copy_(token)
            state.done.copy_((token[:, None] == state.stop[None, :]).any(dim=-1))
            state.pos.copy_(lens_dev)

        key = ("prefill", B, T, self.cache_len, self.cache_dtype, temperature,
               top_k, top_p, "fast", getattr(self.forward_fn, "key", None))
        static = (buf, cache["k"], cache["v"], logits, *state.tensors(),
                  *self.rope)
        return fn, key, static

    def _fused_ok(self, B: int) -> bool:
        """Whether decode takes a megakernel: B = 1, fused weights and a plan
        that fits at the smallest window, the big plan only under
        KT_FUSED_BIG=1 (each chunk re-checks its own window in
        `decode_chunk`)."""
        if B != 1 or self.fused_step is False or self.forward_fn is not None:
            return False
        blocks = self.params["blocks"]
        alen = min(_bucket_len(1), self.cache_len)
        structural = "wqkv" in blocks and (
            fits_vmem(blocks, self.cache_dtype, alen)
            or (tuning.fused_big_on()
                and fits_vmem_big(blocks, self.cache_dtype, alen)))
        if self.fused_step is True:
            return structural
        env = tuning.fused_step_env()
        if env is not None:
            return structural and env
        return (structural and linear_mod.kernels_on()
                and self.device.type == "cuda")

    def generate_batch_ids(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: int = 128,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
        stop_ids=frozenset(),
        on_chunk=None,
    ):
        """Batched generation. Returns (list of id-lists, prefill_s, decode_s).

        on_chunk: optional callback invoked with the raw [B, n] numpy token
        block as each decode chunk lands on the host (tokens after a row's
        stop token repeat; the returned lists are already truncated)."""
        cfg = self.cfg
        B = len(prompts)
        lens = [len(p) for p in prompts]
        assert min(lens) >= 1
        limit = min(self.cache_len, cfg.seq_len)
        assert max(lens) < limit, (max(lens), limit)

        T = min(_bucket(max(lens)), limit)
        tokens = np.zeros((B, T), np.int32)
        for i, p in enumerate(prompts):
            tokens[i, : lens[i]] = p

        with span("kt.gen.request", ids=(next(self._calls),), B=B, T=T):
            cache, state = self._batch(B, stop_ids)
            gen = self.rng
            gen.manual_seed(seed)
            graphs = self.graph_cache if self.graphs_on() else None

            t0 = time.perf_counter()
            with span("kt.gen.prefill", tokens=sum(lens), computed=B * T) as sp:
                fn, key, static = self._prefill_step(tokens, lens, temperature,
                                                     top_k, top_p)
                sp.set(key=key, graph=run_once(graphs, key, fn, static,
                                               rng=temperature > 0))
                with span("kt.gen.sync"):
                    first = state.token.cpu().numpy()  # host copy; syncs prefill
            t1 = time.perf_counter()
            with span("kt.gen.collect"):
                if on_chunk is not None:
                    on_chunk(first[:, None])
                out = [[int(first[i])] for i in range(B)]

            budget = min(max_new_tokens, limit - max(lens)) - 1
            max_pos = max(lens)
            fused = self._fused_ok(B)
            done = state.done
            while budget > 0 and not bool(done.all()):
                steps = min(self.chunk, budget)
                assert max_pos + steps <= limit, (max_pos, steps, limit)
                active = min(_bucket_len(max_pos + steps + 1), self.cache_len)
                with span("kt.gen.chunk", steps=steps, window=active) as sp:
                    if tracing():
                        sp.set(route=chunk_route(
                            self.params, cache["k"].dtype, active, fused,
                            _greedy(temperature, top_k, top_p)))
                    toks, _, _, cache, done = decode_chunk(
                        cfg, self.params, state, cache, gen, steps=steps,
                        temperature=temperature, top_k=top_k, top_p=top_p,
                        active_len=active, rope=self.rope, fused=fused,
                        drop_past_end=False, graphs=graphs,
                        forward_fn=self.forward_fn,
                    )
                max_pos += steps
                with span("kt.gen.sync"):
                    toks_np = toks.cpu().numpy()  # the chunk's one trip to the host
                with span("kt.gen.collect"):
                    if on_chunk is not None:
                        on_chunk(toks_np)
                    for i in range(B):
                        out[i].extend(int(t) for t in toks_np[i])
                budget -= steps
            decode_s = time.perf_counter() - t1

            # truncate at (and drop) the first stop token per row
            stops = set(int(i) for i in stop_ids)
            cleaned = []
            for row in out:
                cut = len(row)
                for j, t in enumerate(row):
                    if t in stops:
                        cut = j
                        break
                cleaned.append(row[:cut])
        return cleaned, t1 - t0, decode_s

    def generate_ids(self, prompt_ids: Sequence[int], max_new_tokens: int = 128,
                     **kw):
        rows, prefill_s, decode_s = self.generate_batch_ids(
            [prompt_ids], max_new_tokens, **kw
        )
        return rows[0], prefill_s, decode_s

    def generate(self, prompt: str, max_new_tokens: int = 128, **kw) -> GenerateResult:
        assert self.tokenizer is not None, "no tokenizer configured"
        tok = self.tokenizer
        prompt_ids = tok.encode(prompt)
        stop = kw.pop("stop_ids", tok.stop_ids)
        ids, prefill_s, decode_s = self.generate_ids(
            prompt_ids, max_new_tokens, stop_ids=stop, **kw
        )
        return GenerateResult(
            text=tok.decode(ids),
            tokens=ids,
            prompt_tokens=len(prompt_ids),
            prefill_s=prefill_s,
            decode_s=decode_s,
        )
