"""Continuous-batching serving engine, a port of
kuiperllama_tpu/serving/engine.py.

The engine keeps a slot-per-request batch over a persistent KV cache:
requests are admitted into free slots, all active slots decode together in
chunks, and finished rows retire and free their slot for the next queued
request. Every request admitted at a step boundary prefills in ONE batched
forward: on the PagedEngine on one device, the admitted prompts' real
tokens packed into one stream padded only to its own bucket; elsewhere a
[max_batch, bucket] grid.

Two cache backends:
  Engine      dense cache [L, max_batch, max_len, KH, hd];
  PagedEngine paged pool and the paged flash-decode kernel (memory scales
              with real tokens), with chunked admission, decode-growth
              reservation and preemption under pool pressure; with mesh=,
              tensor- or sequence-parallel over the ranks of a mesh
              (parallel/sharded_paged.py, parallel/seqpar.py).

Host/device split: the device owns tokens, positions, done flags and the KV
cache (written in place across chunks); the host owns the request queue and
the page allocator, and reads each decode chunk's output in ONE fetch.
Sampling draws come from one torch.Generator on the engine's device (the
JAX engine splits a jax.random key); admission samples greedily, as the
JAX engine does.

Decode steps and prefills replay CUDA graphs on the card
(serving/graphs.py; `graphs=` as the Generator takes it): the token,
position and done tensors, the caches and the PagedEngine's packed chunk
metadata are fixed tensors that admission, retirement and preemption write
in place, never rebind. Each prefill reads its inputs from one fixed int32
buffer per graph key, filled by one host-to-device copy
(`_prefill_inputs`), and writes its last logits, first tokens and done
flags into the engine's fixed `prefill_logits`, `prefill_first` and
`prefill_done`, in admit order; the keys are the JAX package's jit keys:
("admit", max_batch, T, S, cache dtype) for the dense admit,
("prefill_paged", max_batch, T, mesh) and ("prefill_chunk", max_batch, C,
n_hist, mesh) for the paged ones, where the chunk's start is an input;
and ("prefill_packed", N, max_batch) for the packed stream of N tokens,
which no row count enters.

Spans (utils/profiling.py), recorded only while a torch profiler records:
`kt.engine.step` around each step, and inside it, in order,
`kt.engine.admit` (the requests admitted, each one's wait since
`submit()`, the queued ones left and why: `no_slot` or `no_pages`),
`kt.engine.prefill` (its graph key, rows real and padded, T, prompt tokens
and computed ones, `replay`, `capture` or `eager`; a packed stream is one
row of T = N tokens and says `packed`; a chunked wave gives one a chunk),
`kt.engine.sync` (the host blocked in a fetch: after the prefill, after
the chunk), `kt.engine.chunk` (steps, rows, and for the PagedEngine the
pool's pages by use) and `kt.engine.collect` (the requests retired).
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig
from ..models import decoder
from ..ops.linear import kernels_on
from ..ops.sampling import DecodeState, sample_greedy
from ..utils.profiling import span, tracing
from .generate import _bucket, _bucket_len, _stop_array, decode_chunk
from .graphs import GraphCache, run_once


@dataclass
class Request:
    prompt_ids: List[int]
    max_new_tokens: int = 128
    request_id: int = field(default_factory=itertools.count().__next__)
    # filled by the engine (time.perf_counter()):
    out_ids: List[int] = field(default_factory=list)
    submit_time: float = 0.0  # the first stamp: the server's, or submit()'s
    queued_time: float = 0.0  # submit()'s own, at every submission
    admit_time: float = 0.0   # the first admission into a slot
    first_token_time: float = 0.0
    finish_time: float = 0.0
    preempted: int = 0  # times evicted mid-decode under pool pressure

    @property
    def ttft_s(self) -> float:
        return self.first_token_time - self.submit_time

    @property
    def finished(self) -> bool:
        return self.finish_time > 0


# sentinel slot for padding rows of a batched admit
_PAD_SLOT = 2 ** 30


@torch.no_grad()
def _admit_prefill(cfg: ModelConfig, params, tokens, n_tokens, admit_mask,
                   kv_cache, stop_ids, rope=None):
    """Batched prefill of admitted prompts DIRECTLY into their dense-cache
    slots, in place.

    tokens [maxB, T] laid out BY SLOT (row s = slot s's prompt); n_tokens
    [maxB]; admit_mask [maxB] bool, True for freshly admitted slots. Rows of
    slots that are not being admitted (live decode slots, free slots) carry
    padding and must not touch the cache: their positions are the sentinel
    S, whose writes decoder.forward drops. Returns (first [maxB], done
    [maxB], last logits [maxB, vocab]), indexed by slot."""
    B, T = tokens.shape
    S = kv_cache["k"].shape[2]
    dev = tokens.device
    positions = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    positions = torch.where(admit_mask[:, None], positions,
                            torch.full_like(positions, S))
    kv_len_mask = torch.arange(S, device=dev)[None] < n_tokens[:, None]
    logits, _ = decoder.forward(cfg, params, tokens, positions, kv_cache,
                                kv_len_mask, last_pos=n_tokens - 1, rope=rope)
    token = sample_greedy(logits[:, 0])
    done = (token[:, None] == stop_ids[None, :]).any(dim=-1)
    return token, done, logits[:, 0]


class Engine:
    """Continuous batching over `max_batch` dense cache slots, on the device
    that holds `params`."""

    def __init__(self, cfg: ModelConfig, params, tokenizer=None,
                 max_batch: int = 8, max_len: Optional[int] = None,
                 cache_dtype=torch.bfloat16, chunk: int = 32,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 stop_ids=frozenset(), seed: int = 0,
                 graphs: Optional[bool] = None):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.device = params["tok_emb"].device
        self.max_batch = max_batch
        self.max_len = max_len or cfg.seq_len
        self.cache_dtype = cache_dtype
        self.chunk = chunk
        self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
        stop = set(stop_ids)
        if tokenizer is not None:
            stop |= set(tokenizer.stop_ids)
        self.stop_ids = {int(s) for s in stop if int(s) >= 0}
        self._stop_arr = _stop_array(self.stop_ids, self.device)
        self.rope = decoder.build_rope(cfg, self.device)

        dev = self.device
        self.token = torch.zeros((max_batch,), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((max_batch,), dtype=torch.int32, device=dev)
        self.done = torch.ones((max_batch,), dtype=torch.bool, device=dev)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)
        self.state = DecodeState(self.token, self.pos, self.done,
                                 self._stop_arr, chunk)
        # a prefill's outputs, in admit order, and its inputs per graph key
        self.prefill_first = torch.zeros((max_batch,), dtype=torch.int32, device=dev)
        self.prefill_done = torch.zeros((max_batch,), dtype=torch.bool, device=dev)
        self.prefill_logits = torch.zeros((max_batch, cfg.vocab_size),
                                          dtype=torch.float32, device=dev)
        self._prefill_in: Dict[tuple, torch.Tensor] = {}
        if graphs and dev.type != "cuda":
            raise ValueError(f"graphs=True needs the params on a CUDA device, "
                             f"not {dev}")
        if graphs is None:
            graphs = self.graphs_default()
        self.graph_cache = GraphCache(dev, self.generator) if graphs else None

        self.queue: List[Request] = []
        self.active: Dict[int, Request] = {}  # slot -> request
        self._slot_budget: Dict[int, int] = {}
        self._admit_order: Dict[int, int] = {}  # slot -> admission seqno
        self._admit_seq = itertools.count()
        self.n_preemptions = 0
        # prefill accounting: wall time of the single-shot batched admit
        # prefills (with the first-token fetch), real prompt tokens and the
        # tokens the forward computes (the padded [Bpad, T] grid, or the
        # packed stream's N)
        self.prefill_wall_s = 0.0
        self.prefill_tokens = 0
        self.prefill_padded_tokens = 0
        # prefill forwards (a chunked wave counts each chunk) and decode
        # steps run, for per-step times and exact kernel launch counts
        self.n_prefill_calls = 0
        self.n_decode_steps = 0
        # requests retired DURING a preemption (cache capacity exhausted);
        # drained into _collect's finished list
        self._preempt_retired: List[Request] = []
        # host mirror of self.pos: pos, done and the chunk's tokens come back
        # in ONE fetch (_meta/_collect), and pos at admission is host-known
        self._pos_np = np.zeros((max_batch,), np.int64)
        self._init_cache()

    def graphs_default(self) -> bool:
        """graphs=None: on for params on a CUDA device with the kernels on."""
        return self.device.type == "cuda" and kernels_on()

    # ---- cache backend hooks (overridden by PagedEngine)

    def _init_cache(self):
        self.cache = decoder.init_kv_cache(
            self.cfg, batch=self.max_batch, max_len=self.max_len,
            dtype=self.cache_dtype, device=self.device)

    def _can_admit(self, req: Request) -> bool:
        return True

    def _reserve(self, slot: int, req: Request):
        pass

    def _cache_tensors(self) -> tuple:
        return self.cache["k"], self.cache["v"]

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _prefill_inputs(self, key, parts):
        """The int32 arrays `parts` packed into the fixed input buffer of
        prefill key `key` by ONE host-to-device copy: (buffer, a view of it
        shaped as each part)."""
        flat = np.concatenate([np.asarray(a, np.int32).ravel() for a in parts])
        buf = self._prefill_in.get(key)
        if buf is None:
            buf = self._prefill_in[key] = torch.zeros(flat.shape, dtype=torch.int32,
                                                      device=self.device)
        buf.copy_(torch.from_numpy(flat))
        views, o = [], 0
        for a in parts:
            n = np.size(a)
            views.append(buf[o:o + n].view(np.shape(a)))
            o += n
        return buf, views

    def _emit_first(self, logits, first=None, done=None):
        """A prefill's end, in place on the fixed outputs: the last logits,
        the greedy first tokens and their done flags (computed here unless
        given)."""
        if first is None:
            first = sample_greedy(logits)
            done = (first[:, None] == self._stop_arr[None, :]).any(dim=-1)
        self.prefill_logits.copy_(logits)
        self.prefill_first.copy_(first)
        self.prefill_done.copy_(done)

    def _run_prefill(self, key, fn, buf, sp):
        """`fn` (a prefill over `buf` into the fixed outputs) eagerly or as
        a replay of its graph (serving/graphs.py), noted on the prefill's
        span `sp`. Returns (first tokens, done flags): the fixed outputs, in
        admit order."""
        static = (buf, self.prefill_first, self.prefill_done,
                  self.prefill_logits, self._stop_arr, *self._cache_tensors(),
                  *self.rope)
        sp.set(key=key, graph=run_once(self.graph_cache, key, fn, static))
        return self.prefill_first, self.prefill_done

    def _prefill_batch(self, slots: np.ndarray, toks: np.ndarray,
                       lens: np.ndarray, sp):
        """One forward for the whole admit batch, under the prefill span
        `sp`. Returns (first tokens, done flags) as device tensors in ADMIT
        order (callers index [:Ba])."""
        # admit-ordered rows go to slot order for the in-place prefill (row s
        # of the forward writes cache slot s)
        Bm, T = self.max_batch, toks.shape[1]
        toks_slot = np.zeros((Bm, T), np.int32)
        lens_slot = np.ones((Bm,), np.int32)
        admit = np.zeros((Bm,), bool)
        back = np.zeros((len(slots),), np.int64)  # admit row -> slot row
        for i, s in enumerate(slots):
            if s == _PAD_SLOT:
                continue
            toks_slot[s], lens_slot[s], admit[s] = toks[i], lens[i], True
            back[i] = s
        key = ("admit", Bm, T, self.max_len, self.cache_dtype)
        buf, (tok, n, adm, idx) = self._prefill_inputs(
            key, (toks_slot, lens_slot, admit, back))

        def fn():
            first, done, logits = _admit_prefill(
                self.cfg, self.params, tok, n, adm.bool(), self.cache,
                self._stop_arr, rope=self.rope)
            i = idx.long()
            self._emit_first(logits[i], first[i], done[i])

        return self._run_prefill(key, fn, buf, sp)

    def _run_chunk(self, sp):
        """Launch one decode chunk over the active slots, noted on the
        chunk's span `sp`. Returns its [tokens | pos | done] on the
        device."""
        live = max((int(self._pos_np[s]) for s in self.active), default=0)
        active = min(_bucket_len(live + self.chunk + 1), self.max_len)
        sp.set(steps=self.chunk, rows=len(self.active), window=active)
        self.n_decode_steps += self.chunk
        toks = decode_chunk(
            self.cfg, self.params, self.state, self.cache, self.generator,
            steps=self.chunk, temperature=self.temperature, top_k=self.top_k,
            top_p=self.top_p, active_len=active, rope=self.rope,
            graphs=self.graph_cache)[0]
        return self._meta(toks)

    def _meta(self, toks):
        """[B, steps + 2] int32 device tensor: [tokens | pos | done], one
        host fetch per chunk instead of three."""
        return torch.cat([toks.to(torch.int32), self.pos[:, None].to(torch.int32),
                          self.done[:, None].to(torch.int32)], dim=1)

    def _retire_slot(self, slot: int):
        pass

    def _drop_slot(self, slot: int):
        """Free an active slot: its request finished or was cancelled."""
        self._retire_slot(slot)
        del self.active[slot]
        self._slot_budget.pop(slot, None)
        self.done[slot] = True

    def _slot_capacity(self, slot: int) -> int:
        return self.max_len

    # ---- public API

    def submit(self, req: Request):
        # keep an earlier stamp (the HTTP server stamps at enqueue, so TTFT
        # includes its queue wait); a first submission stamps here.
        # queued_time is always the engine's own
        req.queued_time = time.perf_counter()
        if not req.submit_time:
            req.submit_time = req.queued_time
        self.queue.append(req)

    def submit_prompt(self, text: str, **kw) -> Request:
        if self.tokenizer is None:
            raise ValueError("submit_prompt needs a tokenizer")
        req = Request(prompt_ids=self.tokenizer.encode(text), **kw)
        self.submit(req)
        return req

    def cancel(self, request_id: int) -> bool:
        """Stop a request: a queued one leaves the queue, an active one gives
        up its slot (and its pages on the PagedEngine) without finishing.
        Returns whether the request was found."""
        for i, req in enumerate(self.queue):
            if req.request_id == request_id:
                del self.queue[i]
                return True
        for slot, req in self.active.items():
            if req.request_id == request_id:
                self._drop_slot(slot)
                return True
        return False

    def can_hold(self, req: Request) -> bool:
        """Whether an idle engine could admit `req`; the dense cache holds
        any request shorter than max_len."""
        return True

    @property
    def n_active(self) -> int:
        return len(self.active)

    @property
    def has_work(self) -> bool:
        return bool(self.queue or self.active)

    def run(self, requests: Sequence[Request] = ()) -> List[Request]:
        """Drain: submit `requests`, step until everything finishes."""
        for r in requests:
            self.submit(r)
        finished = []
        while self.has_work:
            finished.extend(self.step())
        return finished

    # ---- engine internals

    def step(self) -> List[Request]:
        """Admit as many queued requests as fit, run one decode chunk,
        retire finished rows. Returns newly finished requests."""
        with span("kt.engine.step"):
            self._admit()
            if not self.active:
                return []
            return self._decode()

    def _decode(self) -> List[Request]:
        """One decode chunk over the active slots, its one fetch, and the
        rows it retires. Returns newly finished requests."""
        with span("kt.engine.chunk") as sp:
            meta = self._run_chunk(sp)
            if tracing():
                sp.ids = tuple(r.request_id for r in self.active.values())
        with span("kt.engine.sync"):
            meta = meta.cpu().numpy()
        with span("kt.engine.collect") as sp:
            finished = self._collect(meta)
            if tracing():
                sp.set(retired=[r.request_id for r in finished])
        return finished

    def _free_slots(self) -> List[int]:
        return [s for s in range(self.max_batch) if s not in self.active]

    @staticmethod
    def _effective_ids(req: Request) -> List[int]:
        """The ids a (re-)admission prefills: the prompt plus whatever was
        generated before a preemption, so a resumed request continues
        exactly where it left off."""
        return req.prompt_ids + req.out_ids

    def _pop_admits(self):
        """Move as many queued requests as fit into reserved slots; a
        request's first admission stamps its admit_time."""
        with span("kt.engine.admit") as sp:
            free = self._free_slots()
            admits, now = [], 0.0
            while self.queue and free and self._can_admit(self.queue[0]):
                req = self.queue.pop(0)
                slot = free.pop(0)
                n = len(self._effective_ids(req))
                if not 1 <= n < self.max_len:
                    raise ValueError(f"request {req.request_id}: {n} prompt "
                                     f"tokens, max_len {self.max_len}")
                self._reserve(slot, req)
                if not req.admit_time:
                    now = now or time.perf_counter()
                    req.admit_time = now
                admits.append((slot, req))
            if tracing():
                sp.ids = tuple(r.request_id for _, r in admits)
                # each first admission's wait (a preempted request resumes
                # under its first stamp)
                sp.set(waits=[r.admit_time - r.queued_time for _, r in admits
                              if r.admit_time == now],
                       left=len(self.queue),
                       why=(None if not self.queue else "no_slot" if not free
                            else "no_pages"))
        return admits

    def _admit(self):
        admits = self._pop_admits()
        if admits:
            self._admit_now(admits)

    def _admit_rows(self, admits, T):
        """Admit-ordered [max_batch, T] tokens, lengths and slots (padding
        rows carry _PAD_SLOT)."""
        Bpad = self.max_batch
        toks = np.zeros((Bpad, T), np.int32)
        lens = np.ones((Bpad,), np.int32)
        slots = np.full((Bpad,), _PAD_SLOT, np.int32)
        for i, (slot, req) in enumerate(admits):
            ids = self._effective_ids(req)
            toks[i, :len(ids)] = ids
            lens[i] = len(ids)
            slots[i] = slot
        return toks, lens, slots

    def _admit_now(self, admits):
        # one batched prefill for every admitted request; rows always pad to
        # max_batch and T to a bucket, so the INT8 routes repeat the JAX
        # engine's
        T = min(_bucket(max(len(self._effective_ids(r)) for _, r in admits)),
                self.max_len)
        toks, lens, slots = self._admit_rows(admits, T)
        self._prefill_admits(admits, slots, lens, dict(rows=self.max_batch, T=T),
                             lambda sp: self._prefill_batch(slots, toks, lens, sp))

    def _prefill_admits(self, admits, slots, lens, grid, prefill):
        """The admission's one prefill, `prefill(span)` over rows x T tokens
        (`grid`), under its `kt.engine.prefill` span, with its accounting,
        then the activation of its rows. slots, lens: admit order."""
        tokens = int(lens[:len(admits)].sum())
        computed = grid["rows"] * grid["T"]
        t0 = time.perf_counter()
        with span("kt.engine.prefill", rows_real=len(admits), tokens=tokens,
                  computed=computed, **grid) as sp:
            first, done = prefill(sp)
            self.n_prefill_calls += 1
        self._activate(admits, slots, lens, first, done)  # syncs
        self.prefill_wall_s += time.perf_counter() - t0
        self.prefill_tokens += tokens
        self.prefill_padded_tokens += computed

    def _activate(self, admits, slots, lens, first, done):
        """Post-prefill bookkeeping: install first tokens and positions,
        record TTFT, hand the slots to the decode loop."""
        Ba = len(admits)
        with span("kt.engine.sync"):
            first_np = first.cpu().numpy()  # syncs the prefill
            done_np = done.cpu().numpy()
        now = time.perf_counter()
        real = self._to_dev(slots[:Ba].astype(np.int64))
        self.token[real] = first[:Ba].to(torch.int32)
        self.pos[real] = self._to_dev(lens[:Ba])
        self.done[real] = done[:Ba]
        self._pos_np[slots[:Ba]] = lens[:Ba]  # host mirror
        for i, (slot, req) in enumerate(admits):
            if not req.first_token_time:  # TTFT survives preemptions
                req.first_token_time = now
            self.active[slot] = req
            self._admit_order[slot] = next(self._admit_seq)
            prior = len(req.out_ids)  # > 0 only when a preemption resumes
            first_id = int(first_np[i])
            if first_id in self.stop_ids or bool(done_np[i]):
                req.finish_time = now
                self._slot_budget[slot] = 0
            else:
                req.out_ids.append(first_id)
                self._slot_budget[slot] = req.max_new_tokens - prior - 1

    def _collect(self, meta: np.ndarray) -> List[Request]:
        finished = []
        if self._preempt_retired:
            finished.extend(self._preempt_retired)
            self._preempt_retired.clear()
        toks = meta[:, :-2]
        pos_np = meta[:, -2]
        done_np = meta[:, -1].astype(bool)
        self._pos_np = np.array(pos_np, np.int64)
        for slot, req in list(self.active.items()):
            if req.finished:  # finished during admission
                self._drop_slot(slot)
                finished.append(req)
                continue
            budget = self._slot_budget[slot]
            taken = 0
            hit_stop = False
            for t in toks[slot]:
                if taken >= budget:
                    break
                t = int(t)
                if t in self.stop_ids:
                    hit_stop = True
                    break
                req.out_ids.append(t)
                taken += 1
            self._slot_budget[slot] = budget - taken
            out_of_budget = self._slot_budget[slot] <= 0
            capacity = int(pos_np[slot]) >= self._slot_capacity(slot) - 1
            if hit_stop or out_of_budget or capacity or bool(done_np[slot]):
                req.finish_time = time.perf_counter()
                self._drop_slot(slot)  # the slot is free for the next admit
                finished.append(req)
        return finished


class PagedEngine(Engine):
    """Continuous batching over a paged KV cache and the paged flash-decode
    kernel.

    prefill_chunk=C (a page-size multiple, such as 256) CHUNKS long-prompt
    admissions: prompts longer than C prefill C tokens per engine step,
    between shortened (admit_chunk-step) decode chunks, so active slots keep
    generating during an admission wave. Prompts <= C take the single-shot
    path; prefill_chunk=0 always does.

    reserve_growth=True admits a request only when the pool can hold its
    whole lifetime (prompt + max_new_tokens) beside every active slot's
    remaining growth; with False only prompt pages are budgeted and a
    decode chunk that runs out of pages preempts the youngest slot.

    mesh= (parallel/mesh.py, dp = 1) runs the engine tensor-parallel: every
    rank of the mesh builds the same engine from the same full, unfused
    params, keeps its slices (fused per rank) and its
    block of kv-head lanes of the pools (parallel/sharded_paged.py), and is
    given the same requests; the scheduler runs alike on every rank. With
    seqpar=True the pools split over pages instead (parallel/seqpar.py):
    n_pages grows by one garbage page per rank (global page s * P_local is
    rank s's local page 0, reserved) and up to a multiple of sp, and the
    pages added by the rounding are reserved too, so the free pages at
    start equal the single-device engine's. Decode graphs are taken only
    where the group's collectives can be captured (NCCL); graphs=True over
    a gloo group raises."""

    def __init__(self, cfg: ModelConfig, params, tokenizer=None,
                 n_pages: Optional[int] = None, page_size: int = 128,
                 mesh=None, prefill_chunk: int = 0, admit_chunk: int = 32,
                 reserve_growth: bool = True, seqpar: bool = False, **kw):
        from ..kvcache import PageAllocator

        if seqpar and mesh is None:
            raise ValueError("PagedEngine: seqpar=True needs a mesh")
        if mesh is not None and mesh.dp != 1:
            raise ValueError(f"PagedEngine: a mesh over dp={mesh.dp} data ranks; "
                             "each data rank runs its own engine on a tp-only mesh")
        if mesh is not None and kw.get("graphs") and not mesh.graphs_capturable():
            raise ValueError(f"graphs=True: the {mesh.backend} group's collectives "
                             "cannot be captured in a CUDA graph")
        if prefill_chunk % page_size:
            raise ValueError(f"prefill_chunk {prefill_chunk} is not a multiple "
                             f"of the page size {page_size}")
        self.page_size = page_size
        self.reserve_growth = reserve_growth
        self._reserved_caps: Dict[int, int] = {}
        self.prefill_chunk = prefill_chunk
        self.admit_chunk = admit_chunk
        self._wave: Optional[dict] = None
        max_batch = kw.get("max_batch", 8)
        max_len = kw.get("max_len") or cfg.seq_len
        if n_pages is None:
            n_pages = max_batch * (-(-max_len // page_size)) + 1
        self.mesh, self.seqpar, self._sharded = mesh, seqpar, None
        reserved = ()
        if mesh is not None:
            params = self._shard(cfg, params, mesh, seqpar)
            if seqpar:
                # the single-device pool's free pages, plus one garbage page
                # per rank, rounded up to a multiple of sp; the pages the
                # rounding adds stay out of the free list as well
                sp = mesh.tp
                demand = n_pages - 1
                n_pages = -(-(demand + sp) // sp) * sp
                p_local = n_pages // sp
                sinks = {s * p_local for s in range(sp)}
                extra = n_pages - sp - demand
                spare = [p for p in range(n_pages - 1, 0, -1) if p not in sinks][:extra]
                reserved = tuple(sorted(sinks | set(spare)))
        self._n_pages = n_pages
        self._packed = None  # the decode chunk's metadata (pack_chunk_meta)
        super().__init__(cfg, params, tokenizer, **kw)
        self.allocator = PageAllocator(
            n_pages=n_pages, page_size=page_size, max_seqs=self.max_batch,
            max_len=self.max_len, reserved=reserved)
        self._pool_pages = self.allocator.n_free_pages
        # requests cancelled while their admission wave prefills; they give
        # up their slots when the wave activates
        self._cancel_after_wave: set = set()

    def _shard(self, cfg, params, mesh, seqpar):
        """This rank's params, fused per rank, and its step
        (ShardedPagedStep or SeqParPagedStep)."""
        from ..fuse import fuse_params
        from ..parallel.shardings import shard_params

        params = fuse_params(shard_params(params, mesh, cfg, seqpar=seqpar))
        if seqpar:
            from ..parallel.seqpar import SeqParPagedStep

            self._sharded = SeqParPagedStep(cfg, mesh, params)
        else:
            from ..parallel.sharded_paged import ShardedPagedStep

            self._sharded = ShardedPagedStep(cfg, mesh, params)
        return params

    def graphs_default(self) -> bool:
        return super().graphs_default() and (
            self.mesh is None or self.mesh.graphs_capturable())

    # ---- chunked admission (prefill/decode overlap)

    @property
    def has_work(self) -> bool:
        return bool(self.queue or self.active or self._wave)

    def step(self) -> List[Request]:
        with span("kt.engine.step"):
            if self.prefill_chunk:
                if self._wave is None:
                    self._start_wave()
                if self._wave is not None:
                    self._advance_wave()
            else:
                self._admit()
            if not self.active:
                if self._wave is None and self.queue and not self._can_admit(
                        self.queue[0]):
                    # nothing running, nothing mid-prefill, the whole pool
                    # free: a head request that still does not fit never will
                    req = self.queue[0]
                    raise RuntimeError(
                        f"request {req.request_id} needs more KV pages than "
                        f"the pool has ({len(self._effective_ids(req))} prompt "
                        f"+ {req.max_new_tokens} new tokens vs "
                        f"{self.allocator.n_free_pages} free pages of "
                        f"{self.page_size} tokens)")
                return []
            return self._decode()

    def _start_wave(self):
        admits = self._pop_admits()
        if not admits:
            return
        C = self.prefill_chunk
        maxlen = max(len(self._effective_ids(r)) for _, r in admits)
        if maxlen <= C:
            # short prompts: the single-shot batched prefill is one step anyway
            self._admit_now(admits)
            return
        T = -(-maxlen // C) * C
        toks, lens, slots = self._admit_rows(admits, T)
        self._wave = dict(admits=admits, toks=toks, lens=lens, slots=slots,
                          T=T, progress=0)

    def _cache_tensors(self) -> tuple:
        return self.k_pages, self.v_pages

    def _mesh_key(self):
        return None if self._sharded is None else self._sharded.key

    def _advance_wave(self):
        from ..models.paged import prefill_chunk_paged

        w = self._wave
        C, ps, Bpad = self.prefill_chunk, self.page_size, self.max_batch
        start = w["progress"]
        pps = C // ps
        chunk_pos = start + np.arange(pps) * ps
        cp = np.full((Bpad, pps), 2 ** 30, np.int32)
        # history pages bucketed to a power of two, as the JAX engine does
        # (there to bound compiles); pad entries read page 0 and are masked
        n_need = start // ps
        n_hist = 1
        while n_hist < n_need:
            n_hist *= 2
        n_hist = n_hist if n_need else 0
        hp = np.zeros((Bpad, n_hist), np.int32)
        pt = self.allocator.page_table
        for i, slot in enumerate(w["slots"]):
            if slot == _PAD_SLOT:
                continue
            valid = chunk_pos < w["lens"][i]
            cp[i, valid] = pt[slot, (chunk_pos // ps)[valid]]
            hp[i, :n_need] = pt[slot, :n_need]
        # the chunk's start is an input, as JAX traces it: one graph serves
        # every chunk of an n_hist bucket
        key = ("prefill_chunk", Bpad, C, n_hist, self._mesh_key())
        buf, (tok, cs, n, cpd, hpd) = self._prefill_inputs(
            key, (w["toks"][:, start:start + C], start, w["lens"], cp, hp))
        chunk = prefill_chunk_paged if self._sharded is None else self._sharded.prefill_chunk
        rows_real = len(w["admits"])

        def fn():
            logits, ends, _, _ = chunk(self.cfg, self.params, tok, cs, n,
                                       self.k_pages, self.v_pages, cpd, hpd,
                                       rope=self.rope)
            # each row's logits are taken in the chunk that holds its last
            # prompt token; its first token and done flag are final after
            # the wave's last chunk
            self._emit_first(torch.where(ends[:, None], logits,
                                         self.prefill_logits))

        # a chunk's real tokens: each row's prompt tokens inside it
        tokens = int(np.clip(w["lens"][:rows_real] - start, 0, C).sum())
        with span("kt.engine.prefill", rows_real=rows_real, rows=Bpad, T=C,
                  tokens=tokens, computed=Bpad * C, start=start) as sp:
            first, done = self._run_prefill(key, fn, buf, sp)
        self.n_prefill_calls += 1
        w["progress"] = start + C
        if w["progress"] >= w["T"]:
            self._wave = None
            self._activate(w["admits"], w["slots"], w["lens"], first, done)
            for request_id in self._cancel_after_wave:
                self.cancel(request_id)
            self._cancel_after_wave.clear()

    def _init_cache(self):
        from ..kvcache import init_paged_cache

        if self._sharded is not None:
            self.k_pages, self.v_pages = self._sharded.init_pages(
                self._n_pages, self.page_size, self.cache_dtype, self.device)
            return
        cache = init_paged_cache(self.cfg, n_pages=self._n_pages,
                                 page_size=self.page_size,
                                 dtype=self.cache_dtype, device=self.device)
        self.k_pages, self.v_pages = cache.k_pages, cache.v_pages

    def _future_growth_pages(self) -> int:
        """Pages the occupied slots will still claim to reach their token
        budgets: active slots, and slots reserved for an admission that is
        not active yet (mid-wave, or earlier in the same batch)."""
        alloc = self.allocator
        need = 0
        for s in set(self.active) | set(self._reserved_caps):
            if s in self.active:
                cap = min(int(alloc.seq_lens[s]) + self._slot_budget.get(s, 0)
                          + 1, self.max_len)
            else:
                cap = self._reserved_caps[s]
            need += max(0, alloc.pages_needed(cap) - len(alloc.owned.get(s, ())))
        return need

    def _pages_for(self, req: Request) -> int:
        """Pages admission budgets for `req`: its whole lifetime
        (reserve_growth) or its prompt (over-commit)."""
        eff = len(self._effective_ids(req))
        if not self.reserve_growth:
            return self.allocator.pages_needed(eff)
        remaining = max(req.max_new_tokens - len(req.out_ids), 0)
        return self.allocator.pages_needed(min(eff + remaining + 1, self.max_len))

    def _can_admit(self, req: Request) -> bool:
        """Admit only if the pool holds this request's whole lifetime on top
        of every active slot's remaining growth (reserve_growth), or at
        least its prompt (over-commit; preemption is the backstop)."""
        free = self.allocator.n_free_pages
        if self.reserve_growth:
            free -= self._future_growth_pages()
        return free >= self._pages_for(req)

    def can_hold(self, req: Request) -> bool:
        """Whether the whole pool, empty, admits `req`: one that fails this
        could never be served."""
        return self._pages_for(req) <= self._pool_pages

    def cancel(self, request_id: int) -> bool:
        if self._wave is not None and any(
                r.request_id == request_id for _, r in self._wave["admits"]):
            self._cancel_after_wave.add(request_id)
            return True
        return super().cancel(request_id)

    def _reserve(self, slot: int, req: Request):
        eff = len(self._effective_ids(req))
        if not self.allocator.alloc_seq(slot, eff):
            raise RuntimeError("page allocator out of pages on admission "
                               "(_can_admit said it fits)")
        if self.reserve_growth:
            remaining = max(req.max_new_tokens - len(req.out_ids), 0)
            self._reserved_caps[slot] = min(eff + remaining + 1, self.max_len)

    def _admit_now(self, admits):
        """On one device, the admitted prompts prefill as ONE packed stream
        of their N tokens, padded only to N's bucket (`_prefill_packed`);
        with a mesh, as the [max_batch, bucket] grid of Engine._admit_now."""
        if self._sharded is not None:
            return super()._admit_now(admits)
        ids = [self._effective_ids(r) for _, r in admits]
        lens = np.asarray([len(i) for i in ids], np.int32)
        slots = np.asarray([s for s, _ in admits], np.int32)
        # never more tokens than the [max_batch, max_len] grid it replaces
        n = min(_bucket(int(lens.sum())), self.max_batch * self.max_len)
        self._prefill_admits(admits, slots, lens, dict(rows=1, T=n, packed=True),
                             lambda sp: self._prefill_packed(slots, ids, n, sp))

    def _prefill_packed(self, slots: np.ndarray, ids, n: int, sp):
        """One forward over the admitted prompts `ids` (admit order, into
        `slots`) packed into a stream of `n` tokens, under the prefill span
        `sp`. The graph key holds n and max_batch, never the rows admitted.
        Returns (first tokens, done flags) in admit order."""
        from ..models.paged import pack_prompts, prefill_packed_paged

        parts = pack_prompts(ids, self.allocator.page_table[slots], n,
                             self.max_batch, self.page_size)
        key = ("prefill_packed", n, self.max_batch)
        buf, (tok, pos, seg, tp, last) = self._prefill_inputs(key, parts)

        def fn():
            logits, _, _ = prefill_packed_paged(
                self.cfg, self.params, tok, pos, seg, tp, last, self.k_pages,
                self.v_pages, self.max_len, rope=self.rope)
            self._emit_first(logits)

        return self._run_prefill(key, fn, buf, sp)

    def _prefill_batch(self, slots: np.ndarray, toks: np.ndarray,
                       lens: np.ndarray, sp):
        from ..models.paged import prefill_paged

        Ba, T = toks.shape
        ps = self.page_size
        # 2**30 sentinel for padding rows and positions: their writes go to
        # the garbage page 0
        arange_t = np.arange(T)
        token_pages = np.full((Ba, T), 2 ** 30, np.int32)
        for i in range(Ba):
            if slots[i] == _PAD_SLOT:
                continue
            n = int(lens[i])
            token_pages[i, :n] = self.allocator.page_table[slots[i], arange_t[:n] // ps]
        key = ("prefill_paged", Ba, T, self._mesh_key())
        buf, (tok, n, tp) = self._prefill_inputs(key, (toks, lens, token_pages))
        prefill = prefill_paged if self._sharded is None else self._sharded.prefill

        def fn():
            last, _, _ = prefill(self.cfg, self.params, tok, n, self.k_pages,
                                 self.v_pages, tp, rope=self.rope)
            self._emit_first(last)

        return self._run_prefill(key, fn, buf, sp)

    def _page_use(self) -> dict:
        """The pool's pages by use, at a decode chunk's launch: holding the
        tokens cached so far (active slots, and a wave's written part),
        allocated (those, and pages extended for the chunk), still to be
        claimed by the occupied slots' growth, and the pool."""
        alloc, ps = self.allocator, self.page_size
        held = sum(-(-int(self._pos_np[s]) // ps) for s in self.active)
        if self._wave is not None:
            w = self._wave
            n = np.minimum(w["lens"][:len(w["admits"])], w["progress"])
            held += int((-(-n // ps)).sum())
        return dict(pages_held=held,
                    pages_allocated=self._pool_pages - alloc.n_free_pages,
                    pages_growth=self._future_growth_pages(),
                    pool=self._pool_pages)

    def _run_chunk(self, sp):
        from ..models.paged import pack_chunk_meta, run_chunk_paged, unpack_chunk_meta
        from ..ops.kernels.paged_attention import build_work_list

        # shrink the decode chunk while an admission could begin soon (a wave
        # mid-prefill, or queued work with a free slot or one about to free),
        # so queued requests wait at most admit_chunk steps
        steps = self.chunk
        if self.prefill_chunk and (
            self._wave is not None
            or (self.queue and (
                self._free_slots()
                or (self.active
                    and min(self._slot_budget[s] for s in self.active)
                    <= self.chunk)))):
            steps = min(self.chunk, self.admit_chunk)
        # pre-extend every active row's pages to cover the chunk; under pool
        # pressure PREEMPT the youngest slot (free its pages, re-queue the
        # request for a resume-prefill): the oldest keep decoding
        pos_np = self._pos_np
        for slot in sorted(self.active, key=self._admit_order.__getitem__):
            if slot not in self.active:  # preempted by an earlier iteration
                continue
            target = min(int(pos_np[slot]) + steps + 1, self.max_len)
            while not self.allocator.extend_seq(slot, target):
                victim = max((s for s in self.active if s != slot),
                             key=self._admit_order.__getitem__, default=None)
                if victim is None or (self._admit_order[victim]
                                      < self._admit_order[slot]):
                    victim = slot  # this slot is the youngest: evict it
                self._preempt(victim)
                if victim == slot:
                    break
        sp.set(steps=steps if self.active else 0, rows=len(self.active))
        if tracing():
            sp.set(**self._page_use())
        if not self.active:
            return self._meta(torch.zeros((self.max_batch, 0), dtype=torch.int32,
                                          device=self.device))
        # inactive slots (mid-wave admissions) leave the work list and write
        # the garbage page, so they cannot touch the wave's fresh pages
        pt = self.allocator.page_table
        sl = self.allocator.seq_lens
        if len(self.active) < self.max_batch:
            mask = np.zeros((self.max_batch,), bool)
            mask[list(self.active)] = True
            pt = np.where(mask[:, None], pt, 0)
            sl = np.where(mask, sl, 0)
        covered = None
        if self.seqpar:
            # this rank's work list over its own pages (LOCAL ids), and the
            # rows it touches
            r = self.mesh.tp_rank
            fb, fp, ft, n_items, cov = self._sharded.build_lists(
                pt, sl, self.page_size, self._n_pages)
            fb, fp, ft, n_items, covered = fb[r], fp[r], ft[r], n_items[r], cov[r]
        else:
            fb, fp, ft, n_items = build_work_list(pt, sl, self.page_size)
        # one host-to-device copy into the fixed buffer the step graph reads
        # (the work list is padded to max_batch * max_pages entries, so its
        # length never changes)
        packed = torch.from_numpy(pack_chunk_meta(pt, fb, fp, ft, n_items, covered))
        if self._packed is None or self._packed.shape != packed.shape:
            self._packed = packed.to(self.device)
            if self.graph_cache is not None:
                self.graph_cache.drop()
        else:
            self._packed.copy_(packed)
        self.n_decode_steps += steps
        run = run_chunk_paged if self._sharded is None else self._sharded.run_chunk
        toks = run(
            self.cfg, self.params, self.state, self.k_pages, self.v_pages,
            self.generator,
            unpack_chunk_meta(self._packed, (pt.shape[0], pt.shape[1], len(fb)),
                              covered is not None),
            steps, page_size=self.page_size, temperature=self.temperature,
            top_k=self.top_k, top_p=self.top_p, rope=self.rope,
            graphs=self.graph_cache)
        return self._meta(toks)

    def _preempt(self, slot: int):
        """Evict a slot under pool pressure: free its pages, freeze its row
        (its stale writes land on the garbage page through the zeroed page
        table row), and re-queue the request at the FRONT so it resumes,
        by a prefill of prompt + generated-so-far, once pages free up."""
        req = self.active.pop(slot)
        self.allocator.free_seq(slot)
        self.done[slot] = True
        self._slot_budget.pop(slot, None)
        self._reserved_caps.pop(slot, None)
        req.preempted += 1
        self.n_preemptions += 1
        if len(self._effective_ids(req)) >= self.max_len:
            # the sequence already fills its cache: it cannot generate
            # further, and a re-queue could never be admitted again
            req.finish_time = time.perf_counter()
            self._preempt_retired.append(req)
        else:
            self.queue.insert(0, req)

    def _retire_slot(self, slot: int):
        self.allocator.free_seq(slot)
        self._reserved_caps.pop(slot, None)
