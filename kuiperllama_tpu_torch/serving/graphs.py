"""CUDA graphs of the decode step and of the prefills: the port's
counterpart of the JAX package's jitted decode chunk
(kuiperllama_tpu/serving/generate.py `decode_chunk`,
kuiperllama_tpu/models/paged.py `decode_chunk_paged`) and of its jitted
prefill programs (models/decoder.py `forward`, serving/engine.py
`_admit_prefill`, models/paged.py `prefill_paged` and
`prefill_chunk_paged`).

The JAX package compiles a chunk once per static key and dispatches it
whole. Here the unit is one decode step, captured once per key and replayed
`steps` times: the key does not depend on `steps` (a Generator run's last
chunk and the PagedEngine's admit chunks are shorter), capturing stays
short (a Llama-2-7B layered step is about 2,200 nodes), and one replay per
step leaves the host out of the step. A prefill is a step that runs once
per replay (`run_once`): its inputs sit in a fixed buffer the caller fills
with one host-to-device copy, and it writes its outputs (the last logits,
the first token, the done flag) into tensors the caller owns.

`GraphCache.step(key, fn, static)`:
  * a key seen for the first time runs `fn` eagerly, as a real step, on the
    capture stream: that builds the kernels, sizes the workspaces and emits
    the step's token. Then it captures `fn`; every later step of the key
    replays the graph;
  * a capture executes nothing, so it adds nothing to the kernels' launch
    counters: each graph records its launches per counted wrapper at
    capture, and every replay adds them, so the counters say how many
    kernels ran on every route. The collectives' calls and bytes
    (parallel/collectives.py) are counted the same way;
  * a graph keeps the pointers of `static` (the tensors the step reads and
    writes in place) and of the kernels' workspaces
    (ops/kernels/workspace.py). A replay refuses static tensors that moved,
    and a graph captured before the workspace epoch moved is captured again
    at its key's next step, the eager call first (`n_recaptures`); the
    cache's other graphs stay. (A decode step's first call can grow a
    megakernel's scratch after the prefill before it was captured: only
    that prefill's graph is captured again, at the next prefill);
  * a failed capture or replay raises; nothing retries eagerly.
A cache's graphs share one memory pool, so no graph may leave an output in
it: a block freed when its Python reference goes is taken by a later
capture while the first graph still writes there on every replay. Every
step writes its results into tensors allocated outside the capture (the
decode state, the caller's prefill outputs). Sampling draws come from the
cache's torch.Generator, registered with each graph whose step samples, so
a seeded run replays the eager route's draws. Decode and prefill graphs are
counted apart (`Counts`).

While a torch profiler records, each capture, its eager first call
included, is a `kt.graph.capture` span (utils/profiling.py) with the key,
whether it is a prefill's and whether the key was captured before.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from ..ops.kernels import fused_decode as fd
from ..ops.kernels import fused_decode_big as fb
from ..ops.kernels import paged_attention as pa
from ..ops.kernels import quant_matmul as qm
from ..ops.kernels import workspace
from ..parallel import collectives
from ..utils.profiling import span


def counted_kernels():
    """The kernel wrappers whose `.launches` count launches on the decode
    paths."""
    return (qm.quant_gemv, qm.quant_gemm, fd.fused_decode_step,
            fd.fused_decode_chunk, fb.fused_decode_step_big,
            pa.paged_attention_flat)


def _counters():
    """(object, attribute) of every count a replay adds to: the kernels'
    launches, the GEMM's wgmma-route launches and x roundings, the
    collectives' calls and bytes."""
    return ([(w, "launches") for w in counted_kernels()]
            + [(qm.quant_gemm, "wgmma_launches"), (qm.quant_gemm, "x_roundings")]
            + [(c, a) for c in collectives.counted() for a in ("launches", "bytes")])


class CudaStepGraph:
    """One captured step: a torch.cuda.CUDAGraph captured on the cache's
    side stream into its pool."""

    def __init__(self, pool, stream, generator=None):
        self.graph = torch.cuda.CUDAGraph()
        self.pool, self.stream = pool, stream
        if generator is not None:
            if not hasattr(self.graph, "register_generator_state"):
                raise RuntimeError(
                    "sampling inside a decode graph needs "
                    "CUDAGraph.register_generator_state, which this PyTorch "
                    "lacks; pass graphs=False")
            self.graph.register_generator_state(generator)

    @staticmethod
    def new_pool(device):
        return torch.cuda.graph_pool_handle()

    @staticmethod
    def new_stream(device):
        return torch.cuda.Stream(device)

    @staticmethod
    def run_eager(stream, fn):
        """fn() on the side stream, ordered after and before the current
        stream's work (PyTorch's CUDA-graph notes warm up this way)."""
        current = torch.cuda.current_stream(stream.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            fn()
        current.wait_stream(stream)

    @staticmethod
    def pool_bytes(pool) -> int:
        """Bytes of the device segments that belong to `pool`."""
        pool = tuple(pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)

    def capture(self, fn, static):
        with torch.cuda.graph(self.graph, pool=self.pool, stream=self.stream):
            fn()

    def replay(self):
        self.graph.replay()


# the graph class a GraphCache captures with (tests put a CPU stand-in here)
STEP_GRAPH = CudaStepGraph


@dataclass
class _Entry:
    graph: object
    ptrs: tuple     # data pointers of the static tensors at capture
    launches: tuple  # per _counters() entry, added by each replay
    epoch: int      # workspace.epoch at capture
    prefill: bool


@dataclass
class Counts:
    """One kind of graph's counters: `captures` (every capture),
    `recaptures` (the captures of a key captured before, after the
    workspace epoch moved or the cache dropped it), `replays`, and
    `capture_s` (seconds in captures, the eager first calls not
    included)."""

    captures: int = 0
    recaptures: int = 0
    replays: int = 0
    capture_s: float = 0.0


class GraphCache:
    """Step and prefill graphs of one Generator or engine on `device`, keyed
    as the JAX package keys its jitted programs. `decode` and `prefill` are
    their `Counts`; `n_captures`, `n_recaptures`, `n_replays` and
    `capture_s` read the decode ones."""

    def __init__(self, device, generator=None):
        self.device = device
        self.generator = generator
        self._graphs: dict = {}
        self._seen: set = set()
        self._pool = self._stream = None
        self.decode, self.prefill = Counts(), Counts()

    n_captures = property(lambda self: self.decode.captures)
    n_recaptures = property(lambda self: self.decode.recaptures)
    n_replays = property(lambda self: self.decode.replays)
    capture_s = property(lambda self: self.decode.capture_s)

    def drop(self):
        """Forget every decode graph (its static tensors were rebound); the
        next step of each such key captures anew. The prefill graphs stay."""
        self._graphs = {k: e for k, e in self._graphs.items() if e.prefill}

    def pool_bytes(self) -> int:
        return 0 if self._pool is None else STEP_GRAPH.pool_bytes(self._pool)

    def step(self, key, fn, static, rng: bool = False, prefill: bool = False) -> str:
        """One step under `key`: a replay of its graph, or, for a new key or
        one captured before the workspace epoch moved, `fn()` run eagerly
        and then captured. static: the tensors `fn` reads and writes in
        place; rng: whether `fn` draws from the cache's generator; prefill:
        count it as a prefill. Returns "replay" or "capture"."""
        entry = self._graphs.get(key)
        if entry is None or entry.epoch != workspace.epoch:
            with span("kt.graph.capture", key=key, prefill=prefill,
                      recapture=key in self._seen):
                self._capture(key, fn, static, rng, prefill)
            return "capture"
        if tuple(t.data_ptr() for t in static) != entry.ptrs:
            raise RuntimeError(f"graph {key}: a static tensor moved since its "
                               "capture")
        try:
            entry.graph.replay()
        except BaseException:
            workspace.invalidate()
            raise
        for (obj, attr), n in zip(_counters(), entry.launches):
            setattr(obj, attr, getattr(obj, attr) + n)
        (self.prefill if prefill else self.decode).replays += 1
        return "replay"

    def _capture(self, key, fn, static, rng, prefill):
        if self._stream is None:
            self._stream = STEP_GRAPH.new_stream(self.device)
        if self._pool is None:
            self._pool = STEP_GRAPH.new_pool(self.device)
        STEP_GRAPH.run_eager(self._stream, fn)  # the key's first step
        counters = _counters()
        before = [getattr(o, a) for o, a in counters]
        epoch = workspace.epoch
        t0 = time.perf_counter()
        try:
            graph = STEP_GRAPH(self._pool, self._stream,
                               self.generator if rng else None)
            graph.capture(fn, static)
        except BaseException:
            workspace.invalidate()
            raise
        finally:
            launches = tuple(getattr(o, a) - b for (o, a), b in zip(counters, before))
            for (o, a), b in zip(counters, before):
                setattr(o, a, b)
        counts = self.prefill if prefill else self.decode
        counts.capture_s += time.perf_counter() - t0
        if workspace.epoch != epoch:
            raise RuntimeError(f"graph {key}: a workspace grew during its "
                               "capture, after the eager call had sized it")
        self._graphs[key] = _Entry(graph, tuple(t.data_ptr() for t in static),
                                   launches, epoch, prefill)
        counts.captures += 1
        if key in self._seen:
            counts.recaptures += 1
        self._seen.add(key)

    def captured(self, prefill: bool = False) -> list:
        """Per decode (or prefill) graph: what one replay adds to each
        count, by name (a kernel's launches; a collective's `.launches` and
        `.bytes`)."""
        names = [o.__name__ if a == "launches" and o not in collectives.counted()
                 else f"{o.__name__}.{a}" for o, a in _counters()]
        return [dict(zip(names, e.launches)) for e in self._graphs.values()
                if e.prefill == prefill]

    def stats(self) -> dict:
        """The decode counters under their names, and the prefill ones
        beside them (`n_prefill_captures`, ...); `graphs` and
        `prefill_graphs` count the graphs held."""
        held = [e.prefill for e in self._graphs.values()]
        d, p = self.decode, self.prefill
        return dict(n_captures=d.captures, n_recaptures=d.recaptures,
                    capture_s=d.capture_s, n_replays=d.replays,
                    graphs=held.count(False),
                    n_prefill_captures=p.captures,
                    n_prefill_recaptures=p.recaptures,
                    prefill_capture_s=p.capture_s,
                    n_prefill_replays=p.replays, prefill_graphs=held.count(True))


def run_once(graphs, key, fn, static, rng: bool = False) -> str:
    """A prefill: `fn()`, which reads its inputs from fixed buffers and
    writes its outputs into tensors the caller owns, run eagerly (graphs
    None) or through `graphs` under `key` with `static` held fixed.
    Returns "eager", "replay" or "capture"."""
    if graphs is None:
        fn()
        return "eager"
    return graphs.step(key, fn, static, rng, prefill=True)


def run_steps(state, step, steps: int, graphs=None, key=None, static=(),
              rng: bool = False):
    """`steps` decode steps of `step`, which reads and writes `state` (a
    ops.sampling.DecodeState) in place: eagerly, or through `graphs` under
    `key` with `static` (and the state's tensors) held fixed. Returns the
    steps' tokens [B, steps], a view of state.toks."""
    if state.toks.shape[1] < steps:
        state.widen(steps)
        if graphs is not None:
            graphs.drop()
    state.col.zero_()
    if graphs is None:
        for _ in range(steps):
            step()
    else:
        static = (*state.tensors(), *static)
        for _ in range(steps):
            graphs.step(key, step, static, rng)
    return state.toks[:, :steps]
