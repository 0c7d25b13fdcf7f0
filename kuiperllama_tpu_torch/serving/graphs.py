"""CUDA graphs of the decode step: the port's counterpart of the JAX
package's jitted decode chunk (kuiperllama_tpu/serving/generate.py
`decode_chunk`, kuiperllama_tpu/models/paged.py `decode_chunk_paged`).

The JAX package compiles a chunk once per static key and dispatches it
whole. Here the unit is one decode step, captured once per key and replayed
`steps` times: the key does not depend on `steps` (a Generator run's last
chunk and the PagedEngine's admit chunks are shorter), capturing stays
short (a Llama-2-7B layered step is about 2,200 nodes), and one replay per
step leaves the host out of the step.

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
    and once the workspace epoch has moved the cache drops its graphs and
    captures each again at its next step (`n_recaptures`);
  * a failed capture or replay raises; nothing retries eagerly.
A cache's graphs share one memory pool. Sampling draws come from the
cache's torch.Generator, registered with each graph whose step samples, so
a seeded run replays the eager route's draws.
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


def counted_kernels():
    """The kernel wrappers whose `.launches` count launches on the decode
    paths."""
    return (qm.quant_gemv, qm.quant_gemm, fd.fused_decode_step,
            fd.fused_decode_chunk, fb.fused_decode_step_big,
            pa.paged_attention_flat)


def _counters():
    """(object, attribute) of every count a replay adds to: the kernels'
    launches, the collectives' calls and bytes."""
    return ([(w, "launches") for w in counted_kernels()]
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


class GraphCache:
    """Step graphs of one Generator or engine on `device`, keyed as the JAX
    package keys its jitted chunk. Counters: `n_captures` (every capture),
    `n_recaptures` (the captures of a key captured before, after the
    workspace epoch moved), `capture_s` (seconds in captures, the eager
    first steps not included) and `n_replays`."""

    def __init__(self, device, generator=None):
        self.device = device
        self.generator = generator
        self._graphs: dict = {}
        self._seen: set = set()
        self._pool = self._stream = None
        self.n_captures = self.n_recaptures = self.n_replays = 0
        self.capture_s = 0.0

    def drop(self):
        """Forget every graph; the next step of each key captures anew."""
        self._graphs.clear()
        self._pool = None

    def pool_bytes(self) -> int:
        return 0 if self._pool is None else STEP_GRAPH.pool_bytes(self._pool)

    def step(self, key, fn, static, rng: bool = False):
        """One decode step under `key`: a replay of its graph, or, for a new
        key, `fn()` run eagerly and then captured. static: the tensors `fn`
        reads and writes in place; rng: whether `fn` draws from the
        cache's generator."""
        entry = self._graphs.get(key)
        if entry is not None and entry.epoch != workspace.epoch:
            self.drop()
            entry = None
        if entry is None:
            self._capture(key, fn, static, rng)
            return
        if tuple(t.data_ptr() for t in static) != entry.ptrs:
            raise RuntimeError(f"decode graph {key}: a static tensor moved "
                               "since its capture")
        try:
            entry.graph.replay()
        except BaseException:
            workspace.invalidate()
            raise
        for (obj, attr), n in zip(_counters(), entry.launches):
            setattr(obj, attr, getattr(obj, attr) + n)
        self.n_replays += 1

    def _capture(self, key, fn, static, rng):
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
        self.capture_s += time.perf_counter() - t0
        if workspace.epoch != epoch:
            raise RuntimeError(f"decode graph {key}: a workspace grew during "
                               "its capture, after the eager step had sized it")
        self._graphs[key] = _Entry(graph, tuple(t.data_ptr() for t in static),
                                   launches, epoch)
        self.n_captures += 1
        if key in self._seen:
            self.n_recaptures += 1
        self._seen.add(key)

    def captured(self) -> list:
        """Per graph: what one replay adds to each count, by name (a
        kernel's launches; a collective's `.launches` and `.bytes`)."""
        names = [f"{o.__name__}.{a}" if o in collectives.counted() else o.__name__
                 for o, a in _counters()]
        return [dict(zip(names, e.launches)) for e in self._graphs.values()]

    def stats(self) -> dict:
        return dict(n_captures=self.n_captures, n_recaptures=self.n_recaptures,
                    capture_s=self.capture_s, n_replays=self.n_replays,
                    graphs=len(self._graphs))


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
