"""The decode step as an in-place function and its CUDA-graph route
(serving/graphs.py), on the CPU.

  * The dense step function (`generate.decode_chunk` on a DecodeState), run
    for a whole chunk, gives the JAX `decode_chunk`'s greedy tokens on the
    three committed tinychar fixtures (fp32, fast mode, the JAX side's
    Pallas kernels in interpret mode); the paged one (`run_chunk_paged`)
    gives JAX `decode_chunk_paged`'s at a small tiny_config.
  * With a sampling seed the step function gives the tokens of the eager
    loop it replaced (a copy of it below, with torch.multinomial).
  * The graph cache's logic runs against `CpuGraph`, a stand-in for
    `graphs.CudaStepGraph`: its capture runs the step to count the
    launches the card's capture would record and then restores the static
    tensors (a capture executes nothing); its replay runs the step and
    restores the launch counts (a replay runs no Python). The INT8
    kernels' wrappers count their CPU calls here as they count launches
    on the card.
The card's own graphs are held to the eager route in
tests/test_torch_kernels_cuda.py.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kuiperllama_tpu.checkpoint.binfmt import load_bin as jload
from kuiperllama_tpu.fuse import fuse_params as jfuse
from kuiperllama_tpu.models import decoder as jdec
from kuiperllama_tpu.models import paged as jpaged
from kuiperllama_tpu.ops.pallas.paged_attention import build_work_list
from kuiperllama_tpu.params import to_device as jto
from kuiperllama_tpu.serving import generate as jgen
from kuiperllama_tpu_torch.checkpoint.binfmt import load_bin
from kuiperllama_tpu_torch.fuse import fuse_params
from kuiperllama_tpu_torch.models import decoder, paged
from kuiperllama_tpu_torch.ops import linear as linear_mod
from kuiperllama_tpu_torch.ops.kernels import quant_matmul as qm
from kuiperllama_tpu_torch.ops.kernels import workspace
from kuiperllama_tpu_torch.ops.sampling import DecodeState, filter_logits
from kuiperllama_tpu_torch.params import to_device
from kuiperllama_tpu_torch.serving import engine as teng
from kuiperllama_tpu_torch.serving import generate as tgen
from kuiperllama_tpu_torch.serving import graphs
from kuiperllama_tpu_torch.serving.generate import Generator, _stop_array

from test_torch_paged import MAX_LEN, PS, model, prefilled  # noqa: F401
from torch_threads import one_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
PROMPT = [1, 20, 33, 45, 60, 7, 90]
FIXTURES = [("tinychar/tinychar.q8.bin", "llama2"),
            ("tinychar_g256/tinychar.q8.bin", "llama2"),
            ("tinychar_qwen2/tinychar.q8.bin", "qwen2")]
CACHE = 128


class CpuGraph:
    """Stand-in for graphs.CudaStepGraph on the CPU."""

    def __init__(self, pool, stream, generator=None):
        self.generator = generator

    @staticmethod
    def new_pool(device):
        return object()

    @staticmethod
    def new_stream(device):
        return None

    @staticmethod
    def run_eager(stream, fn):
        fn()

    @staticmethod
    def pool_bytes(pool):
        return 0

    def capture(self, fn, static):
        saved = [t.clone() for t in static]
        rng = self.generator.get_state() if self.generator is not None else None
        fn()  # counts the launches; the card's capture runs the Python too
        for t, s in zip(static, saved):
            t.copy_(s)
        if rng is not None:
            self.generator.set_state(rng)
        self.fn = fn

    def replay(self):
        """The step's work without its Python: the wrappers' counts stay
        where they were (the cache adds the captured launches)."""
        counts = [w.launches for w in graphs.counted_kernels()]
        self.fn()
        for w, n in zip(graphs.counted_kernels(), counts):
            w.launches = n


@pytest.fixture
def counting(monkeypatch):
    """The INT8 wrappers count their calls on the CPU as on the card, and
    the graph cache captures with CpuGraph. Yields a function that reads
    (GEMV, GEMM) counts."""
    for name in ("quant_gemv", "quant_gemm"):
        real = getattr(linear_mod, name)

        def wrapped(*a, _real=real, **k):
            _real.launches += 1
            return _real(*a, **k)

        monkeypatch.setattr(linear_mod, name, wrapped)
    monkeypatch.setattr(graphs, "STEP_GRAPH", CpuGraph)
    monkeypatch.setattr(qm.quant_gemv, "launches", 0)
    monkeypatch.setattr(qm.quant_gemm, "launches", 0)
    yield lambda: (qm.quant_gemv.launches, qm.quant_gemm.launches)


def _port_model(rel, family):
    tc, tp = load_bin(os.path.join(ROOT, rel), family=family)
    return tc, fuse_params(to_device(tp, device="cpu"))


def _prefilled_state(cfg, params, prompts, steps, stop=(), into=None):
    """A zeroed cache prefilled with `prompts` and the DecodeState of its
    greedy first tokens; `into` = (cache, state) refills those in place."""
    B = len(prompts)
    lens = [len(p) for p in prompts]
    toks = np.zeros((B, max(lens)), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :lens[i]] = p
    if into is None:
        cache = decoder.init_kv_cache(cfg, B, CACHE, torch.float32, "cpu")
        stop_arr = _stop_array(stop, "cpu")
        state = DecodeState(torch.zeros((B,), dtype=torch.int32),
                            torch.zeros((B,), dtype=torch.int32),
                            torch.zeros((B,), dtype=torch.bool), stop_arr, steps)
    else:
        cache, state = into
        cache["k"].zero_()
        cache["v"].zero_()
    logits, cache = decoder.prefill(cfg, params, torch.from_numpy(toks), cache,
                                    prompt_lens=torch.tensor(lens, dtype=torch.int32))
    first = logits.argmax(-1).to(torch.int32)
    state.token.copy_(first)
    state.pos.copy_(torch.tensor(lens, dtype=torch.int32))
    state.done.copy_((first[:, None] == state.stop[None, :]).any(-1))
    return cache, state


@pytest.mark.parametrize("rel,family", FIXTURES)
def test_step_function_chunk_equals_jax(rel, family):
    steps = 24
    jc, jp = jload(os.path.join(ROOT, rel), family=family)
    jparams = jfuse(jto(jp))
    cache = jdec.init_kv_cache(jc, batch=1, max_len=CACHE)
    logits, cache = jdec.prefill(jc, jparams, jnp.asarray([PROMPT], jnp.int32), cache)
    first = jnp.argmax(logits, -1).astype(jnp.int32)
    want, jtok, jpos, _, jdone, _ = jgen.decode_chunk(
        jc, jparams, first, jnp.asarray([len(PROMPT)], jnp.int32), cache,
        jnp.zeros((1,), bool), jax.random.PRNGKey(0), jgen._stop_array(()),
        steps=steps, active_len=CACHE)

    cfg, params = _port_model(rel, family)
    kv, state = _prefilled_state(cfg, params, [PROMPT], steps)
    assert int(state.token[0]) == int(first[0])
    toks, token, pos, _, done = tgen.decode_chunk(
        cfg, params, state, kv, None, steps, active_len=CACHE,
        rope=decoder.build_rope(cfg, "cpu"), drop_past_end=False)
    assert token is state.token and pos is state.pos  # written in place
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want))
    assert int(pos[0]) == int(jpos[0]) == len(PROMPT) + steps
    assert int(token[0]) == int(jtok[0]) and bool(done[0]) == bool(jdone[0])


def test_paged_step_function_chunk_equals_jax(model, prefilled):  # noqa: F811
    """run_chunk_paged on a DecodeState against JAX decode_chunk_paged:
    tokens, positions, done flags and pools (the setup of
    tests/test_torch_paged.py `_decode_both`)."""
    jcfg, jp, cfg, tp = model
    steps = 6
    _, jk, jv = prefilled["j"]
    _, tk, tv = prefilled["t"]
    tk, tv = tk.clone(), tv.clone()
    pt = prefilled["pt"].copy()
    pt[0, 2:4], pt[1, 2:4] = [8, 10], [12, 13]
    pt[2] = 0
    pos = prefilled["lens"].copy()
    sl = np.minimum(pos + steps + 1, MAX_LEN).astype(np.int32)
    sl[2] = 0
    fb, fp, ft, ni = build_work_list(pt, sl, PS)
    token = np.asarray([7, 9, 0], np.int32)
    done = np.asarray([False, False, True])
    stop = {int(cfg.vocab_size) - 1}
    jt, jtok, jpos, jk, jv, jdone, _ = jpaged.decode_chunk_paged(
        jcfg, jp, jnp.asarray(token), jnp.asarray(pos), jnp.asarray(jk),
        jnp.asarray(jv), jnp.asarray(done), jax.random.PRNGKey(0),
        jgen._stop_array(stop), jnp.asarray(pt),
        *(jnp.asarray(a) for a in (fb, fp, ft, ni)), steps=steps, page_size=PS)
    state = DecodeState(torch.from_numpy(token.copy()), torch.from_numpy(pos.copy()),
                        torch.from_numpy(done.copy()), _stop_array(stop, "cpu"), 4)
    packed = torch.from_numpy(paged.pack_chunk_meta(pt, fb, fp, ft, ni))
    meta = paged.unpack_chunk_meta(packed, (3, pt.shape[1], len(fb)))
    toks = paged.run_chunk_paged(cfg, tp, state, tk, tv, None, meta, steps,
                                 page_size=PS)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(state.pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(state.done.numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(state.token.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tk[:, 1:].numpy(), np.asarray(jk)[:, 1:],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tv[:, 1:].numpy(), np.asarray(jv)[:, 1:],
                               atol=1e-5, rtol=1e-5)


def _eager_loop(cfg, params, token, pos, cache, done, gen, stop_ids, steps,
                temperature, top_k, top_p, rope):
    """The decode loop the step function replaced, as it was: a fresh
    token block, rebound state, torch.multinomial for the draw."""
    toks = torch.empty((token.shape[0], steps), dtype=torch.int32)
    for i in range(steps):
        logits, _ = decoder.decode_step(cfg, params, token, pos, cache, rope=rope,
                                        drop_past_end=False)
        probs = torch.softmax(filter_logits(logits, temperature, top_k, top_p), -1)
        nxt = torch.multinomial(probs, 1, generator=gen)[..., 0].to(torch.int32)
        nxt = torch.where(done, token, nxt)
        new_done = done | (nxt[:, None] == stop_ids[None, :]).any(dim=-1)
        pos = torch.where(done, pos, pos + 1)
        done, token = new_done, nxt
        toks[:, i] = nxt
    return toks, token, pos, done


@pytest.mark.parametrize("seed", [0, 3])
def test_seeded_step_function_equals_former_loop(seed):
    """Two rows sampled at temperature 0.9, top-k 20, top-p 0.95 with a
    stop id: the step function's tokens, positions and done flags equal the
    former loop's from the same seed."""
    cfg, params = _port_model(*FIXTURES[0])
    rope = decoder.build_rope(cfg, "cpu")
    prompts, steps, stop = [PROMPT, [1, 101, 32]], 20, [104, 33]
    sampling = dict(temperature=0.9, top_k=20, top_p=0.95)
    kv_a, state = _prefilled_state(cfg, params, prompts, steps, stop)
    kv_b = {k: v.clone() for k, v in kv_a.items()}
    old = (state.token.clone(), state.pos.clone(), state.done.clone())
    g = torch.Generator().manual_seed(seed)
    want = _eager_loop(cfg, params, *old[:2], kv_b, old[2], g, state.stop, steps,
                       *sampling.values(), rope)
    g.manual_seed(seed)
    toks, token, pos, _, done = tgen.decode_chunk(
        cfg, params, state, kv_a, g, steps, **sampling, active_len=CACHE,
        rope=rope, drop_past_end=False)
    for got, w in zip((toks, token, pos, done), want):
        assert torch.equal(got, w)
    assert torch.equal(kv_a["k"], kv_b["k"])


_ROPES: dict = {}


def _chunk(cfg, params, state, kv, steps, window, graph_cache, gen=None, **kw):
    """decode_chunk as the Generator calls it, with one rope table per
    model (a graph holds its pointers too); a copy of the chunk's tokens."""
    rope = _ROPES.setdefault(id(cfg), decoder.build_rope(cfg, "cpu"))
    return tgen.decode_chunk(cfg, params, state, kv, gen, steps, active_len=window,
                             rope=rope, drop_past_end=False, graphs=graph_cache,
                             **kw)[0].clone()


def test_graph_cache_captures_replays_and_counts(counting):
    """One key, one capture: a chunk's first step runs eagerly, the capture
    adds no launch and every later step replays, adding the captured launch
    delta; a new window is a new key and a new capture; a workspace epoch
    bump drops the graphs and recaptures the key once. Tokens and launch
    counts equal the eager route's throughout."""
    cfg, params = _port_model(*FIXTURES[0])
    per_step = 4 * cfg.n_layers + 1  # GEMVs: 4 projections a layer, lm_head
    plan = [(1, 64), (5, 64), (4, 128), (3, 128)]  # (steps, window)
    fixed = _prefilled_state(cfg, params, [PROMPT], 8)

    def run(graph_cache, bump_before=None):
        kv, state = _prefilled_state(cfg, params, [PROMPT], 8, into=fixed)
        out, launched = [], []
        for i, (steps, window) in enumerate(plan):
            if i == bump_before:
                workspace.scratch(torch.device("cpu"), "test_graphs", 1,
                                  torch.float32)
            before = counting()
            out.append(_chunk(cfg, params, state, kv, steps, window, graph_cache))
            launched.append(tuple(a - b for a, b in zip(counting(), before)))
        return out, launched

    eager, eager_launched = run(None)
    assert eager_launched == [(steps * per_step, 0) for steps, _ in plan]
    cache = graphs.GraphCache(torch.device("cpu"))
    got, launched = run(cache)
    assert launched == eager_launched
    assert all(torch.equal(a, b) for a, b in zip(got, eager))
    # windows 64 and 128: two keys, each captured after its first step
    assert (cache.n_captures, cache.n_recaptures, cache.n_replays) == (2, 0, 11)
    assert cache.stats()["graphs"] == 2

    epoch = workspace.epoch
    try:
        got, launched = run(cache, bump_before=2)
    finally:
        workspace._tensors.pop((None, "test_graphs"), None)
    assert workspace.epoch == epoch + 1
    assert launched == eager_launched
    assert all(torch.equal(a, b) for a, b in zip(got, eager))
    # the 64-slot graph replays; the bump drops both graphs, and the
    # 128-slot key is captured again after an eager first step
    assert (cache.n_captures, cache.n_recaptures) == (3, 1)
    assert cache.n_replays == 11 + 12


def test_graph_cache_replays_seeded_draws(counting):
    """A sampled chunk through the stand-in graphs, with the cache's
    generator registered: the draws equal the eager route's."""
    cfg, params = _port_model(*FIXTURES[2])
    sampling = dict(temperature=0.8, top_k=10, top_p=0.9)
    outs = []
    for use_graphs in (False, True):
        kv, state = _prefilled_state(cfg, params, [PROMPT, [3, 4, 5]], 12)
        g = torch.Generator().manual_seed(7)
        cache = graphs.GraphCache(torch.device("cpu"), g) if use_graphs else None
        outs.append([_chunk(cfg, params, state, kv, 12, 64, cache, g, **sampling)
                     for _ in range(2)])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_graph_cache_refuses_moved_static_tensors(counting):
    cfg, params = _port_model(*FIXTURES[0])
    kv, state = _prefilled_state(cfg, params, [PROMPT], 4)
    cache = graphs.GraphCache(torch.device("cpu"))
    _chunk(cfg, params, state, kv, 2, 64, cache)
    state.token = state.token.clone()  # rebound, not filled: a graph's input moved
    with pytest.raises(RuntimeError, match="moved"):
        _chunk(cfg, params, state, kv, 2, 64, cache)


def test_graph_cache_raises_and_invalidates_on_failed_capture(counting,
                                                             monkeypatch):
    """A capture that fails raises (no eager retry), leaves the launch
    counters as they were after the eager step, and raises the workspace
    epoch."""
    cfg, params = _port_model(*FIXTURES[0])
    kv, state = _prefilled_state(cfg, params, [PROMPT], 4)

    def broken(self, fn, static):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(CpuGraph, "capture", broken)
    cache = graphs.GraphCache(torch.device("cpu"))
    epoch, before = workspace.epoch, counting()
    with pytest.raises(RuntimeError, match="capture refused"):
        _chunk(cfg, params, state, kv, 3, 64, cache)
    after = counting()
    assert (after[0] - before[0], after[1] - before[1]) == (
        4 * cfg.n_layers + 1, 0)  # the eager step's
    assert workspace.epoch == epoch + 1 and cache.stats()["graphs"] == 0


def test_generator_graph_route_equals_eager(counting, monkeypatch):
    """The Generator on the graph route (forced on the CPU with the
    stand-in): one capture per window key, the same tokens and launch
    counts as the eager route, greedy and seeded; its cache and state are
    reused across calls."""
    cfg, params = _port_model(*FIXTURES[1])
    runs = {}
    for route in (False, True):
        gen = Generator(cfg, params, cache_len=CACHE, chunk=8, graphs=False)
        monkeypatch.setattr(gen, "graphs_on", lambda _r=route: _r)
        out = []
        for kw in ({}, dict(temperature=0.7, top_k=5, seed=2), {}):
            before = counting()
            out.append((gen.generate_ids(PROMPT, max_new_tokens=20, **kw)[0],
                        tuple(a - b for a, b in zip(counting(), before))))
        runs[route] = out, gen.graph_cache
    assert runs[True][0] == runs[False][0]
    assert len(runs[True][0][0][0]) == 20
    cache = runs[True][1]
    # greedy and sampled keys, each captured once; 19 decode steps a call
    # in chunks of 8, 8, 3: one eager step per key, the rest replays
    assert (cache.n_captures, cache.n_recaptures) == (2, 0)
    assert cache.n_replays == 3 * 19 - 2
    assert runs[False][1].n_captures == 0


@pytest.mark.parametrize("cls", ["Engine", "PagedEngine"])
def test_engine_graph_route_equals_eager(counting, cls):
    """The dense Engine, and the PagedEngine with preemptions (an
    over-committed pool) and chunked admission, through the stand-in
    graphs: the same tokens and launch counts as the eager engine. The
    PagedEngine's packed chunk metadata is one fixed buffer, so one key
    serves every chunk length."""
    cfg, params = _port_model(*FIXTURES[0])
    prompts = [[1, 5, 9, 2], [2, 3, 4, 4], [7, 7, 7, 7], list(range(10, 30))]
    kw = dict(max_batch=3, max_len=64, cache_dtype=torch.float32, chunk=8)
    if cls == "PagedEngine":
        kw.update(page_size=8, n_pages=9, reserve_growth=False,
                  prefill_chunk=16, admit_chunk=3)
    outs = []
    for route in (False, True):
        eng = getattr(teng, cls)(cfg, params, graphs=False, **kw)
        if route:
            eng.graph_cache = graphs.GraphCache(torch.device("cpu"), eng.generator)
        before = counting()
        reqs = [teng.Request(prompt_ids=p, max_new_tokens=20) for p in prompts]
        eng.run(reqs)
        outs.append(([r.out_ids for r in reqs], eng.n_preemptions,
                     tuple(a - b for a, b in zip(counting(), before)),
                     eng.n_decode_steps))
        if route:
            assert eng.graph_cache.n_captures == 1
            assert eng.graph_cache.n_replays == eng.n_decode_steps - 1
    assert outs[1] == outs[0]
    assert (outs[0][1] > 0) == (cls == "PagedEngine")  # a pool that preempts


def test_graphs_true_on_cpu_raises_and_auto_is_eager():
    cfg, params = _port_model(*FIXTURES[0])
    with pytest.raises(ValueError):
        Generator(cfg, params, graphs=True)
    with pytest.raises(ValueError):
        teng.Engine(cfg, params, max_batch=2, graphs=True)
    gen = Generator(cfg, params, cache_len=CACHE)
    assert not gen.graphs_on()
    gen.generate_ids(PROMPT, max_new_tokens=4)
    assert gen.graph_cache.n_captures == 0
    assert teng.PagedEngine(cfg, params, max_batch=2, max_len=64,
                            page_size=8).graph_cache is None
