"""The prefills as CUDA graphs (serving/graphs.py `run_once`), on the CPU.

Each prefill route of the port (the Generator's prefill, the dense Engine's
admit prefill, the PagedEngine's packed single-shot and chunked prefills)
runs its prefills through `SyncFreeGraph`: the CPU stand-in of
tests/test_torch_graphs.py, with every host-syncing call patched to raise
while a step is captured or replayed.
  * On the INT8 tinychar fixtures the graph route gives the eager route's
    first tokens, last logits and caches bit for bit, captures once per key
    and replays every later call, and its launch counts equal the eager
    route's.
  * On the fp32 tinychar fixtures the graph route's last logits equal the
    JAX counterpart's (decoder.prefill; engine._admit_prefill and the
    forward it runs; paged.prefill_paged, on the prompts of each packed
    stream; paged.prefill_chunk_paged) within 1e-5 of the largest, and its
    tokens exactly. The JAX side is fed the inputs the port packed for each
    prefill.
Besides: decoder.forward's sync-free drop against JAX forward's scatter with
mode="drop" on rows that mix kept and dropped positions, the chunked
prefill at three chunk starts under one key, seeded sampled prefills, and
a stale graph captured again alone.
"""

import contextlib
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
from kuiperllama_tpu.params import to_device as jto
from kuiperllama_tpu.serving import engine as jeng
from kuiperllama_tpu.serving.generate import _stop_array as jstop
from kuiperllama_tpu_torch.models import decoder, paged
from kuiperllama_tpu_torch.ops.kernels import workspace
from kuiperllama_tpu_torch.serving import engine as teng
from kuiperllama_tpu_torch.serving import graphs
from kuiperllama_tpu_torch.serving.generate import Generator

from test_torch_graphs import (FIXTURES, ROOT, CpuGraph, _port_model,  # noqa: F401
                               counting, one_thread)
from torch_threads import one_thread  # noqa: F401

REL = 1e-5
CPU = torch.device("cpu")
CACHE = 64
# three prefills per route, every one in the same (B, T = 16) key
CALLS = [[[1, 20, 33, 45, 60, 7, 90], [5, 6]],
         [[9] * 12, [3, 4, 5]],
         [list(range(2, 18)), [11]]]
LONG = [list(range(1, 71)), [5, 6, 7]]  # a 9-chunk wave of 8-token chunks
PS = 8
ROUTES = ["generator", "admit", "paged", "chunked"]

_SYNCS = [(torch, "nonzero"), (torch.Tensor, "nonzero"), (torch.Tensor, "item"),
          (torch.Tensor, "cpu"), (torch.Tensor, "tolist"), (torch.Tensor, "numpy"),
          (torch.Tensor, "__bool__"), (torch.Tensor, "__int__"),
          (torch.Tensor, "__index__")]


@contextlib.contextmanager
def no_host_sync():
    """Every call that brings a device value to the host raises."""
    saved = [(o, n, getattr(o, n)) for o, n in _SYNCS]

    def refuse(*a, **k):
        raise AssertionError("a host sync inside a captured step")

    for o, n, _ in saved:
        setattr(o, n, refuse)
    try:
        yield
    finally:
        for o, n, f in saved:
            setattr(o, n, f)


class SyncFreeGraph(CpuGraph):
    """CpuGraph whose capture and replays run the step with every host
    sync refused."""

    def capture(self, fn, static):
        def guarded():
            with no_host_sync():
                fn()

        super().capture(guarded, static)


@pytest.fixture
def strict(counting, monkeypatch):  # noqa: F811
    monkeypatch.setattr(graphs, "STEP_GRAPH", SyncFreeGraph)
    return counting


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- the four routes, driven through their entry points


def _pad(prompts):
    toks = np.zeros((len(prompts), 16), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    return toks, np.asarray([len(p) for p in prompts], np.int32)


def _generator(cfg, params, use_graphs):
    gen = Generator(cfg, params, cache_len=CACHE, chunk=4, graphs=False)
    if use_graphs:
        gen.graphs_on = lambda: True
    events = []
    for prompts in CALLS:
        rows, _, _ = gen.generate_batch_ids(prompts, max_new_tokens=1)
        events.append(dict(first=torch.tensor([r[0] for r in rows]),
                           logits=gen.prefill_logits[2].clone(),
                           inputs=_pad(prompts)))
    cache = gen._decode[2][0]
    return events, (cache["k"], cache["v"]), gen.graph_cache


def _spy(eng):
    """Record the parts of every prefill's packed inputs, as numpy."""
    log, real = [], eng._prefill_inputs

    def spy(key, parts):
        log.append((key, [np.array(p) for p in parts]))
        return real(key, parts)

    eng._prefill_inputs = spy
    return log


def _engine(cls, cfg, params, use_graphs, max_len=CACHE, **kw):
    eng = getattr(teng, cls)(cfg, params, max_len=max_len, chunk=4,
                             cache_dtype=torch.float32, graphs=False, **kw)
    if use_graphs:
        eng.graph_cache = graphs.GraphCache(CPU, eng.generator)
    return eng, _spy(eng)


def _event(eng, n):
    return dict(first=eng.prefill_first[:n].clone(),
                logits=eng.prefill_logits[:n].clone())


def _admits(cls, cfg, params, use_graphs, **kw):
    """Three admissions on three slots: two requests, a third beside the two
    live ones (their rows are dropped), then one into a cancelled slot."""
    eng, log = _engine(cls, cfg, params, use_graphs, max_batch=3, **kw)
    reqs = [teng.Request(prompt_ids=p, max_new_tokens=4) for p in
            CALLS[0] + CALLS[1][:1] + CALLS[2][:1]]
    events = []
    for i, batch in enumerate((reqs[:2], reqs[2:3], reqs[3:])):
        if i == 2:
            eng.cancel(reqs[0].request_id)
        for r in batch:
            eng.submit(r)
        eng._admit()
        events.append(_event(eng, len(batch)))
    for e, (_, parts) in zip(events, log):
        e["inputs"] = parts
    return events, eng._cache_tensors(), eng.graph_cache


def _wave(cfg, params, use_graphs):
    """One chunked admission wave of a 70-token and a 3-token prompt."""
    eng, log = _engine("PagedEngine", cfg, params, use_graphs, max_len=128,
                       max_batch=2, page_size=PS, prefill_chunk=PS)
    for p in LONG:
        eng.submit(teng.Request(prompt_ids=p, max_new_tokens=2))
    eng._start_wave()
    while eng._wave is not None:
        eng._advance_wave()
    events = [dict(_event(eng, 2), inputs=[parts for _, parts in log])]
    return events, eng._cache_tensors(), eng.graph_cache


def _drive(route, cfg, params, use_graphs):
    if route == "generator":
        return _generator(cfg, params, use_graphs)
    if route == "chunked":
        return _wave(cfg, params, use_graphs)
    return _admits("Engine" if route == "admit" else "PagedEngine", cfg, params,
                   use_graphs, **({} if route == "admit" else dict(page_size=PS)))


# -- the JAX counterparts, fed the port's inputs


def _jax_events(route, jc, jp, events, cache):
    """Per event: the JAX counterpart's (last logits [Ba, V], tokens [Ba]),
    and its cache (or pools) at the end, chained across the events."""
    out = []
    if route == "generator":
        for e in events:
            toks, lens = e["inputs"]
            logits, jcache = jdec.prefill(jc, jp, jnp.asarray(toks),
                                          jdec.init_kv_cache(jc, 2, CACHE),
                                          prompt_lens=jnp.asarray(lens))
            out.append((np.asarray(logits), np.asarray(logits).argmax(-1)))
        return out, (jcache["k"], jcache["v"])
    if route == "admit":
        S = cache[0].shape[2]
        jcache = jdec.init_kv_cache(jc, 3, S)
        for e in events:
            toks, lens, admit, back = (jnp.asarray(a) for a in e["inputs"])
            admit = admit.astype(bool)
            pos = jnp.where(admit[:, None], jnp.arange(toks.shape[1])[None], S)
            mask = jnp.arange(S)[None] < lens[:, None]
            logits, _ = jdec.forward(jc, jp, toks, pos.astype(jnp.int32), jcache,
                                     mask, last_pos=lens - 1)
            tok, _, jcache = jeng._admit_prefill(
                jc, jp, toks, lens, admit, jcache, jax.random.PRNGKey(0), jstop(()))
            n = len(e["first"])
            out.append((np.asarray(logits)[np.asarray(back)[:n], 0],
                        np.asarray(tok)[np.asarray(back)[:n]]))
        return out, (jcache["k"], jcache["v"])
    kp = jnp.zeros(cache[0].shape, jnp.float32)
    vp = jnp.zeros(cache[1].shape, jnp.float32)
    if route == "paged":
        # the packed stream's prompts, back on JAX's [B, 16] grid
        for e in events:
            toks, _, seg, pages, _ = e["inputs"]
            n = len(e["first"])
            rows = [np.flatnonzero(seg == b) for b in range(n)]
            grid, lens = _pad([toks[0, r] for r in rows])
            token_pages = np.full(grid.shape, 2 ** 30, np.int32)
            for b, r in enumerate(rows):
                token_pages[b, :len(r)] = pages[r]
            offs = np.broadcast_to(np.arange(grid.shape[1]) % PS, grid.shape)
            logits, kp, vp = jpaged.prefill_paged(
                jc, jp, jnp.asarray(grid), jnp.asarray(lens), kp, vp,
                jnp.asarray(token_pages), jnp.asarray(offs.astype(np.int32)))
            out.append((np.asarray(logits), np.asarray(logits).argmax(-1)))
        return out, (kp, vp)
    last = None
    for toks, start, lens, cp, hp in events[0]["inputs"]:
        logits, ends, kp, vp = jpaged.prefill_chunk_paged(
            jc, jp, jnp.asarray(toks), jnp.int32(start), jnp.asarray(lens), kp, vp,
            jnp.asarray(cp), jnp.asarray(hp))
        last = logits if last is None else jnp.where(ends[:, None], logits, last)
    last = np.asarray(last)
    return [(last, last.argmax(-1))], (kp, vp)


@pytest.mark.parametrize("rel,family", FIXTURES)
@pytest.mark.parametrize("route", ROUTES)
def test_prefill_graph_route_equals_eager_and_jax(route, rel, family, strict):
    """The route's prefills through the stand-in graphs: the eager route's
    tokens, logits, caches and launch counts bit for bit on the INT8
    fixture, one capture per key and replays after it, no host sync; the
    JAX counterpart's on the fp32 fixture."""
    cfg, params = _port_model(rel, family)
    runs = {}
    for use_graphs in (False, True):
        before = strict()
        events, cache, gcache = _drive(route, cfg, params, use_graphs)
        runs[use_graphs] = (events, cache,
                            tuple(a - b for a, b in zip(strict(), before)), gcache)
    (eager, e_cache, e_launched, _), (got, g_cache, launched, gcache) = (
        runs[False], runs[True])
    for a, b in zip(got, eager):
        assert torch.equal(a["first"], b["first"])
        assert torch.equal(a["logits"], b["logits"])
    assert all(torch.equal(a, b) for a, b in zip(g_cache, e_cache))
    assert launched == e_launched and launched[0] + launched[1] > 0
    st = gcache.stats()
    if route == "chunked":
        # n_hist buckets 0, 1, 2, 4, 4, 8, 8, 8, 8: the 8 bucket serves the
        # chunk starts 40, 48, 56 and 64 with one graph
        assert (st["n_prefill_captures"], st["n_prefill_replays"]) == (5, 4)
        assert st["prefill_graphs"] == 5
    else:
        assert (st["n_prefill_captures"], st["n_prefill_replays"]) == (1, 2)
    assert st["n_prefill_recaptures"] == 0 and st["n_captures"] == 0

    jc, jp = jload(os.path.join(ROOT, rel.replace(".q8", "")), family=family)
    jp = jfuse(jto(jp))
    cfg, params = _port_model(rel.replace(".q8", ""), family)
    events, cache, gcache = _drive(route, cfg, params, True)
    assert gcache.prefill.replays > 0
    want, want_cache = _jax_events(route, jc, jp, events, cache)
    for e, (logits, toks) in zip(events, want):
        assert _rel(e["logits"], logits) <= REL
        np.testing.assert_array_equal(e["first"].numpy(), toks)
    sink = 0 if route == "admit" or route == "generator" else 1  # page 0 is the sink
    written = np.zeros(cache[0].shape[1:3], bool)
    written[sink:] = True
    if route == "paged":
        # the packed stream writes its prompts' tokens and nothing past a
        # prompt's end, where JAX's grid writes its padding
        written[:] = False
        for e in events:
            _, pos, seg, pages, _ = e["inputs"]
            real = seg >= 0
            written[pages[real], pos[real] % PS] = True
        assert not written[0].any()
        for t in cache:
            assert not t[:, 1:][:, ~written[1:]].any()  # the pools start at 0
    for t, j in zip(cache, want_cache):
        t, j = t.numpy(), np.asarray(j)
        assert _rel(t[:, written], j[:, written]) <= REL


@pytest.mark.parametrize("rel,family", FIXTURES[:1] + FIXTURES[2:])
def test_sync_free_drop_equals_jax_drop(rel, family):
    """decoder.forward with T > 1 over rows that mix kept and dropped
    positions, on a cache of noise: the cache and logits of JAX forward's
    scatter with mode="drop", without a host sync. Row 1 writes slot S - 1
    and runs past S; row 2 drops every write; row 3 mixes them out of
    order; row 0 keeps all."""
    S = 8
    pos = np.asarray([[0, 1, 2, 3], [5, 6, 7, 8], [8, 9, 10, 11], [3, 9, 7, 1]],
                     np.int32)
    rng = np.random.default_rng(4)
    jc, jp = jload(os.path.join(ROOT, rel.replace(".q8", "")), family=family)
    jp = jfuse(jto(jp))
    cfg, params = _port_model(rel.replace(".q8", ""), family)
    toks = rng.integers(1, cfg.vocab_size, pos.shape).astype(np.int32)
    shape = (cfg.n_layers, 4, S, cfg.n_kv_heads, cfg.head_dim)
    k0, v0 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    mask = np.ones((4, S), bool)
    want, jcache = jdec.forward(jc, jp, jnp.asarray(toks), jnp.asarray(pos),
                                dict(k=jnp.asarray(k0), v=jnp.asarray(v0)),
                                jnp.asarray(mask))
    cache = dict(k=torch.from_numpy(k0.copy()), v=torch.from_numpy(v0.copy()))
    with no_host_sync():
        got, cache = decoder.forward(cfg, params, torch.from_numpy(toks),
                                     torch.from_numpy(pos), cache,
                                     torch.from_numpy(mask))
    assert _rel(got, want) <= REL
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]),
                                   rtol=REL, atol=REL)
    # the dropped row's slots are untouched, bit for bit
    assert torch.equal(cache["k"][:, 2], torch.from_numpy(k0[:, 2]))


def test_chunk_start_on_device_one_key(strict):
    """prefill_chunk_paged with its chunk start in a fixed device buffer:
    three chunk starts run under ONE graph key (one capture, two replays)
    and each equals JAX's prefill_chunk_paged on the same inputs."""
    rel, family = FIXTURES[0]
    jc, jp = jload(os.path.join(ROOT, rel.replace(".q8", "")), family=family)
    jp = jfuse(jto(jp))
    cfg, params = _port_model(rel.replace(".q8", ""), family)
    rng = np.random.default_rng(9)
    B, C, n_hist, P = 2, PS, 4, 12
    shape = (cfg.n_layers, P, PS, cfg.n_kv_heads * cfg.head_dim)
    kp0, vp0 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    lens = np.asarray([40, 27], np.int32)
    pt = np.asarray([[3, 7, 1, 9, 4], [5, 2, 8, 11, 0]], np.int32)
    kp, vp = torch.from_numpy(kp0.copy()), torch.from_numpy(vp0.copy())
    jk, jv = jnp.asarray(kp0), jnp.asarray(vp0)
    n_tok, n_cp = B * C, B * (C // PS)
    buf = torch.zeros(n_tok + 1 + B + n_cp + B * n_hist, dtype=torch.int32)
    views = (buf[:n_tok].view(B, C), buf[n_tok], buf[n_tok + 1: n_tok + 1 + B],
             buf[n_tok + 1 + B: n_tok + 1 + B + n_cp].view(B, C // PS),
             buf[n_tok + 1 + B + n_cp:].view(B, n_hist))
    out = [torch.zeros(B, cfg.vocab_size), torch.zeros(B, dtype=torch.bool)]

    def fn():
        logits, ends, _, _ = paged.prefill_chunk_paged(
            cfg, params, views[0], views[1], views[2], kp, vp, views[3], views[4])
        out[0].copy_(logits)
        out[1].copy_(ends)

    cache = graphs.GraphCache(CPU)
    for start in (16, 24, 32):
        toks = rng.integers(1, cfg.vocab_size, (B, C)).astype(np.int32)
        cp = np.full((B, 1), 2 ** 30, np.int32)
        for b in range(B):
            if start < lens[b]:
                cp[b, 0] = pt[b, start // PS]
        hp = np.zeros((B, n_hist), np.int32)
        hp[:, :start // PS] = pt[:, :start // PS]
        buf.copy_(torch.from_numpy(np.concatenate(
            [toks.ravel(), [start], lens, cp.ravel(), hp.ravel()]).astype(np.int32)))
        graphs.run_once(cache, ("prefill_chunk", B, C, n_hist, None), fn,
                        (buf, kp, vp, *out))
        jl, je, jk, jv = jpaged.prefill_chunk_paged(
            jc, jp, jnp.asarray(toks), jnp.int32(start), jnp.asarray(lens), jk, jv,
            jnp.asarray(cp), jnp.asarray(hp))
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(je))
        rows = np.asarray(je)
        if rows.any():
            assert _rel(out[0].numpy()[rows], np.asarray(jl)[rows]) <= REL
    assert (cache.prefill.captures, cache.prefill.replays) == (1, 2)
    np.testing.assert_allclose(kp[:, 1:].numpy(), np.asarray(jk)[:, 1:],
                               rtol=REL, atol=REL)
    np.testing.assert_allclose(vp[:, 1:].numpy(), np.asarray(jv)[:, 1:],
                               rtol=REL, atol=REL)


@pytest.mark.parametrize("seed", [0, 5])
def test_seeded_sampled_prefill_equals_eager(seed, strict):
    """A sampled prefill (temperature 0.9, top-k 20, top-p 0.95) and its
    decode through the stand-in graphs, the cache's generator registered:
    the eager route's draws, call after call."""
    cfg, params = _port_model(*FIXTURES[1])
    outs = []
    for use_graphs in (False, True):
        gen = Generator(cfg, params, cache_len=CACHE, chunk=4, graphs=False)
        if use_graphs:
            gen.graphs_on = lambda: True
        outs.append([gen.generate_batch_ids(p, max_new_tokens=6, temperature=0.9,
                                            top_k=20, top_p=0.95,
                                            seed=seed + i)[0]
                     for i, p in enumerate(CALLS)])
    assert outs[1] == outs[0]
    st = gen.graph_cache.stats()
    assert (st["n_prefill_captures"], st["n_prefill_replays"]) == (1, 2)


def test_stale_graph_captured_again_alone(strict):
    """A workspace that grows after a prefill's capture (a decode step's
    first call sizing a megakernel's scratch) makes only that prefill's
    graph stale: its next call runs eagerly and captures again, and the
    decode graph captured after the growth keeps replaying."""
    cfg, params = _port_model(*FIXTURES[0])
    gen = Generator(cfg, params, cache_len=CACHE, chunk=4, graphs=False)
    want = gen.generate_batch_ids(CALLS[0], max_new_tokens=6)[0]
    gen.graphs_on = lambda: True
    cache = gen.graph_cache
    real = cache._capture

    def capture(key, fn, static, rng, prefill):
        if not prefill:  # grows once: before the first decode step's capture
            workspace.scratch(CPU, "test_prefill_graphs", 1, torch.float32)
        return real(key, fn, static, rng, prefill)

    cache._capture = capture
    epoch = workspace.epoch
    try:
        first = gen.generate_batch_ids(CALLS[0], max_new_tokens=6)[0]
        assert workspace.epoch == epoch + 1
        again = gen.generate_batch_ids(CALLS[0], max_new_tokens=6)[0]
    finally:
        workspace._tensors.pop((None, "test_prefill_graphs"), None)
    assert first == again == want
    st = gen.graph_cache.stats()
    assert (st["n_prefill_captures"], st["n_prefill_recaptures"]) == (2, 1)
    assert (st["n_captures"], st["n_recaptures"]) == (1, 0)
    assert st["n_replays"] == 2 * 5 - 1
