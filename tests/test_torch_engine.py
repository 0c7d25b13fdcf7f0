"""The port's continuous-batching engines (serving/engine.py) against the JAX
package's, request by request: the JAX tiny_config weights carried across by
`convert.from_jax_params` (fp32 params and caches) and the same requests
give the same greedy tokens, the same preemptions and the same free pages.
Mirrors tests/test_engine.py and tests/test_engine_oom.py; the JAX
PagedEngine runs its paged-attention Pallas kernel in interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kuiperllama_tpu.config import tiny_config as jtiny
from kuiperllama_tpu.params import random_params as jrandom, to_device as jto
from kuiperllama_tpu.serving import engine as jeng
from kuiperllama_tpu_torch.config import tiny_config
from kuiperllama_tpu_torch.convert import from_jax_params
from kuiperllama_tpu_torch.serving import engine as teng
from torch_threads import one_thread  # noqa: F401

PROMPTS = [[1, 5, 9], [2, 3], [7, 7, 7, 7], [4, 11]]


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = jtiny("llama2", seq_len=64), tiny_config("llama2", seq_len=64)
    jp = jto(jrandom(jcfg, seed=11), dtype=jnp.float32)
    return jcfg, jp, cfg, from_jax_params(jp, device="cpu")


def _engines(model, cls, **kw):
    jcfg, jp, cfg, tp = model
    base = dict(max_batch=2, max_len=64, chunk=4)
    base.update(kw)
    return (getattr(jeng, cls)(jcfg, jp, cache_dtype=jnp.float32, **base),
            getattr(teng, cls)(cfg, tp, cache_dtype=torch.float32, **base))


def _run(eng, mod, prompts, max_new):
    """Run requests to the end; max_new is one budget or one per prompt."""
    news = max_new if isinstance(max_new, list) else [max_new] * len(prompts)
    reqs = [mod.Request(prompt_ids=list(p), max_new_tokens=n)
            for p, n in zip(prompts, news)]
    done = eng.run(reqs)
    assert {r.request_id for r in done} == {r.request_id for r in reqs}
    return reqs


def _both(model, cls, prompts, max_new, **kw):
    je, te = _engines(model, cls, **kw)
    jr, tr = _run(je, jeng, prompts, max_new), _run(te, teng, prompts, max_new)
    assert [r.out_ids for r in tr] == [r.out_ids for r in jr]
    return je, te, jr, tr


@pytest.fixture(scope="module")
def paged_runs(model):
    """Single-shot and chunked PagedEngine runs of four prompts of 40, 2,
    25 and 37 tokens on 8-token pages, on both sides."""
    prompts = [list(range(1, 41)), [2, 3], list(range(5, 30)), [7] * 37]
    runs = {}
    for name, kw in (("single", {}), ("chunked", dict(prefill_chunk=16,
                                                      admit_chunk=2))):
        runs[name] = _both(model, "PagedEngine", prompts, 8, page_size=8, **kw)
    return runs


def test_engine_continuous_admission_matches_jax(model):
    # four requests through two slots: slots recycle as rows retire
    _, te, _, tr = _both(model, "Engine", PROMPTS, 10)
    assert all(len(r.out_ids) == 10 for r in tr)
    assert all(0 <= r.ttft_s and r.finish_time >= r.first_token_time for r in tr)
    assert te.n_active == 0 and bool(te.done.all())


def test_engine_max_tokens_respected(model):
    _, _, _, tr = _both(model, "Engine", [[3, 1], [3, 1]], [1, 13],
                        max_batch=4, chunk=8)
    assert [len(r.out_ids) for r in tr] == [1, 13]


def test_paged_engine_page_recycling_matches_jax(model):
    je, te, _, tr = _both(model, "PagedEngine", PROMPTS, 5, page_size=128,
                          n_pages=4)
    assert all(len(r.out_ids) == 5 for r in tr)
    assert te.allocator.n_free_pages == je.allocator.n_free_pages == 3
    assert te.allocator.free == je.allocator.free


@pytest.mark.parametrize("cls", ["Engine", "PagedEngine"])
def test_admission_is_batched(model, cls):
    """Every request admitted at a step boundary prefills in ONE forward,
    and decode progresses before the next admission. The port's
    PagedEngine takes the packed prefill, given the admitted slots alone;
    the grids carry padding slots, which are not counted."""
    je, te = _engines(model, cls, max_batch=3)
    calls = {}
    for name, eng in (("jax", je), ("torch", te)):
        hook = ("_prefill_packed" if name == "torch" and cls == "PagedEngine"
                else "_prefill_batch")
        orig, log = getattr(eng, hook), calls.setdefault(name, [])

        def spy(slots, *a, orig=orig, log=log, eng=eng):
            log.append(int((np.asarray(slots) < eng.max_batch).sum()))
            return orig(slots, *a)

        setattr(eng, hook, spy)
    jr = _run(je, jeng, PROMPTS, 6)
    tr = _run(te, teng, PROMPTS, 6)
    assert [r.out_ids for r in tr] == [r.out_ids for r in jr]
    assert calls["torch"] == calls["jax"] == [3, 1]


def test_chunked_prefill_matches_single_shot(paged_runs):
    single, chunked = paged_runs["single"][3], paged_runs["chunked"][3]
    assert [r.out_ids for r in chunked] == [r.out_ids for r in single]
    assert all(len(r.out_ids) == 8 for r in single)


def test_decode_progresses_during_chunked_admission(model):
    """Active slots keep generating while a long prompt's admission is
    mid-prefill, and both requests end with JAX's tokens."""
    engines = _engines(model, "PagedEngine", chunk=8, page_size=8,
                       prefill_chunk=8, admit_chunk=2)
    outs = []
    for eng, mod in zip(engines, (jeng, teng)):
        a = mod.Request(prompt_ids=[1, 5, 9], max_new_tokens=40)
        eng.submit(a)
        eng.step()
        assert len(a.out_ids) > 0
        b = mod.Request(prompt_ids=list(range(1, 41)), max_new_tokens=4)
        eng.submit(b)
        waves = progressed = 0
        for _ in range(20):
            before = len(a.out_ids)
            eng.step()
            if eng._wave is not None:
                waves += 1
                progressed += len(a.out_ids) - before
            if b.first_token_time:
                break
        eng.run([])
        assert waves >= 2 and progressed > 0, (waves, progressed)
        assert b.finished and len(b.out_ids) == 4
        outs.append((a.out_ids, b.out_ids, waves, progressed))
    assert outs[1] == outs[0]


@pytest.mark.parametrize("reserve_growth", [False, True])
def test_pool_pressure_matches_jax(model, reserve_growth):
    """Five usable pages of 8 tokens for three requests that grow to 25
    tokens: over-commit preempts the youngest slot and resumes it by a
    prefill of prompt + generated; reserve_growth serializes admissions
    instead. Outputs, preemptions and free pages equal JAX's."""
    prompts = [[1, 5, 9, 2], [2, 3, 4, 4], [7, 7, 7, 7]]
    je, te, jr, tr = _both(model, "PagedEngine", prompts, 20, page_size=8,
                           n_pages=6, reserve_growth=reserve_growth)
    assert all(len(r.out_ids) == 20 for r in tr)
    assert te.n_preemptions == je.n_preemptions
    assert (te.n_preemptions > 0) != reserve_growth
    assert [r.preempted for r in tr] == [r.preempted for r in jr]
    assert te.allocator.n_free_pages == 5
    for r in tr:
        if r.preempted:  # TTFT is the first token's, not the resume's
            assert 0 < r.ttft_s < r.finish_time - r.submit_time


@pytest.mark.parametrize("cls", ["Engine", "PagedEngine"])
def test_request_runs_into_max_len(model, cls):
    """A 10-token prompt asking for 30 tokens in a 16-token cache: decode
    runs past the last slot inside a chunk (dropped dense writes; the paged
    write index clamped to the last page) and the request retires at
    capacity, with JAX's tokens."""
    kw = dict(page_size=4) if cls == "PagedEngine" else {}
    _, te, _, tr = _both(model, cls, [list(range(1, 11)), [3, 4]], 30,
                         max_len=16, **kw)
    assert 0 < len(tr[0].out_ids) < 30
    assert te.n_active == 0


def test_preempt_at_cache_capacity_retires(model):
    """A victim whose prompt + generated tokens fill max_len is retired by
    the preemption, not re-queued (test_engine_oom's scenario)."""
    finished = []
    for eng, mod in zip(_engines(model, "PagedEngine", max_len=16, page_size=4,
                                 n_pages=8, reserve_growth=False), (jeng, teng)):
        a = mod.Request(prompt_ids=[1, 5], max_new_tokens=30)
        eng.submit(a)
        done = []
        while not done and eng.has_work:
            done.extend(eng.step())
            if int(np.asarray(eng.pos).max()) >= 9:
                break
        b = mod.Request(prompt_ids=list(range(1, 16)), max_new_tokens=30)
        eng.submit(b)
        while eng.has_work:
            done.extend(eng.step())
        assert {r.request_id for r in done} == {a.request_id, b.request_id}
        assert eng.allocator.n_free_pages == 7
        finished.append((a.out_ids, b.out_ids, a.preempted, b.preempted))
    assert finished[1] == finished[0]


def test_oversized_request_fails_loudly(model):
    _, te = _engines(model, "PagedEngine", page_size=8, n_pages=3)
    te.submit(teng.Request(prompt_ids=list(range(1, 30)), max_new_tokens=30))
    with pytest.raises(RuntimeError, match="KV pages"):
        te.run([])



def test_packed_admissions_of_one_bucket_replay_one_graph(model, monkeypatch):
    """A 1-row admission (20 tokens) and a 3-row one (7 + 8 + 9 tokens)
    pack into streams of the same 32-token bucket: the second replays the
    first's prefill graph (CPU stand-in graphs), and the served tokens equal
    JAX's engine, which pads each admission to [max_batch, bucket]."""
    from kuiperllama_tpu_torch.serving import graphs

    from test_torch_graphs import CpuGraph

    monkeypatch.setattr(graphs, "STEP_GRAPH", CpuGraph)
    je, te = _engines(model, "PagedEngine", max_batch=4, page_size=8)
    te.graph_cache = graphs.GraphCache(torch.device("cpu"), te.generator)
    prompts = [list(range(1, 21)), [3] * 7, list(range(30, 38)), [9, 8] * 4 + [1]]
    outs = []
    for eng, mod in ((je, jeng), (te, teng)):
        reqs = [mod.Request(prompt_ids=p, max_new_tokens=6) for p in prompts]
        eng.submit(reqs[0])
        eng.step()
        for r in reqs[1:]:
            eng.submit(r)
        eng.run([])
        outs.append([r.out_ids for r in reqs])
    assert outs[1] == outs[0] and all(len(o) == 6 for o in outs[1])
    st = te.graph_cache.stats()
    assert (st["n_prefill_captures"], st["n_prefill_replays"],
            st["prefill_graphs"]) == (1, 1, 1)
    assert list(te._prefill_in) == [("prefill_packed", 32, 4)]
    assert te.prefill_padded_tokens == 2 * 32 and te.prefill_tokens == 44


def test_mesh_path_keeps_the_padded_prefill(model, monkeypatch):
    """With a mesh (a stand-in step here, calling prefill_paged as
    ShardedPagedStep does) the admission is still one [max_batch, bucket]
    prefill_paged; without one, prefill_packed_paged and never
    prefill_paged."""
    from kuiperllama_tpu_torch.models import paged

    calls = []
    for name in ("prefill_paged", "prefill_packed_paged"):
        real = getattr(paged, name)

        def rec(*a, _real=real, _name=name, **k):
            calls.append((_name, tuple(a[2].shape)))
            return _real(*a, **k)

        monkeypatch.setattr(paged, name, rec)

    class Step:
        key = "mesh"

        @staticmethod
        def prefill(*a, **k):
            return paged.prefill_paged(*a, **k)

    for sharded in (False, True):
        _, te = _engines(model, "PagedEngine", max_batch=3, page_size=8)
        if sharded:
            te._sharded = Step()
        for p in PROMPTS[:2]:
            te.submit(teng.Request(prompt_ids=p, max_new_tokens=4))
        te._admit()
    assert calls == [("prefill_packed_paged", (1, 16)), ("prefill_paged", (3, 16))]
