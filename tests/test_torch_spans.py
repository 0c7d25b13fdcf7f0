"""The port's spans (utils/profiling.py `span`) on the CPU: the recorder
itself, and the span trees of a PagedEngine step, a Generator call and a
graph capture, each under a CPU torch.profiler. Off, nothing is recorded."""

import json

import numpy as np
import pytest
import torch
import torch.profiler as tp

from kuiperllama_tpu_torch.config import tiny_config
from kuiperllama_tpu_torch.fuse import fuse_params
from kuiperllama_tpu_torch.ops.kernels import workspace
from kuiperllama_tpu_torch.params import random_params, to_device
from kuiperllama_tpu_torch.serving import graphs
from kuiperllama_tpu_torch.serving.engine import Engine, PagedEngine, Request
from kuiperllama_tpu_torch.serving.generate import Generator, chunk_route
from kuiperllama_tpu_torch.utils import profiling

from test_torch_graphs import CpuGraph
from torch_threads import one_thread  # noqa: F401

PROMPTS = [[1, 5, 9], [2, 3], list(range(1, 21)), [4, 11]]


@pytest.fixture(autouse=True)
def fresh():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


@pytest.fixture(scope="module")
def model():
    cfg = tiny_config("llama2", seq_len=64)
    return cfg, to_device(random_params(cfg, seed=3), device="cpu")


def profiler():
    return tp.profile(activities=[tp.ProfilerActivity.CPU])


def by_name(name):
    return [r for r in profiling.spans() if r.name == name]


def children(rec):
    return [r for r in profiling.spans() if r.parent == rec.id]


# ---- the recorder


def test_off_records_nothing_and_returns_the_shared_noop():
    assert not profiling.tracing()
    a, b = profiling.span("kt.x"), profiling.span("kt.y", ids=(1,), n=2)
    assert a is b
    with a as rec:
        rec.set(n=3)
    assert profiling.spans() == [] and profiling.dropped_spans() == 0


def test_tracing_follows_the_profiler():
    assert not profiling.tracing()
    with profiler():
        assert profiling.tracing()
    assert not profiling.tracing()


def test_on_records_the_kineto_event_and_the_record():
    with profiler() as prof:
        with profiling.span("kt.warm"):
            pass
        with profiling.span("kt.a", n=1) as rec:
            rec.set(m=2)
            torch.randn(16).sum()
    (a,) = by_name("kt.a")
    assert a.attrs == {"n": 1, "m": 2} and 0 < a.start_ns < a.end_ns
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "kt.a"]
    # the record's stamps hold the profiler's range, on the same clock
    assert abs(ev.start_ns() - a.start_ns) < 1_000_000
    assert a.start_ns <= ev.start_ns() and ev.start_ns() + ev.duration_ns() <= a.end_ns


def test_parents_and_request_ids_nest_as_the_code_nests():
    with profiler():
        with profiling.span("kt.outer", ids=(7, 8)) as outer:
            with profiling.span("kt.mid") as mid:
                with profiling.span("kt.inner", ids=(8,)) as inner:
                    pass
            with profiling.span("kt.sib") as sib:
                pass
        with profiling.span("kt.top") as top:
            pass
    assert [r.name for r in profiling.spans()] == [
        "kt.outer", "kt.mid", "kt.inner", "kt.sib", "kt.top"]
    assert outer.parent is None and top.parent is None
    assert mid.parent == sib.parent == outer.id and inner.parent == mid.id
    assert mid.ids == sib.ids == (7, 8) and inner.ids == (8,) and top.ids == ()
    assert outer.start_ns <= mid.start_ns <= inner.end_ns <= mid.end_ns <= sib.start_ns


def test_a_span_closes_when_its_body_raises():
    with profiler():
        with pytest.raises(ValueError):
            with profiling.span("kt.fails"):
                raise ValueError("x")
        with profiling.span("kt.after") as after:
            pass
    (failed,) = by_name("kt.fails")
    assert failed.end_ns >= failed.start_ns > 0 and after.parent is None


def test_the_bound_drops_the_oldest_records_and_counts_them(monkeypatch):
    monkeypatch.setattr(profiling, "_recorder", profiling._Recorder(limit=3))
    with profiler():
        for i in range(5):
            with profiling.span(f"kt.s{i}"):
                pass
    assert [r.name for r in profiling.spans()] == ["kt.s2", "kt.s3", "kt.s4"]
    assert profiling.dropped_spans() == 2
    profiling.clear_spans()
    assert profiling.spans() == [] and profiling.dropped_spans() == 0


def test_trace_drops_earlier_records_and_writes_the_spans(tmp_path):
    with profiler():
        with profiling.span("kt.before"):
            pass
    with profiling.trace(str(tmp_path)):
        with profiling.span("kt.inside"):
            torch.randn(8).sum()
    assert [r.name for r in profiling.spans()] == ["kt.inside"]
    with open(tmp_path / "trace.json") as f:
        evs = json.load(f)["traceEvents"]
    names = {e.get("name") for e in evs}
    assert "kt.inside" in names and "kt.before" not in names
    # a host range as an operator's: a user annotation would also lay a
    # range over its kernels on the device's timeline
    assert {e.get("cat") for e in evs if e.get("name") == "kt.inside"} == {"cpu_op"}


# ---- the engine


def _engine(model, cls, **kw):
    cfg, params = model
    base = dict(max_batch=2, max_len=64, chunk=4, cache_dtype=torch.float32)
    if cls is PagedEngine:
        base["page_size"] = 8
    base.update(kw)
    return cls(cfg, params, **base)


@pytest.mark.parametrize("cls", [Engine, PagedEngine])
def test_engine_step_gives_the_span_tree(model, cls):
    eng = _engine(model, cls)
    reqs = [Request(prompt_ids=p, max_new_tokens=6) for p in PROMPTS[:2]]
    for r in reqs:
        eng.submit(r)
    with profiler():
        eng.step()
    (step,) = by_name("kt.engine.step")
    assert [r.name for r in children(step)] == [
        "kt.engine.admit", "kt.engine.prefill", "kt.engine.sync", "kt.engine.chunk",
        "kt.engine.sync", "kt.engine.collect"]
    admit, prefill, _, chunk, _, collect = children(step)
    assert admit.ids == tuple(r.request_id for r in reqs)
    assert admit.attrs["left"] == 0 and admit.attrs["why"] is None
    assert len(admit.attrs["waits"]) == 2 and min(admit.attrs["waits"]) >= 0
    T = prefill.attrs["T"]
    assert prefill.attrs["tokens"] == sum(len(p) for p in PROMPTS[:2])
    assert prefill.attrs["rows_real"] == 2 and prefill.attrs["graph"] == "eager"
    if cls is PagedEngine:
        # one packed stream of both prompts, padded to its own bucket
        assert prefill.attrs["computed"] == T == 16 and prefill.attrs["rows"] == 1
        assert prefill.attrs["packed"] is True
        assert prefill.attrs["key"] == ("prefill_packed", 16, eng.max_batch)
    else:
        assert prefill.attrs["computed"] == eng.max_batch * T == 2 * 16
        assert prefill.attrs["rows"] == 2 and "packed" not in prefill.attrs
        assert prefill.attrs["key"][0] == "admit"
    assert chunk.attrs["steps"] == 4 and chunk.attrs["rows"] == 2
    assert set(chunk.ids) == {r.request_id for r in reqs}
    assert collect.attrs["retired"] == []


def test_the_prefill_counters_equal_the_prefill_spans(model):
    eng = _engine(model, PagedEngine)
    with profiler():
        eng.run([Request(prompt_ids=p, max_new_tokens=5) for p in PROMPTS])
    pre = by_name("kt.engine.prefill")
    assert len(pre) == eng.n_prefill_calls >= 2
    assert eng.prefill_tokens == sum(r.attrs["tokens"] for r in pre) == sum(
        len(p) for p in PROMPTS)
    assert eng.prefill_padded_tokens == sum(r.attrs["computed"] for r in pre)


def test_request_stamps_order_and_the_submit_stamp_survives(model):
    eng = _engine(model, PagedEngine)
    early = Request(prompt_ids=PROMPTS[0], max_new_tokens=5)
    early.submit_time = 1.0  # an earlier stamp, as the HTTP server gives
    late = Request(prompt_ids=PROMPTS[1], max_new_tokens=5)
    eng.run([early, late])
    assert early.submit_time == 1.0 and late.submit_time == late.queued_time
    for r in (early, late):
        assert 0 < r.queued_time <= r.admit_time <= r.first_token_time <= r.finish_time


def test_admit_span_names_why_requests_were_left(model):
    # two slots for three requests: the third waits for a slot
    eng = _engine(model, Engine)
    with profiler():
        eng.run([Request(prompt_ids=p, max_new_tokens=5) for p in PROMPTS[:3]])
    first = by_name("kt.engine.admit")[0]
    assert first.attrs["left"] == 1 and first.attrs["why"] == "no_slot"
    # a pool of four 8-token pages holds one 20-token lifetime at a time
    profiling.clear_spans()
    eng = _engine(model, PagedEngine, n_pages=5, reserve_growth=True)
    with profiler():
        eng.run([Request(prompt_ids=p, max_new_tokens=8) for p in PROMPTS[2:4]])
    first = by_name("kt.engine.admit")[0]
    assert first.attrs["left"] == 1 and first.attrs["why"] == "no_pages"
    waits = [w for r in by_name("kt.engine.admit") for w in r.attrs["waits"]]
    assert len(waits) == 2 and waits[1] > waits[0]


def test_chunk_span_counts_the_pool_pages(model):
    eng = _engine(model, PagedEngine)
    with profiler():
        eng.run([Request(prompt_ids=p, max_new_tokens=10) for p in PROMPTS[:2]])
    chunks = by_name("kt.engine.chunk")
    assert chunks
    for c in chunks:
        a = c.attrs
        assert a["pool"] == eng._pool_pages
        assert 0 < a["pages_held"] <= a["pages_allocated"] <= a["pool"]
        assert a["pages_growth"] >= 0
    # the first chunk: 3 and 2 tokens cached, each on one page; the chunk's
    # 4 steps fit those pages. Growth as admission counts it: from the
    # chunk's end (8 and 7 tokens) by the 9 tokens still to come, plus one:
    # 18 and 17 tokens, three pages each, two more than held
    first = chunks[0].attrs
    assert (first["pages_held"], first["pages_allocated"], first["pages_growth"]) == (2, 2, 4)


def test_a_chunked_wave_gives_a_prefill_span_a_chunk(model):
    eng = _engine(model, PagedEngine, prefill_chunk=8, admit_chunk=2)
    with profiler():
        eng.run([Request(prompt_ids=PROMPTS[2], max_new_tokens=3)])
    pre = by_name("kt.engine.prefill")
    assert [r.attrs["start"] for r in pre] == [0, 8, 16]
    assert [r.attrs["tokens"] for r in pre] == [8, 8, 4]
    assert all(r.attrs["computed"] == 2 * 8 for r in pre)


def test_an_untraced_run_records_nothing(model):
    eng = _engine(model, PagedEngine)
    eng.run([Request(prompt_ids=p, max_new_tokens=5) for p in PROMPTS])
    Generator(model[0], model[1], cache_len=64, chunk=4).generate_batch_ids(
        [PROMPTS[0]], max_new_tokens=6)
    assert profiling.spans() == []


def test_chrome_trace_nests_the_engine_spans_inside_the_step(model, tmp_path):
    eng = _engine(model, PagedEngine)
    with profiling.trace(str(tmp_path)):
        eng.run([Request(prompt_ids=p, max_new_tokens=5) for p in PROMPTS])
    with open(tmp_path / "trace.json") as f:
        evs = [e for e in json.load(f)["traceEvents"]
               if str(e.get("name", "")).startswith("kt.engine.") and e.get("ph") == "X"]
    steps = [(e["ts"], e["ts"] + e["dur"]) for e in evs if e["name"] == "kt.engine.step"]
    inner = [e for e in evs if e["name"] != "kt.engine.step"]
    assert steps and {e["name"] for e in inner} == {
        "kt.engine.admit", "kt.engine.prefill", "kt.engine.sync", "kt.engine.chunk",
        "kt.engine.collect"}
    for e in inner:
        assert any(a <= e["ts"] and e["ts"] + e["dur"] <= b for a, b in steps), e


# ---- the Generator


@pytest.mark.parametrize("fused_step,route", [(False, "layered"), (True, "small")])
def test_generator_call_gives_the_span_tree(model, fused_step, route):
    cfg, params = model
    gen = Generator(cfg, fuse_params(params), cache_len=64, chunk=4,
                    fused_step=fused_step)
    prompts = [PROMPTS[0], PROMPTS[2]]
    with profiler():
        rows, _, _ = gen.generate_batch_ids(prompts, max_new_tokens=10)
    (req,) = by_name("kt.gen.request")
    names = [r.name for r in children(req)]
    assert names[:2] == ["kt.gen.prefill", "kt.gen.collect"]
    assert names[2:] == ["kt.gen.chunk", "kt.gen.sync", "kt.gen.collect"] * 3  # 9 tokens
    prefill = children(req)[0]
    assert [r.name for r in children(prefill)] == ["kt.gen.sync"]
    assert prefill.attrs["tokens"] == sum(len(p) for p in prompts)
    assert prefill.attrs["computed"] == 2 * req.attrs["T"] == 2 * 32
    assert prefill.attrs["graph"] == "eager" and prefill.attrs["key"][0] == "prefill"
    chunks = by_name("kt.gen.chunk")
    assert [c.attrs["steps"] for c in chunks] == [4, 4, 1]
    # B = 2 takes no megakernel; the route is what decode_chunk takes
    assert {c.attrs["route"] for c in chunks} == {"layered"}
    assert all(len(r) == 10 for r in rows)
    profiling.clear_spans()
    with profiler():
        gen.generate_batch_ids([PROMPTS[0]], max_new_tokens=6)
    assert {c.attrs["route"] for c in by_name("kt.gen.chunk")} == {route}
    assert all(r.ids == by_name("kt.gen.request")[0].ids for r in profiling.spans())


def test_chunk_route_takes_no_plan_unless_fused(model):
    _, params = model
    assert chunk_route(params, torch.float32, 256, False, True) == "layered"


# ---- the graph cache


def test_capture_span_names_the_key_and_the_recapture(monkeypatch):
    monkeypatch.setattr(graphs, "STEP_GRAPH", CpuGraph)
    cache = graphs.GraphCache("cpu")
    x = torch.zeros(4)

    def fn():
        x.add_(1)

    with profiler():
        modes = [graphs.run_once(cache, ("prefill", 4), fn, (x,)) for _ in range(2)]
        workspace.invalidate()  # the epoch moves: the key is captured again
        modes.append(graphs.run_once(cache, ("prefill", 4), fn, (x,)))
        modes.append(graphs.run_once(None, ("prefill", 4), fn, (x,)))
    assert modes == ["capture", "replay", "capture", "eager"]
    caps = by_name("kt.graph.capture")
    assert [c.attrs for c in caps] == [
        dict(key=("prefill", 4), prefill=True, recapture=False),
        dict(key=("prefill", 4), prefill=True, recapture=True)]
    # two eager first calls, a replay and an eager call (a capture runs none)
    assert np.array_equal(x.numpy(), np.full(4, 4.0))
