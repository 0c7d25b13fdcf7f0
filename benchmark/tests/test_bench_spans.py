"""The metrics that read the program's own spans (harness/spans.py), on a
hand-built slice and span list; a program without the recorder gives none
of them; and traced tiny runs on the CPU report them."""

import pytest

from benchmark.harness import readers, spans, trace
from benchmark.tests.conftest import run_cell
from kuiperllama_tpu_torch.utils import profiling


def _slice(device, host, length=10.0, counters=None):
    return trace.Slice(t0=0.0, t1=length, first=0, last=1, length_s=length,
                       device=list(device), host=list(host), counters=counters or {})


def _ctx(s):
    return readers.Context(None, type("R", (), {"slice": s, "steps": []})(), None)


def _rec(name, **attrs):
    return profiling.SpanRecord(name, 0, None, (), attrs)


@pytest.fixture
def records(monkeypatch):
    """Sets the program's span records."""
    def put(recs):
        monkeypatch.setattr(profiling, "spans", lambda: list(recs))
    return put


def test_queue_wait_is_the_mean_first_admission_wait(records):
    records([_rec("kt.engine.admit", waits=[0.1, 0.3], why="no_slot"),
             _rec("kt.engine.admit", waits=[], why=None),
             _rec("kt.engine.admit", waits=[0.2], why="no_pages"),
             _rec("kt.engine.chunk", waits=[9.0])])
    value, detail = spans.queue_wait(None)
    assert value == pytest.approx(200.0)
    assert detail == {"n": 3, "max_ms": pytest.approx(300.0), "admits": 3,
                      "no_slot": 1, "no_pages": 1}


def test_prefill_ms_adds_the_fetch_that_follows_each_prefill(records):
    host = [("kt.engine.step", 0.0, 9.0), ("kt.engine.admit", 0.0, 0.1),
            ("kt.engine.prefill", 0.1, 2.1), ("kt.engine.sync", 2.1, 2.3),
            ("kt.engine.chunk", 2.3, 3.0), ("kt.engine.sync", 3.0, 8.0),
            # a wave chunk with no fetch before the decode chunk
            ("kt.engine.prefill", 8.0, 8.5), ("kt.engine.chunk", 8.5, 8.6),
            ("kt.engine.sync", 8.6, 9.0), ("aten::mm", 0.2, 0.3)]
    records([_rec("kt.engine.prefill", T=2048, rows=32, graph="replay"),
             _rec("kt.engine.prefill", T=256, rows=32, graph="capture")])
    value, detail = spans.prefill_ms(_ctx(_slice([], host)))
    assert value == pytest.approx((2.2 + 0.5) / 2 * 1e3)
    assert detail == {"n": 2, "T": {"2048": 1, "256": 1}, "rows": {"32": 2},
                      "graph": {"capture": 1, "replay": 1}}


@pytest.mark.parametrize("name", ["kt.engine.prefill", "kt.gen.prefill"])
def test_useful_share_is_real_over_computed_tokens(records, name):
    records([_rec(name, tokens=600, computed=32 * 1024),
             _rec(name, tokens=40, computed=32 * 64),
             _rec("kt.other", tokens=1, computed=1)])
    value, detail = spans.useful_share(name)
    assert value == pytest.approx(100.0 * 640 / (32 * 1088))
    assert detail == {"n": 2, "tokens": 640, "computed": 32 * 1088}


def test_page_use_is_held_over_allocated_and_growth(records):
    records([_rec("kt.engine.chunk", pages_held=6, pages_allocated=8, pages_growth=4,
                  pool=100),
             _rec("kt.engine.chunk", pages_held=9, pages_allocated=9, pages_growth=0,
                  pool=100),
             _rec("kt.engine.chunk", steps=4)])  # a dense engine's chunk
    value, detail = spans.page_use(None)
    assert value == pytest.approx(100.0 * (0.5 + 1.0) / 2)
    assert detail == {"n": 2, "growth_pct_of_pool": pytest.approx(2.0),
                      "allocated_pct_of_pool": pytest.approx(8.5)}


def test_program_idle_splits_the_idle_time_by_innermost_span():
    # idle: (1, 2) under the sync, (3, 9) under the step, (9, 10) outside
    s = _slice([("k", 0.0, 1.0), ("k", 2.0, 3.0)],
               [("kt.engine.step", 0.5, 9.0), ("kt.engine.sync", 1.0, 2.0),
                ("cudaGraphLaunch", 9.2, 9.4)])
    value, detail = spans.program_idle(_ctx(s))
    assert readers.device_idle(_ctx(s)) == pytest.approx(80.0)
    assert value == pytest.approx(70.0) and value <= detail["device_idle_pct"]
    assert detail["n"] == 2
    assert detail["idle_s"] == pytest.approx({"kt.engine.step": 6.0,
                                              "kt.engine.sync": 1.0, "outside": 1.0})


def test_program_idle_is_left_out_with_device_idle():
    lost = _slice([("fused_decode_kernel", 0, 1)], [("kt.gen.request", 0, 10)],
                  counters={"fused_decode_step": 3})
    assert spans.program_idle(_ctx(lost)) == (None, {})
    bare = _slice([("k", 0, 1)], [("cudaGraphLaunch", 0, 10)])  # no program span
    assert spans.program_idle(_ctx(bare)) == (None, {})


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    assert spans.records("kt.engine.admit") == []
    assert spans.queue_wait(None)[0] is None
    assert spans.useful_share("kt.gen.prefill")[0] is None
    assert spans.page_use(None)[0] is None
    s = _slice([("k", 0, 1)], [("aten::mm", 0, 1)])
    assert spans.prefill_ms(_ctx(s))[0] is None


@pytest.mark.parametrize("cell,names", [
    ("tiny-int8.serve", ["queue_wait_mean_ms.engine", "prefill_ms_mean.engine",
                         "prefill_useful_pct.engine", "kv_pages_used_pct.engine"]),
    ("tiny-bf16.chat-b1", ["prefill_useful_pct.b1"])])
def test_traced_tiny_runs_report_the_span_metrics(tiny_root, cell, names):
    rc, res = run_cell(tiny_root, cell, trace=1)
    assert rc == 0 and res["correct"]
    for n in names:
        m = res["metrics"][n]
        assert m["value"] > 0 and m["n"] > 0, (n, m)
    # the CPU has no device events: no idle share of either kind
    assert not any(k.startswith(("program_idle", "device_idle")) for k in res["metrics"])
