"""The engine driver's window: the traffic starts `lead_in_s` before it,
the requests due before it opens are served but not counted, and every
time is read from the window's start."""

import torch

from benchmark.harness import spec, trace
from benchmark.harness.main import Setup


def test_the_window_opens_after_the_lead_in_on_a_loaded_engine(tiny_root):
    cell = spec.load_cell("tiny-int8.serve", tiny_root)
    assert cell.traffic["lead_in_s"] == 0.5
    seconds = 1.0
    tracer = trace.Tracer(False, seconds)
    su = Setup(cell, 2 ** 31 + 5, seconds, torch.device("cpu"), tracer)
    run = su.drive(seconds, tracer)
    lead = run.extra["lead_in"]
    assert lead and all(r.due < 0 for r in lead)
    assert run.reqs and all(r.due >= 0 for r in run.reqs)
    # the lead-in's requests are served, some of them inside the window
    assert all(r.finish is not None for r in lead)
    assert any(r.finish > 0 for r in lead)
    assert run.steps and run.steps[0].t0 >= 0 and run.window_s >= seconds
    assert abs(run.steps[-1].t1 - run.window_s) < 1e-9
    assert run.extra["completed"] >= sum(
        1 for r in run.reqs if r.finish is not None and r.finish <= run.window_s)
    assert all(r.first is not None and r.first >= r.due for r in run.reqs)


def test_the_packed_warm_up_fills_each_bucket_above_one_prompts():
    from benchmark.entries.engine import packed_plan

    assert packed_plan(2048, 0, 32, 2048) == []
    plan = packed_plan(2048, 32768, 32, 2045)
    assert [sum(lens) for lens in plan] == [32768, 16384, 8192, 4096]
    assert all(max(lens) <= 2045 and len(lens) == -(-sum(lens) // 2045) for lens in plan)
    # a bucket that needs more prompts than slots is left out, with all above
    assert [sum(lens) for lens in packed_plan(128, 1024, 4, 100)] == [256]


def test_the_warm_up_admits_the_packed_streams_together(tiny_root, monkeypatch):
    from kuiperllama_tpu_torch.serving.engine import PagedEngine

    seen = []
    prefill = PagedEngine._prefill_packed

    def spy(self, slots, ids, n, sp):
        seen.append((n, [len(i) for i in ids]))
        return prefill(self, slots, ids, n, sp)

    monkeypatch.setattr(PagedEngine, "_prefill_packed", spy)
    cell = spec.load_cell("tiny-int8.serve", tiny_root)
    cell.traffic = dict(cell.traffic, warm_packed_tokens=1024)
    Setup(cell, 2 ** 31 + 5, 1.0, torch.device("cpu"), trace.Tracer(False, 1.0))
    assert [n for n, lens in seen if len(lens) > 1] == [256]
    assert [sum(lens) for n, lens in seen if n == 256] == [256]
    assert max(n for n, lens in seen if len(lens) == 1) == 128
