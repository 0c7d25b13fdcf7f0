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
