"""The traced slice's arithmetic: busy time as a union, idle gaps and their
names, kernel time by pattern, and the lost-launch guard."""

import re

from benchmark.harness import readers, trace


def _slice(device, host=(), length=10.0, counters=None):
    return trace.Slice(t0=0.0, t1=length, first=0, last=1, length_s=length,
                       device=list(device), host=list(host), counters=counters or {})


def test_busy_is_the_union_of_device_intervals():
    assert trace.union_seconds([(0, 2), (1, 3), (5, 6), (5.5, 5.6)]) == 4.0
    s = _slice([("a", 0, 2), ("b", 1, 3), ("c", 5, 6)])
    assert trace.busy_seconds(s) == 4.0
    assert trace.gaps([(0, 2), (1, 3), (5, 6)], 0, 10) == [(3, 5), (6, 10)]


def test_kernel_time_by_pattern_and_breakdown():
    s = _slice([("void gemv_kernel<bf16>", 0, 1), ("gemm_tma_kernel<32, 2>", 1, 1.5),
                ("elementwise", 2, 2.25)],
               host=[("bench.step", 0, 10), ("cudaGraphLaunch", 6.0, 6.5)])
    assert trace.device_seconds(s, re.compile(r"gemv_kernel|gemm_tma_kernel")) == 1.5
    b = trace.breakdown(s)
    assert b["device_ops"][0] == ["void gemv_kernel<bf16>", 1.0]
    # gaps longest first, each named by the innermost host event over its middle
    assert b["idle_gaps"] == [["cudaGraphLaunch", 7.75], ["bench.step", 0.5]]


def test_device_metrics_are_dropped_when_the_trace_lost_launches():
    ok = _slice([("fused_decode_kernel", 0, 1)] * 3, counters={"fused_decode_step": 3})
    lost = _slice([("fused_decode_kernel", 0, 1)] * 2, counters={"fused_decode_step": 3})
    assert not readers.lost_launches(ok) and readers.lost_launches(lost)
    run = type("R", (), {"slice": lost, "steps": []})()
    assert readers.device_idle(readers.Context(None, run, None)) is None
