"""How long an engine prefill holds the host: each `kt.engine.prefill` span
in the slice plus the `kt.engine.sync` that fetches its first tokens, mean,
on the profiler's host clock. Detail: how many, and by the prefills' span
attributes their lengths T, padded rows, and graph replays or captures."""

from benchmark.harness import spans

LAYER = "step and prefill graphs (serving/graphs.py)"
UNIT = "ms"
MOVES = "ttft_p95_ms.engine"
SOURCE = "host_clock"


def read(ctx):
    return spans.prefill_ms(ctx)[0]


def detail(ctx):
    return spans.prefill_ms(ctx)[1]
