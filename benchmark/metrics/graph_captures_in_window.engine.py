"""CUDA-graph captures (decode and prefill, `GraphCache.stats()`) during
the window: 0 when set-up warmed every key the window's traffic uses."""

LAYER = "step and prefill graphs (serving/graphs.py)"
UNIT = "captures"
MOVES = "ttft_p95_ms.engine"
SOURCE = "program_counter"


def read(ctx):
    return ctx.run.extra["graph_captures"]
