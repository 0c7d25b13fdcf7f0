"""Share of the engine's prefill work that is real prompt tokens: the
slice's `kt.engine.prefill` spans' prompt tokens over the tokens they
computed (rows padded to the slots, each to the bucket T), summed."""

from benchmark.harness import spans

LAYER = "step and prefill graphs (serving/graphs.py)"
UNIT = "%"
MOVES = "ttft_p95_ms.engine"
SOURCE = "program_counter"


def read(ctx):
    return spans.useful_share("kt.engine.prefill")[0]


def detail(ctx):
    return spans.useful_share("kt.engine.prefill")[1]
