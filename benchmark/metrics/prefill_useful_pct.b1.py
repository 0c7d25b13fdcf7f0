"""Share of the Generator's prefill work that is real prompt tokens: the
slice's `kt.gen.prefill` spans' prompt tokens over the tokens they computed
(each prompt padded to its power-of-two bucket), summed."""

from benchmark.harness import spans

LAYER = "Generator route (serving/generate.py)"
UNIT = "%"
MOVES = "ttft_p95_ms.b1"
SOURCE = "program_counter"


def read(ctx):
    return spans.useful_share("kt.gen.prefill")[0]


def detail(ctx):
    return spans.useful_share("kt.gen.prefill")[1]
