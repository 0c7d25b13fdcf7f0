"""The whole step's share of the card's peak over the traced slice: for each
step of work in the slice (a prefill, a run of decode steps), the least time
the card could take, the larger of its model FLOPs over 989 TFLOP/s and the
bytes it must move over 3.35 TB/s (counts/<family>.py, counts/peaks.py),
summed, over the slice's wall time. Real tokens only: padding is waste."""

from benchmark.harness import readers

LAYER = "model step (models/decoder.py, models/paged.py)"
UNIT = "%"
MOVES = "output_tokens_per_s.b1"
SOURCE = "host_clock"


def read(ctx):
    return readers.step_mfu(ctx)


def detail(ctx):
    return {"bound": readers.step_bound(ctx)}
