"""Mean number of requests that decoded in each engine step of the window,
read by the harness around `PagedEngine.step()` from each request's tokens."""

from benchmark.harness import readers

LAYER = "engine scheduler (serving/engine.py PagedEngine)"
UNIT = "requests"
MOVES = "tpot_p95_ms.engine"
SOURCE = "program_counter"


def read(ctx):
    return readers.mean_active(ctx)
