"""How late the open-loop generator submitted each request against its due
time, 95th percentile over the requests due in the window: a request due
while the engine is inside a step is submitted after it."""

from benchmark.harness import readers

LAYER = "load generator (benchmark/entries)"
UNIT = "ms"
MOVES = "ttft_p95_ms.engine"
SOURCE = "host_clock"


def read(ctx):
    return readers.send_lag_p95_ms(ctx)
