"""Share of the traced slice with nothing running on the device: one minus
the union of the profiler's device events (kernels, copies, sets) over the
slice's length. Left out when the trace lost megakernel launches."""

from benchmark.harness import readers

LAYER = "device"
UNIT = "%"
MOVES = "tpot_p95_ms.engine"
SOURCE = "device_trace"


def read(ctx):
    return readers.device_idle(ctx)
