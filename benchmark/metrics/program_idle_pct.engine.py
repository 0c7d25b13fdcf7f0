"""Share of the traced slice with nothing running on the device while the
host is inside one of the program's spans (`kt.*`): `device_idle_pct`
less the idle time outside every program span, so never above it. Left out
where `device_idle_pct` is. Detail: the idle seconds by the innermost
program span over them, and outside every one."""

from benchmark.harness import spans

LAYER = "device"
UNIT = "%"
MOVES = "tpot_p95_ms.engine"
SOURCE = "device_trace"


def read(ctx):
    return spans.program_idle(ctx)[0]


def detail(ctx):
    return spans.program_idle(ctx)[1]
