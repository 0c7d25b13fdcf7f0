"""How long the slice's admitted requests waited in the engine's queue:
each first admission's `admit_time - queued_time` (`submit()` to the
`kt.engine.admit` span that took it into a slot), mean. Apart from the
load generator's lag, which `submit_time` carries. Detail: how many, the
longest, and how many admissions left requests queued for want of a slot
(`no_slot`) or of KV pages (`no_pages`)."""

from benchmark.harness import spans

LAYER = "engine scheduler (serving/engine.py PagedEngine)"
UNIT = "ms"
MOVES = "ttft_p95_ms.engine"
SOURCE = "program_counter"


def read(ctx):
    return spans.queue_wait(ctx)[0]


def detail(ctx):
    return spans.queue_wait(ctx)[1]
