"""Share of the KV pages the engine holds for its slots that hold tokens:
at each decode chunk's launch in the slice (`kt.engine.chunk`), pages
holding cached tokens over pages allocated plus pages the occupied slots
may still claim (`_future_growth_pages`, which admission keeps free), mean.
Detail: how many chunks, and the shares of the pool claimed for growth and
allocated."""

from benchmark.harness import spans

LAYER = "KV cache (kvcache.py PageAllocator)"
UNIT = "%"
MOVES = "output_tokens_per_s.engine"
SOURCE = "program_counter"


def read(ctx):
    return spans.page_use(ctx)[0]


def detail(ctx):
    return spans.page_use(ctx)[1]
