"""The paged flash-decode kernel's share of its roofline in the traced slice:
the K/V bytes the slice's decode steps must read (each decoded token's
attended positions, times 56 KiB a position at Qwen2.5-7B's 28 layers x 4
kv heads x head_dim 128 in bf16), over 3.35 TB/s, over the device time of
the kernels named in KERNELS (csrc/paged_attention.cu)."""

from benchmark.harness import readers

LAYER = "kernels (csrc/*.cu)"
UNIT = "%"
MOVES = "tpot_p95_ms.engine"
SOURCE = "device_trace"
KERNELS = r"page_stats_kernel|merge_items_kernel"


def kv_bytes(ctx):
    ctx_sum = sum(st.decode_ctx for st in ctx.slice_steps())
    return ctx_sum * ctx.counts.kv_bytes_per_token(ctx.cell.config)


def read(ctx):
    return readers.roofline(ctx, kv_bytes(ctx), KERNELS)
