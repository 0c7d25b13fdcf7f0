"""The W8A16 weight-stream kernels' share of their roofline in the traced
slice: the INT8 weight and scale bytes the slice's decode steps must read
(every projection and the lm_head once a step, counted from shapes), over
3.35 TB/s, over the device time of the kernels named in KERNELS
(csrc/quant_gemv.cu, csrc/quant_gemm.cu with reduce_splits). Prefills that
use the same kernels add time and no bytes, so the share is a lower bound."""

from benchmark.harness import readers

LAYER = "kernels (csrc/*.cu)"
UNIT = "%"
MOVES = "tpot_p95_ms.engine"
SOURCE = "device_trace"
KERNELS = r"gemv_kernel|gemm_tma_kernel|gemm_fast_kernel|gemm_exact_kernel|reduce_splits"


def decode_steps(ctx):
    return sum(st.decode_steps for st in ctx.slice_steps())


def read(ctx):
    nbytes = decode_steps(ctx) * ctx.counts.int8_stream_bytes(ctx.cell.config)
    return readers.roofline(ctx, nbytes, KERNELS)
