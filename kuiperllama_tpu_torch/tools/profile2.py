#!/usr/bin/env python
"""Decode-step profiling by chained calls. Port of tools/profile2.py.

The JAX tool times `iters` serially dependent calls inside one jitted
lax.scan, so that neither dispatch nor pipelining distorts the numbers. The
port's counterpart is one CUDA graph of the same `iters` dependent calls,
replayed and timed by CUDA events (`tools.chain_time`):
  1. each projection shape's INT8 matmul (g 64, fp32 scales; M = --batch,
     through `ops/linear.py`'s routing), fed back as
     x = x * 0.999 + sum(y) * 1e-9; weight copies rotate through the chain
     so that together they exceed twice the 50 MB L2, as the TPU re-reads
     its weights from HBM. us, GB/s and the share of the data sheet's
     bandwidth per call, the kernel each shape took, the layers' sum;
  2. the decode step per token through `serving/generate.py` `decode_chunk`
     (random weights, fused; layered, on the graph route: a chunk of
     --iters steps is as many replays), the best of 3 chunks timed by CUDA
     events, against the weight stream (`params.param_bytes`, as the JAX
     tool counts it) over the data sheet's bandwidth;
  3. --trace DIR: a torch.profiler trace of an 8-step chunk, written to
     DIR/trace.json (`utils/profiling.py` `trace`), the counterpart of
     jax.profiler.trace.

    python -m kuiperllama_tpu_torch.tools.profile2 [--model tinyllama-1.1b]
        [--batch 1] [--cache-len 1024] [--iters 64] [--trace DIR] [--fp]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import torch

from ..config import preset_config
from ..fuse import fuse_params
from ..models import decoder
from ..ops.linear import linear, takes_gemv
from ..params import param_bytes, random_params_device
from ..quant import quantize_q80
from ..serving.generate import decode_chunk
from ..utils.profiling import event_times, l2_copies, trace
from . import (HBM_SHEET_GBPS, HBM_SHEET_SOURCE, add_device_arg, chain_time,
               counted_launches, decode_state, graph_cache, projection_shapes,
               report, resolve_device)

GROUP = 64
POS = 17
TRACE_STEPS = 8


def feedback(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The next x of a chain: x * 0.999 + sum(y) * 1e-9 (the JAX tools'
    feedback, which makes each call depend on the last at no cost)."""
    return (x * 0.999 + y.float().sum(dim=-1, keepdim=True) * 1e-9).to(x.dtype)


def chained_matmuls(dev, cfg, B: int, iters: int) -> dict:
    """Per projection shape: one call's time in a graph-chained run."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = {}
    for name, (K, N) in projection_shapes(cfg).items():
        w = quantize_q80(torch.randn((K, N), generator=gen, device=dev), GROUP)
        nbytes = K * N + (K // GROUP) * N * 4
        ws = [w] + [quantize_q80(torch.randn((K, N), generator=gen, device=dev), GROUP)
                    for _ in range(l2_copies(nbytes, dev) - 1)]
        x0 = torch.randn((B, K), generator=gen, device=dev).to(torch.bfloat16)
        dt, _ = chain_time(lambda x, i: feedback(linear(x, ws[i % len(ws)]), x),
                           x0, iters, graphs=graph_cache(dev))
        rows[name] = dict(K=K, N=N, kernel="gemv" if takes_gemv(B, K, GROUP) else "gemm",
                          us=dt * 1e6, GBps=nbytes / dt / 1e9,
                          pct_of_sheet_bw=100 * nbytes / dt / 1e9 / HBM_SHEET_GBPS,
                          weight_copies=len(ws))
        del ws
    return rows


def layered_chunk(dev, cfg, params, cache_len: int, B: int, width: int):
    """A function chunk(n) that runs n <= width greedy layered decode steps
    (`serving/generate.py` `decode_chunk`) from token 0 at pos 17 over a
    bf16 cache of `cache_len` slots, every step a replay of the step's CUDA
    graph on the card. Each chunk rewrites the same slots, so the cache
    needs no reset."""
    cache = decoder.init_kv_cache(cfg, batch=B, max_len=cache_len,
                                  dtype=torch.bfloat16, device=dev)
    rope = decoder.build_rope(cfg, dev)
    state = decode_state(B, dev, width)
    graphs = graph_cache(dev)

    def chunk(n: int):
        state.token.zero_()
        state.pos.fill_(POS)
        state.done.zero_()
        decode_chunk(cfg, params, state, cache, None, n, rope=rope,
                     drop_past_end=False, graphs=graphs)

    return chunk


def time_chunk(dev, chunk, steps: int) -> float:
    """Seconds per step of `chunk(steps)`: the best of 3 chunks between CUDA
    events, after one that captures the step."""
    chunk(steps)
    return min(event_times(lambda: chunk(steps), 3, dev)) / steps


def run(dev, cfg=None, model: str = "tinyllama-1.1b", batch: int = 1,
        cache_len: int = 1024, iters: int = 64, trace_dir=None,
        fp: bool = False) -> dict:
    before = counted_launches()
    cfg = cfg or preset_config(model, seq_len=cache_len)
    B = batch
    print(f"== chained quant_matmul (B={B}) ==")
    shapes = chained_matmuls(dev, cfg, B, iters)
    total_layer = 0.0
    for name, r in shapes.items():
        mark = ""
        if name != "lm_head":
            total_layer += r["us"] * 1e-6 * cfg.n_layers
            mark = f"  x{cfg.n_layers} = {r['us'] * cfg.n_layers:7.0f}us"
        print(f"  {name:8s} [{r['K']:5d},{r['N']:5d}]  {r['kernel']}  {r['us']:7.1f}us  "
              f"{r['GBps']:5.0f} GB/s ({r['pct_of_sheet_bw']:3.0f}% of the data "
              f"sheet){mark}")
    print(f"  sum(layers) = {total_layer * 1e3:.2f}ms + lm_head")

    params = fuse_params(random_params_device(cfg, device=dev, quantize=not fp,
                                              dtype=torch.bfloat16))
    wbytes = param_bytes(params)
    chunk = layered_chunk(dev, cfg, params, cache_len, B, iters)
    dt = time_chunk(dev, chunk, iters)
    ideal = wbytes / HBM_SHEET_GBPS / 1e9
    print(f"== decode_chunk/step: {dt * 1e3:.3f}ms  ({B / dt:.0f} tok/s)  "
          f"weights {wbytes / 1e9:.2f} GB -> roofline {ideal * 1e3:.3f}ms "
          f"({100 * ideal / dt:.0f}% of roofline at the data sheet's bandwidth)")
    trace_file = None
    if trace_dir:
        with trace(trace_dir):
            chunk(TRACE_STEPS)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        trace_file = os.path.join(trace_dir, "trace.json")
        print(f"trace written to {trace_file}")
    return report(dev, dict(
        tool="profile2", model=model, batch=B, cache_len=cache_len, iters=iters,
        fp=fp, group_size=GROUP, bandwidth_share_of=HBM_SHEET_SOURCE, shapes=shapes,
        sum_layers_ms=total_layer * 1e3, decode_chunk_ms_per_step=dt * 1e3,
        tok_s=B / dt, weight_bytes=wbytes, roofline_ms=ideal * 1e3,
        pct_of_roofline=100 * ideal / dt, graphs=dev.type == "cuda",
        trace=trace_file), before)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(ap)
    ap.add_argument("--model", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--cache-len", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=64)
    ap.add_argument("--trace", default=None, help="write a torch.profiler trace here")
    ap.add_argument("--fp", action="store_true", help="bf16 weights, no quant")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    return run(dev, model=args.model, batch=args.batch, cache_len=args.cache_len,
               iters=args.iters, trace_dir=args.trace, fp=args.fp)


if __name__ == "__main__":
    main()
