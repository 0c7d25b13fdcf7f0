#!/usr/bin/env python
"""Decode-step time breakdown: each projection's INT8 matmul alone against
the whole step. Port of tools/profile_decode.py.

1. Each of the five projection shapes (wqkv, wo, w13, w2, lm_head; g 64,
   fp32 scales) at M = --batch through the port's routing
   (`ops/linear.py` `quant_kernel`): us and GB/s of one call
   (`bench_kernels.bench_quant_shape`: CUDA events, weight copies rotated
   past L2), the kernel the shape took, and the layers' sum.
2. The whole `decoder.decode_step` (random INT8 weights, fused, bf16
   activations and cache of --cache-len slots, token 0 at pos 17), two
   ways: eagerly ("full decode_step"), and as one replay of a CUDA graph of
   the step (serving/graphs.py), the port's counterpart of the JAX tool's
   "donated decode_step": the port writes its cache in place, and a replay
   is its one-dispatch form. Each step is timed between CUDA events, host
   gaps included; both greedy tokens must be equal.

Notice the route: TinyLlama's w2 at g 64 has 88 groups, over the GEMV's cap
of 64 (`ops/linear.py` GEMV_MAX_GROUPS), so at one row it takes the GEMM.

    python -m kuiperllama_tpu_torch.tools.profile_decode [--model tinyllama-1.1b]
        [--batch 1] [--cache-len 1024] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import statistics

import torch

from ..config import preset_config
from ..fuse import fuse_params
from ..models import decoder
from ..ops.linear import takes_gemv
from ..params import random_params_device
from ..serving.graphs import run_once
from ..utils.profiling import event_times
from . import (HBM_SHEET_GBPS, HBM_SHEET_SOURCE, add_device_arg, counted_launches,
               graph_cache, projection_shapes, report, resolve_device)
from .bench_kernels import bench_quant_shape

GROUP = 64
STEP_ITERS = 30  # the JAX tool's timed steps
POS = 17


def microbench(dev, cfg, B: int) -> tuple:
    """({shape: row}, the layers' summed ms) at M = B."""
    rows, total_layer = {}, 0.0
    print(f"== quant_matmul microbench (M={B}) ==")
    for name, (K, N) in projection_shapes(cfg).items():
        gbps, dt = bench_quant_shape(dev, K, N, B, group_size=GROUP)
        kernel = "gemv" if takes_gemv(B, K, GROUP) else "gemm"
        per_layer = ""
        if name != "lm_head":
            total_layer += dt * cfg.n_layers
            per_layer = f"  x{cfg.n_layers} = {dt * 1e6 * cfg.n_layers:8.0f}us"
        print(f"  {name:8s} [{K:5d},{N:5d}]  {kernel}  {dt * 1e6:7.1f}us  "
              f"{gbps:6.0f} GB/s ({100 * gbps / HBM_SHEET_GBPS:3.0f}% of the "
              f"data sheet){per_layer}")
        rows[name] = dict(K=K, N=N, kernel=kernel, us=dt * 1e6, GBps=gbps,
                          pct_of_sheet_bw=100 * gbps / HBM_SHEET_GBPS)
    print(f"  sum(layers) + lm_head = {total_layer * 1e3:.2f}ms + above")
    return rows, total_layer * 1e3


def run(dev, cfg=None, model: str = "tinyllama-1.1b", batch: int = 1,
        cache_len: int = 1024, iters: int = STEP_ITERS) -> dict:
    before = counted_launches()
    cfg = cfg or preset_config(model, seq_len=cache_len)
    B = batch
    shapes, sum_layers_ms = microbench(dev, cfg, B)

    params = fuse_params(random_params_device(cfg, device=dev, quantize=True,
                                              dtype=torch.bfloat16))
    cache = decoder.init_kv_cache(cfg, batch=B, max_len=cache_len,
                                  dtype=torch.bfloat16, device=dev)
    rope = decoder.build_rope(cfg, dev)
    token = torch.zeros((B,), dtype=torch.int32, device=dev)
    pos = torch.full((B,), POS, dtype=torch.int32, device=dev)
    nxt = torch.zeros((B,), dtype=torch.int32, device=dev)

    def step():
        logits, _ = decoder.decode_step(cfg, params, token, pos, cache, rope=rope)
        nxt.copy_(torch.argmax(logits, dim=-1).to(torch.int32))

    step()  # builds the kernels
    full = statistics.mean(event_times(step, iters, dev))
    eager_tokens = nxt.tolist()
    print(f"== full decode_step: {full * 1e3:.2f}ms  ({1 / full:.0f} tok/s/B, B={B})")

    graphs = graph_cache(dev)
    static = (token, pos, nxt, cache["k"], cache["v"], *rope)
    replay = lambda: run_once(graphs, ("decode_step", B), step, static)  # noqa: E731
    nxt.zero_()
    replay()  # eager run and capture
    donated = statistics.mean(event_times(replay, iters, dev))
    print(f"== donated decode_step: {donated * 1e3:.2f}ms  (the port: one "
          f"{'CUDA-graph replay' if graphs else 'eager step, no graphs on the CPU'})")
    return report(dev, dict(
        tool="profile_decode", model=model, batch=B, cache_len=cache_len,
        group_size=GROUP, bandwidth_share_of=HBM_SHEET_SOURCE, shapes=shapes,
        sum_layers_ms=sum_layers_ms, full_decode_step_ms=full * 1e3,
        tok_s_per_row=1 / full, donated_decode_step_ms=donated * 1e3,
        donated_is_graph_replay=graphs is not None,
        eager_tokens=eager_tokens, replay_tokens=nxt.tolist(),
        tokens_equal=eager_tokens == nxt.tolist()), before)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(ap)
    ap.add_argument("--model", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--cache-len", type=int, default=1024)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    return run(dev, model=args.model, batch=args.batch, cache_len=args.cache_len)


if __name__ == "__main__":
    main()
