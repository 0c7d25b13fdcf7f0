#!/usr/bin/env python
"""The big-model megakernel at a changed 7B geometry. Port of
tools/exp_big.py.

Runs the Generator's decode (a 32-token prompt, --steps greedy tokens in one
chunk, best of 3 runs after a warm-up) at a modified geometry, e.g. hidden
padded 11008 -> 11264 (11008 = 2^8 x 43 has no mid-sized multiple of 128
among its divisors, 11264 = 2^10 x 11 tiles in halves), and prints the big
plan (`ops/kernels/fused_decode_big.py` `plan_big` at a 256-slot window),
tokens/s, the effective GB/s of the JAX tool's byte count (every weight
and scale but the embedding table, plus a 256-slot bf16 KV window) with
its share of the data sheet's bandwidth, and ms per step. Weights are
random INT8 at --group (default 64) with bf16 scales, fused.

The big route is opt-in, as in JAX: set KT_FUSED_BIG=1 (ops/tuning.py).
The route the decode took is read from the megakernels' launch counters
and printed, and the JSON carries it as `route`.

    KT_FUSED_BIG=1 python -m kuiperllama_tpu_torch.tools.exp_big
        [--model llama2-7b] [--hidden 11264] [--layers 32] [--steps 128]
        [--cache-len 1024] [--group 64] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..config import preset_config
from ..fuse import fuse_params
from ..ops.kernels.fused_decode_big import plan_big
from ..params import param_bytes, random_params_device
from ..quant import cast_scales
from ..serving.generate import Generator
from . import (HBM_SHEET_GBPS, add_device_arg, counted_launches, report, resolve_device,
               route_of)

PROMPT = list(range(5, 37))
KV_WINDOW = 256  # the JAX tool's KV bytes: a 256-slot bf16 window


def run(dev, cfg=None, model: str = "llama2-7b", hidden: int = 0, layers: int = 0,
        steps: int = 128, cache_len: int = 1024, group: int = 64) -> dict:
    before = counted_launches()
    cfg = cfg or preset_config(model, seq_len=max(cache_len, 256))
    over = {k: v for k, v in (("hidden_dim", hidden), ("n_layers", layers)) if v}
    if over:
        cfg = cfg.replace(**over)
    t0 = time.perf_counter()
    params = cast_scales(fuse_params(random_params_device(
        cfg, device=dev, quantize=True, dtype=torch.bfloat16, group_size=group)),
        torch.bfloat16)
    print(f"[exp] params {param_bytes(params) / 1e9:.2f} GB "
          f"({time.perf_counter() - t0:.0f}s)", file=sys.stderr)
    plan = plan_big(params["blocks"], torch.bfloat16, KV_WINDOW)
    print(f"[exp] plan: {plan}", file=sys.stderr)

    gen = Generator(cfg, params, cache_len=cache_len, cache_dtype=torch.bfloat16,
                    chunk=steps)
    gen.generate_batch_ids([PROMPT], max_new_tokens=8)
    n0 = counted_launches()
    runs = []
    for _ in range(3):
        rows, _, decode_s = gen.generate_batch_ids([PROMPT], max_new_tokens=steps)
        runs.append(sum(len(r) for r in rows) / decode_s)
        print(f"[exp] {runs[-1]:.1f} tok/s", file=sys.stderr)
    n1 = counted_launches()
    route = route_of({k: n1[k] - n0[k] for k in n1})
    best = max(runs)
    bpt = param_bytes(params) - params["tok_emb"].numel() * 2
    kv = cfg.n_layers * KV_WINDOW * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    gbps = (bpt + kv) * best / 1e9
    print(f"tok/s {best:.2f}  effective {gbps:.1f} GB/s  step {1e3 / best:.2f} ms"
          f"  route {route}")
    return report(dev, dict(
        tool="exp_big", model=model, hidden_dim=cfg.hidden_dim,
        n_layers=cfg.n_layers, group_size=group, scales_dtype="bfloat16",
        steps=steps, cache_len=cache_len, plan=plan, route=route,
        tok_s=best, tok_s_runs=runs, effective_GBps=gbps,
        pct_of_sheet_bw=100 * gbps / HBM_SHEET_GBPS, ms_per_step=1e3 / best,
        bytes_per_step=bpt + kv), before)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(ap)
    ap.add_argument("--model", default="llama2-7b")
    ap.add_argument("--hidden", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--cache-len", type=int, default=1024)
    ap.add_argument("--group", type=int, default=64)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    return run(dev, model=args.model, hidden=args.hidden, layers=args.layers,
               steps=args.steps, cache_len=args.cache_len, group=args.group)


if __name__ == "__main__":
    main()
