#!/usr/bin/env python
"""Decode-step ablation at chunk granularity. Port of tools/exp_ablate.py.

Every measurement is a whole chunk of dependent work on a CUDA graph, so
that host dispatch drops out (the JAX tool's jitted lax.scan):
  * per projection shape, one INT8 matmul's us and GB/s in a graph-chained
    run of 64 calls (`profile2.chained_matmuls`, `tools.chain_time`);
  * the INT8 layered decode chunk (`serving/generate.py` `decode_chunk`,
    --steps steps, each a replay of the step's graph) at cache lengths 256,
    1024 and 2048: what attention over the cache costs;
  * bf16 dense weights at cache 1024: the INT8 kernels against twice the
    bytes through cuBLAS;
  * a 2048-entry vocabulary at cache 1024: the lm_head's and the sampling's
    share.
A chunk is timed between CUDA events, the best of 3 after the graph's
capture. Weight bytes per token count each leaf's own itemsize
(`params.param_bytes`: int8 payloads, fp32 scales as `random_params_device`
makes them, the bf16 embedding table), and the roofline is their stream
over the data sheet's bandwidth.

    python -m kuiperllama_tpu_torch.tools.exp_ablate [--model tinyllama-1.1b]
        [--batch 1] [--steps 64] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import torch

from ..config import preset_config
from ..fuse import fuse_params
from ..params import param_bytes, random_params_device
from . import (HBM_SHEET_GBPS, HBM_SHEET_SOURCE, add_device_arg, counted_launches,
               report, resolve_device)
from .profile2 import chained_matmuls, layered_chunk, time_chunk

CACHE_LENS = (256, 1024, 2048)
SMALL_VOCAB = 2048
CHAIN_ITERS = 64


def bench_chunk(dev, cfg, params, cache_len: int, steps: int, B: int) -> float:
    """Seconds per step of a greedy `steps`-step layered chunk from pos 17
    over a cache of `cache_len` slots: the best of 3 chunks."""
    return time_chunk(dev, layered_chunk(dev, cfg, params, cache_len, B, steps), steps)


def run(dev, cfg=None, model: str = "tinyllama-1.1b", batch: int = 1,
        steps: int = 64) -> dict:
    before = counted_launches()
    B = batch
    cfg = cfg or preset_config(model, seq_len=max(CACHE_LENS))
    print(f"== quant_matmul graph-chained (M={B}, {CHAIN_ITERS} iters) ==")
    shapes = chained_matmuls(dev, cfg, B, CHAIN_ITERS)
    for name, r in shapes.items():
        print(f"  {name:8s} [{r['K']:5d},{r['N']:5d}]  {r['us']:7.1f}us  "
              f"{r['GBps']:6.0f} GB/s")

    def int8(c):
        return fuse_params(random_params_device(c, device=dev, quantize=True,
                                                dtype=torch.bfloat16))

    params = int8(cfg)
    wbytes = param_bytes(params)
    roofline = HBM_SHEET_GBPS * 1e9 / wbytes
    print(f"weight bytes/token: {wbytes / 1e9:.3f} GB  (roofline at the data "
          f"sheet's {HBM_SHEET_GBPS:.0f} GB/s: {roofline:.0f} tok/s)")
    int8_chunk = {}
    for cache_len in CACHE_LENS:
        dt = bench_chunk(dev, cfg, params, cache_len, steps, B)
        int8_chunk[cache_len] = dict(ms_per_token=dt * 1e3, tok_s=B / dt,
                                     effective_GBps=wbytes / dt / 1e9)
        print(f"int8 chunk  cache={cache_len:5d}  {dt * 1e3:7.3f} ms/tok  "
              f"{B / dt:6.0f} tok/s  {wbytes / dt / 1e9:5.0f} GB/s eff")
    del params

    pf = fuse_params(random_params_device(cfg, device=dev, quantize=False,
                                          dtype=torch.bfloat16))
    wb = param_bytes(pf)
    dt = bench_chunk(dev, cfg, pf, 1024, steps, B)
    bf16_chunk = dict(cache_len=1024, ms_per_token=dt * 1e3, tok_s=B / dt,
                      effective_GBps=wb / dt / 1e9, weight_bytes=wb)
    print(f"bf16 chunk  cache= 1024  {dt * 1e3:7.3f} ms/tok  {B / dt:6.0f} tok/s  "
          f"{wb / dt / 1e9:5.0f} GB/s eff ({wb / 1e9:.2f} GB/tok)")
    del pf

    cfg_sv = cfg.replace(vocab_size=SMALL_VOCAB)
    dt = bench_chunk(dev, cfg_sv, int8(cfg_sv), 1024, steps, B)
    small_vocab_chunk = dict(cache_len=1024, vocab_size=SMALL_VOCAB,
                             ms_per_token=dt * 1e3, tok_s=B / dt)
    print(f"int8 tiny-vocab cache=1024  {dt * 1e3:7.3f} ms/tok  {B / dt:6.0f} tok/s")
    return report(dev, dict(
        tool="exp_ablate", model=model, batch=B, steps=steps,
        bandwidth_share_of=HBM_SHEET_SOURCE, shapes=shapes,
        weight_bytes_per_token=wbytes, roofline_tok_s=roofline,
        int8_chunk=int8_chunk, bf16_chunk=bf16_chunk,
        small_vocab_chunk=small_vocab_chunk, graphs=dev.type == "cuda"), before)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(ap)
    ap.add_argument("--model", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--steps", type=int, default=64)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    return run(dev, model=args.model, batch=args.batch, steps=args.steps)


if __name__ == "__main__":
    main()
