#!/usr/bin/env python
"""Per-shape INT8 matmul bandwidth at a model's decode shapes.

Port of tools/bench_kernels.py. For each projection of the preset (wqkv,
wo, w13, w2, lm_head) one [M, K] x [K, N] INT8 matmul is timed by
`utils.profiling.device_time` (CUDA events, median call), rotating copies
of the weight so that together they exceed twice the 50 MB L2 (the card
caches what the TPU re-reads from HBM). Variants:
  kernel          the port's kernel as `ops/linear.py` routes it below 256
                  rows: the GEMV at 1 row with <= 64 groups, else the GEMM
  kernel-layered  `linear_layered` over a stacked [L, K, N] weight, layer
                  i % L (the decode step's path)
  torch           dequantize to bf16 then one bf16 matmul (JAX's xla variant)
Prints one JSON dict: per shape K, N, GB/s (weight and scale bytes) and us,
and over all five shapes the matmul time and GB/s of one decode token.
The TPU tile options --block-out / --block-in have no counterpart: the
card's kernels choose their own tiles.

    python -m kuiperllama_tpu_torch.tools.bench_kernels [--model llama2-7b]
        [--m 1] [--variant kernel|kernel-layered|torch] [--group-size 64]
        [--scales-dtype float32|bfloat16] [--layers 4] [--shapes wqkv,w2]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..config import preset_config
from ..ops.linear import _dequant_dot, linear_layered, quant_kernel
from ..quant import QuantTensor
from ..utils.profiling import device_time, l2_copies
from . import ITERS, add_device_arg, device_name, projection_shapes, resolve_device

VARIANTS = ("kernel", "kernel-layered", "torch")


def bench_quant_shape(dev, K, N, M, group_size=64, variant="kernel",
                      scales_dtype=torch.float32, n_layers=1):
    """(GB/s, seconds) of one call at [M, K] x [K, N]."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    L = n_layers if variant == "kernel-layered" else 1
    q = torch.randint(-127, 128, (L, K, N), generator=gen, device=dev,
                      dtype=torch.int8)
    s = torch.full((L, K // group_size, N), 1e-3, dtype=scales_dtype, device=dev)
    x = torch.ones((M, K), dtype=torch.bfloat16, device=dev)
    scale_bytes = s.element_size()
    copies = l2_copies(L * (K * N + (K // group_size) * N * scale_bytes), dev)
    stacks = [(q, s)] + [(q.clone(), s.clone()) for _ in range(copies - 1)]
    if variant == "kernel":
        variants = [(qq[0], ss[0]) for qq, ss in stacks]
        fn = lambda qq, ss: quant_kernel(x, qq, ss, group_size)  # noqa: E731
    elif variant == "kernel-layered":
        variants = [(QuantTensor(qq, ss, group_size), i)
                    for qq, ss in stacks for i in range(L)]
        fn = lambda w, i: linear_layered(x, w, i)  # noqa: E731
    elif variant == "torch":
        variants = [(qq[0], ss[0]) for qq, ss in stacks]
        fn = lambda qq, ss: _dequant_dot(x, QuantTensor(qq, ss, group_size))  # noqa: E731
    else:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    per = device_time(fn, variants=variants, iters=ITERS, device=dev.type)
    bytes_touched = K * N + (K // group_size) * N * scale_bytes
    return bytes_touched / per / 1e9, per


def run(dev, model="llama2-7b", m=1, group_size=64, variant="kernel",
        scales_dtype="float32", layers=4, shapes=None) -> dict:
    cfg = preset_config(model)
    table = projection_shapes(cfg)
    if shapes:
        keep = set(shapes.split(","))
        table = {k: v for k, v in table.items() if k in keep}
    out = {"model": model, "M": m, "variant": variant,
           "scales_dtype": scales_dtype, "device": device_name(dev)}
    sdt = getattr(torch, scales_dtype)
    sb = torch.empty((), dtype=sdt).element_size()
    total_bytes, total_time = 0.0, 0.0
    for name, (K, N) in table.items():
        gbps, per = bench_quant_shape(dev, K, N, m, group_size, variant, sdt,
                                      layers)
        out[name] = {"K": K, "N": N, "GBps": gbps, "us": per * 1e6}
        print(f"[{name}] K={K} N={N}: {gbps:.1f} GB/s  {per * 1e6:.1f} us",
              file=sys.stderr)
        mult = cfg.n_layers if name != "lm_head" else 1
        total_bytes += mult * (K * N + (K // group_size) * N * sb)
        total_time += mult * per
    if len(table) == 5:
        out["matmuls_only_ms_per_token"] = total_time * 1e3
        out["matmuls_only_GBps"] = total_bytes / total_time / 1e9
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        epilog="The JAX tool's --block-out/--block-in are TPU tiles and have "
               "no counterpart here.")
    add_device_arg(ap)
    ap.add_argument("--model", default="llama2-7b")
    ap.add_argument("--m", type=int, default=1)
    ap.add_argument("--group-size", type=int, default=64)
    ap.add_argument("--variant", default="kernel", choices=list(VARIANTS))
    ap.add_argument("--scales-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--layers", type=int, default=4,
                    help="stack depth for --variant kernel-layered")
    ap.add_argument("--shapes", default=None,
                    help="comma list to restrict, e.g. wqkv,w2")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = run(dev, args.model, args.m, args.group_size, args.variant,
              args.scales_dtype, args.layers, args.shapes)
    print(json.dumps(out, indent=2), flush=True)
    return out


if __name__ == "__main__":
    main()
