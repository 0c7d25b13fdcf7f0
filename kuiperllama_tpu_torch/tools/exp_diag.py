#!/usr/bin/env python
"""The GEMV's group-count cap on the card: at one row, is a reduction of
more than 64 groups faster on the GEMV or on the GEMM? Port of
tools/exp_diag.py.

The JAX tool sweeps `KT_DIAG_MAX`, the cap of its block-diagonal GEMV path,
over the production M = 1 reductions that fall off that path at the cap of
64: TinyLlama w2 (K 5632, 88 groups), Llama-3.2-1B w2 (K 8192, 128) and
Llama-2-7B w2 (K 11008, 172). In the port the cap is the constant
`ops/linear.py` GEMV_MAX_GROUPS, read at call time, so this tool sets it per
setting (64 and 176) and restores it; it adds no knob of its own. Each
shape is timed at g 64 with bf16 scales over 4 stacked layers
(`bench_kernels.bench_quant_shape`, variant kernel-layered: CUDA events,
weight copies rotated past L2). At cap 64 the shapes take the one-row GEMM
(the JAX tool's "generic"), at cap 176 the GEMV ("diag"), which takes any
group count. The JSON keeps the JAX keys (K{K}_N{N}: groups,
cap{cap}_{tag}: {GBps, us}) and adds the kernel that ran and its launches.

    python -m kuiperllama_tpu_torch.tools.exp_diag [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..ops import linear
from . import HBM_SHEET_GBPS, add_device_arg, counted_launches, report, resolve_device
from .bench_kernels import bench_quant_shape

SHAPES = [(5632, 2048), (8192, 2048), (11008, 4096)]
# 64: the default cap (these shapes take the GEMM); 176 covers them all
CAPS = [64, 176]
GROUP = 64
LAYERS = 4


def jax_tag(K: int, cap: int) -> str:
    """The JAX tool's name of the route at `cap`: "diag" iff K // 64 <= cap."""
    return "diag" if K // GROUP <= cap else "generic"


def run(dev, shapes=SHAPES, caps=CAPS) -> dict:
    before = counted_launches()
    out = {}
    saved = linear.GEMV_MAX_GROUPS
    try:
        for K, N in shapes:
            out[f"K{K}_N{N}"] = row = {"groups": K // GROUP}
            for cap in caps:
                linear.GEMV_MAX_GROUPS = cap
                n0 = counted_launches()
                gbps, per = bench_quant_shape(dev, K, N, 1, group_size=GROUP,
                                              variant="kernel-layered",
                                              scales_dtype=torch.bfloat16,
                                              n_layers=LAYERS)
                n1 = counted_launches()
                key = f"cap{cap}_{jax_tag(K, cap)}"
                row[key] = dict(
                    GBps=round(gbps, 1), us=round(per * 1e6, 2),
                    pct_of_sheet_bw=round(100 * gbps / HBM_SHEET_GBPS, 1),
                    kernel="quant_gemv" if linear.takes_gemv(1, K, GROUP) else "quant_gemm",
                    launches={k: n1[k] - n0[k] for k in ("quant_gemv", "quant_gemm")})
                print(f"[{K}x{N}] cap={cap} ({row[key]['kernel']}): {row[key]}",
                      file=sys.stderr)
    finally:
        linear.GEMV_MAX_GROUPS = saved
    return report(dev, dict(tool="exp_diag", group_size=GROUP, layers=LAYERS,
                            scales_dtype="bfloat16", **out), before)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(ap)
    args = ap.parse_args(argv)
    return run(resolve_device(args.device))


if __name__ == "__main__":
    main()
