#!/usr/bin/env python
"""Measure the card's achievable HBM bandwidth, decode-shaped GEMV weight
stream and bf16 tensor-core throughput.

Port of tools/roofline.py. Decode is weight-bandwidth-bound, so the
roofline ceiling is tokens/s = measured bytes/s / bytes touched per token;
this probe measures the numerator on the card instead of taking the data
sheet's 3.35 TB/s. Each probe is torch ops, as JAX's are XLA ops, timed by
`utils.profiling.device_time` (CUDA events, median call) over rotating
buffers that exceed the 50 MB L2:
  read    sum one of 4 rotating 256 MB bf16 buffers (torch.sum, fp32)
  gemv    [8, 4096] x [4096, 11008] over 4 rotating weights, bf16 and int8;
          the int8 weight is cast to bf16 before the dot as in JAX. PyTorch
          materializes that cast as its own kernel (XLA may fuse it), so
          gemv_int8_GBps counts JAX's bytes (the int8 weight) over a time
          that includes the cast's traffic. The card's int8 stream rate is
          exp_kernel's `stream`.
  mxu     a 4096^3 bf16 matmul on the tensor cores (the key keeps JAX's name)
Prints one JSON dict; `--json-out` also writes it to that path.

    python -m kuiperllama_tpu_torch.tools.roofline [--device cuda|cpu] [--json-out f]
"""

from __future__ import annotations

import argparse
import json

import torch

from ..utils.profiling import device_time, nvidia_smi_line
from . import ITERS, add_device_arg, device_name, resolve_device


def probe_read(dev, mb_per_buf: int = 256, n_bufs: int = 4) -> float:
    """GB/s of a pure read: the fp32 sum of one of n_bufs rotating bf16
    buffers per call."""
    n = mb_per_buf * (1 << 20) // 2
    bufs = torch.ones((n_bufs, n // 1024, 1024), dtype=torch.bfloat16, device=dev)
    per = device_time(lambda b: torch.sum(b, dtype=torch.float32),
                      variants=[(bufs[i],) for i in range(n_bufs)], iters=ITERS)
    return mb_per_buf * (1 << 20) / per / 1e9


def probe_gemv(dev, K: int = 4096, N: int = 11008, M: int = 8, n_bufs: int = 4,
               dtype=torch.bfloat16) -> float:
    """GB/s of the weight stream of a decode-shaped matmul [M, K] x [K, N]
    over n_bufs rotating weights in `dtype` (cast to bf16 before the dot)."""
    ws = torch.ones((n_bufs, K, N), dtype=dtype, device=dev)
    v = torch.ones((M, K), dtype=torch.bfloat16, device=dev)
    per = device_time(lambda w: v @ w.to(torch.bfloat16),
                      variants=[(ws[i],) for i in range(n_bufs)], iters=ITERS)
    return K * N * ws.element_size() / per / 1e9


def probe_mxu(dev, D: int = 4096) -> float:
    """TFLOP/s of a D^3 bf16 matmul."""
    a = torch.ones((D, D), dtype=torch.bfloat16, device=dev)
    per = device_time(lambda x: x @ x, a, iters=ITERS)
    return 2 * D ** 3 / per / 1e12


def run(dev, read_mb: int = 256, K: int = 4096, N: int = 11008,
        mxu_d: int = 4096) -> dict:
    return {
        "device": device_name(dev),
        "nvidia_smi": nvidia_smi_line() if dev.type == "cuda" else None,
        "read_GBps": probe_read(dev, read_mb),
        "gemv_weightread_GBps": probe_gemv(dev, K, N),
        "gemv_int8_GBps": probe_gemv(dev, K, N, dtype=torch.int8),
        "mxu_bf16_TFLOPs": probe_mxu(dev, mxu_d),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(ap)
    ap.add_argument("--json-out", help="also write the dict to this path")
    ap.add_argument("--read-mb", type=int, default=256, help="MB per read buffer")
    ap.add_argument("--gemv-k", type=int, default=4096)
    ap.add_argument("--gemv-n", type=int, default=11008)
    ap.add_argument("--mxu-d", type=int, default=4096, help="matmul edge")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = run(dev, args.read_mb, args.gemv_k, args.gemv_n, args.mxu_d)
    s = json.dumps(out)
    print(s, flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(s + "\n")
    return out


if __name__ == "__main__":
    main()
