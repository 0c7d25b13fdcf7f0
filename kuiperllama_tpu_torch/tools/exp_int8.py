#!/usr/bin/env python
"""Probe: GEMV formulations over a stacked int8 weight larger than L2.

Port of tools/exp_int8.py. One call reads an [L, K, N] int8 stack with fp32
group scales [L, K / g, N] against x bf16 [1, K] and returns y [1, N] fp32,
the layers' GEMVs added in order (`exp_int8`, csrc/exp_int8.cu). Modes:
  nodot        full-tile read, trivial use (the 1-operand stream ceiling)
  bf16         bf16(x) against the int8 rows per group, fp32, group scales
  split4       bf16 with the columns read as 4 independent load streams
  int8         x quantized per group to int8, exact int32 dot products
  int8_split4  int8 with 4 column streams
  plain8       bf16(x) against the dequantized bf16 weight per 1024-row chunk
Each mode's time is the median of 25 calls (CUDA events,
`utils.profiling.device_time`); one line per mode gives ms per pass, GB/s
of the weight and scale bytes, and us per layer tile. The default stack is
536.9 MB of weights, ten times the card's L2.

This module also holds the kernel's wrapper and plain version: the wrapper
takes the plain version for a tensor that lies on the CPU and, for a CUDA
tensor, launches the kernel or raises; `exp_int8.launches` counts launches.

    python -m kuiperllama_tpu_torch.tools.exp_int8 [--device cuda|cpu]
        [--L 64] [--K 4096] [--N 2048] [--g 64]
        [--modes bf16,split4,int8,int8_split4,plain8]
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch

from ..ops.kernels import build
from ..utils.profiling import device_time, l2_copies
from . import ITERS, add_device_arg, device_name, resolve_device

SOURCE = "exp_int8"
MODES = ("nodot", "bf16", "split4", "int8", "int8_split4", "plain8")
_MODE_ID = {"nodot": 0, "bf16": 1, "split4": 1, "int8": 2, "int8_split4": 2,
            "plain8": 3}
SUB = 1024          # the JAX kernel's sub-chunk rows (bf16, split4, plain8)
BLOCK_COLS = 256    # columns of one kernel block
MAX_K = 8192        # x staged in shared memory
_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int
_ARGS = [_c_void_p] * 6 + [_c_int] * 6 + [_c_void_p]


def default_nsplit(mode: str) -> int:
    """The JAX tool's column splits for a mode: 4 for the *split4 modes."""
    return 4 if mode.endswith("split4") else 1


def _check(w, s, x, g, mode, nsplit):
    if mode not in MODES:
        raise ValueError(f"exp_int8: mode must be one of {MODES}, got {mode!r}")
    if w.dtype != torch.int8 or w.dim() != 3:
        raise TypeError(f"exp_int8: w must be int8 [L, K, N], got {w.dtype} "
                        f"{tuple(w.shape)}")
    L, K, N = w.shape
    if g <= 0 or K % g:
        raise ValueError(f"exp_int8: group size {g} does not divide K {K}")
    if mode in ("bf16", "split4", "plain8") and K % SUB:
        raise ValueError(f"exp_int8: mode {mode} reads {SUB}-row sub-chunks; "
                         f"K {K} is not a multiple of {SUB}")
    if nsplit <= 0 or N % nsplit:
        raise ValueError(f"exp_int8: nsplit {nsplit} does not divide N {N}")
    if mode == "plain8" and (nsplit != 1 or SUB % g):
        raise ValueError("exp_int8: plain8 takes nsplit 1 and a group size "
                         f"that divides {SUB}")
    if tuple(s.shape) != (L, K // g, N) or tuple(x.shape) != (1, K):
        raise ValueError(f"exp_int8: s {tuple(s.shape)} and x {tuple(x.shape)} "
                         f"do not fit w {tuple(w.shape)} at group size {g}")


# ---------------------------------------------------------------------------
# Plain version


def exp_int8_ref(w: torch.Tensor, s: torch.Tensor, x: torch.Tensor, g: int,
                 mode: str, nsplit: int = 1) -> torch.Tensor:
    """y [1, N] fp32 = sum over layers, in order, of the mode's GEMV (see
    csrc/exp_int8.cu for each mode's arithmetic)."""
    _check(w, s, x, g, mode, nsplit)
    L, K, N = w.shape
    ng, TN = K // g, N // nsplit
    xb = x.reshape(K).to(torch.bfloat16).float()
    acc = torch.zeros(N, dtype=torch.float32, device=w.device)
    for li in range(L):
        wl = w[li]
        if mode == "nodot":
            rows = wl[:8].float() + wl[K - 8:].float()
            y = torch.zeros(N, dtype=torch.float32, device=w.device)
            y[:TN] = rows.sum(dim=0).reshape(nsplit, TN).sum(dim=0)
        elif mode in ("bf16", "split4"):
            P = torch.einsum("ig,ign->in", xb.reshape(ng, g), wl.float().reshape(ng, g, N))
            y = (P * s[li].float()).sum(dim=0)
        elif mode in ("int8", "int8_split4"):
            xg = xb.reshape(ng, g)
            amax = xg.abs().amax(dim=1, keepdim=True)
            # a tensor divisor: PyTorch on the card multiplies by the
            # reciprocal of a scalar one, which can move d by one ulp and
            # flip a rounding of x / d
            d = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                            torch.ones_like(amax))
            xq = torch.round(xg / d)
            # exact integer sums (float64 holds every partial exactly)
            Pi = torch.einsum("ig,ign->in", xq.double(), wl.double().reshape(ng, g, N))
            y = ((Pi.float() * d) * s[li].float()).sum(dim=0)
        else:  # plain8
            y = torch.zeros(N, dtype=torch.float32, device=w.device)
            for i in range(K // SUB):
                qb = wl[i * SUB:(i + 1) * SUB].to(torch.bfloat16)
                sb = s[li, i * (SUB // g):(i + 1) * (SUB // g)].to(torch.bfloat16)
                wd = (qb.reshape(SUB // g, g, N) * sb[:, None, :]).reshape(SUB, N)
                y = y + xb[i * SUB:(i + 1) * SUB] @ wd.float()
        acc = acc + y
    return acc.reshape(1, N)


# ---------------------------------------------------------------------------
# Kernel wrapper


def exp_int8(w: torch.Tensor, s: torch.Tensor, x: torch.Tensor, g: int,
             mode: str, nsplit: int = 1) -> torch.Tensor:
    """The stacked GEMV of `mode` over w int8 [L, K, N], s fp32 [L, K / g, N]
    and x [1, K] (rounded to bf16) -> y [1, N] fp32."""
    if w.device.type == "cpu":
        return exp_int8_ref(w, s, x, g, mode, nsplit)
    _check(w, s, x, g, mode, nsplit)
    L, K, N = w.shape
    if not (w.is_cuda and s.device == w.device and x.device == w.device):
        raise ValueError(f"exp_int8: w, s and x must share one CUDA device (got "
                         f"{w.device}, {s.device}, {x.device})")
    if w.device.index != torch.cuda.current_device():
        raise ValueError(f"exp_int8: w is on {w.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if s.dtype != torch.float32 or x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"exp_int8: s must be fp32 and x bf16 or fp32, got "
                        f"{s.dtype}, {x.dtype}")
    if (N % BLOCK_COLS or BLOCK_COLS // 16 % nsplit or g % 4 or K > MAX_K
            or not (w.is_contiguous() and s.is_contiguous())
            or w.data_ptr() % 16 or s.data_ptr() % 16):
        raise ValueError(f"exp_int8: the kernel takes contiguous 16-byte aligned "
                         f"w and s, N a multiple of {BLOCK_COLS}, nsplit dividing "
                         f"16, g a multiple of 4 and K <= {MAX_K}; got "
                         f"{tuple(w.shape)}, g {g}, nsplit {nsplit}")
    xb = x.to(torch.bfloat16).contiguous()
    partial = torch.empty((L, N), dtype=torch.float32, device=w.device)
    checksum = torch.empty((L, N // BLOCK_COLS), dtype=torch.int32, device=w.device)
    y = torch.empty((1, N), dtype=torch.float32, device=w.device)
    rc = build.entry(SOURCE, "exp_int8", _ARGS)(
        w.data_ptr(), s.data_ptr(), xb.data_ptr(), partial.data_ptr(),
        checksum.data_ptr(), y.data_ptr(), L, K, N, g, _MODE_ID[mode], nsplit,
        torch.cuda.current_stream(w.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"exp_int8: kernel launch failed, CUDA error {rc}")
    exp_int8.launches += 1
    return y


exp_int8.launches = 0


# ---------------------------------------------------------------------------
# The tool


def make_stack(dev, L: int, K: int, N: int, g: int, seed: int = 0):
    """(w, s, x) from a seeded generator on `dev`: int8 weights in
    [-127, 127], scales in [0.005, 0.02), standard-normal bf16 x."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    w = torch.randint(-127, 128, (L, K, N), generator=gen, device=dev,
                      dtype=torch.int8)
    s = torch.rand((L, K // g, N), generator=gen, device=dev) * 0.015 + 0.005
    x = torch.randn((1, K), generator=gen, device=dev).to(torch.bfloat16)
    return w, s, x


def measure(w, s, x, g, mode, nsplit, iters: int = ITERS, fn=None) -> float:
    """Median seconds of one pass of `fn` (default: exp_int8) over the
    stack, rotating copies of it where it is smaller than twice the L2."""
    fn = fn or exp_int8
    copies = [(w, s)] + [(w.clone(), s.clone())
                         for _ in range(l2_copies(w.numel() + 4 * s.numel(), w.device) - 1)]
    return device_time(lambda ww, ss: fn(ww, ss, x, g, mode, nsplit),
                       variants=copies, iters=iters)


def run(dev, L=64, K=4096, N=2048, g=64, modes=MODES[1:]):
    w, s, x = make_stack(dev, L, K, N, g)
    nbytes = w.numel() + s.numel() * 4
    rows = []
    for mode in modes:
        nsplit = default_nsplit(mode)
        dt = measure(w, s, x, g, mode, nsplit)
        r = dict(mode=mode, nsplit=nsplit, L=L, K=K, N=N, g=g,
                 ms_per_pass=dt * 1e3, GBps=nbytes / dt / 1e9,
                 us_per_tile=dt / L * 1e6, bytes=nbytes, device=device_name(dev))
        print(json.dumps(r), flush=True)
        rows.append(r)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(ap)
    ap.add_argument("--L", type=int, default=64)
    ap.add_argument("--K", type=int, default=4096)
    ap.add_argument("--N", type=int, default=2048)
    ap.add_argument("--g", type=int, default=64)
    ap.add_argument("--modes", default="bf16,split4,int8,int8_split4,plain8")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    return run(dev, args.L, args.K, args.N, args.g, args.modes.split(","))


if __name__ == "__main__":
    main()
