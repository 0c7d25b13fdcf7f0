#!/usr/bin/env python
"""Kernel bandwidth experiments for the INT8 matmul at decode shapes (M = 8).

Port of tools/exp_kernel.py. Variants, at the five TinyLlama-1.1B
projection shapes:
  stream   read int8 tiles, reduce-sum only: the card's int8 stream rate at
           the tool's tile sizes (`exp_stream`, csrc/exp_kernel.cu)
  current  the shipped kernel: the port's GEMM (`quant_gemm`, fast mode) at
           M = 8 (the TPU tiles block_out / block_in mean nothing on the card)
  outscale group-segmented matmul, scales applied to the output
           (`exp_outscale`, csrc/exp_kernel.cu)
Each row is one JSON line with the median us of one call (CUDA events,
`utils.profiling.device_time`, operand copies rotated past the 50 MB L2) and
the GB/s of the bytes the variant must move: q for stream; x, q, the fp32
scales and the output for the matmuls.

This module also holds the two kernels' wrappers, plain versions and
split plans. A wrapper takes its plain version for a tensor that lies on
the CPU and, for a CUDA tensor, launches its kernel or raises;
`exp_stream.launches` and `exp_outscale.launches` count kernel launches
(one a call). `stream_launch` and `outscale_launch` reach the kernels
uncounted at any split plan (tools/probe_costs.py times them).

    python -m kuiperllama_tpu_torch.tools.exp_kernel [--device cuda|cpu]
        [--shapes KxN,...]
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch

from ..ops.kernels import build
from ..ops.kernels import quant_matmul as qm
from ..quant import quantize_q80
from ..utils.profiling import device_time, l2_copies
from . import ITERS, add_device_arg, device_name, resolve_device

SOURCE = "exp_kernel"
G = 64
M_DECODE = 8
MAX_M = 16  # the outscale kernel's x^T is one or two n8 mma tiles
OUTSCALE_BN = 128  # weight columns per outscale block
# the least blocks per SM each kernel's split plan gives a shape's grid
OUTSCALE_BLOCKS_PER_SM = 2
STREAM_BLOCKS_PER_SM = 2
SHAPES = {"wqkv": (2048, 2560), "wo": (2048, 2048), "w13": (2048, 11264),
          "w2": (5632, 2048), "lm_head": (2048, 32000)}
# the stream probe's (tk, tn) tiles, in the JAX tool's order
STREAM_TILES = [(2048, 512), (1024, 512), (512, 512), (2048, 1024),
                (1024, 1024), (512, 2048)]

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int
_STREAM_ARGS = [_c_void_p, _c_void_p, _c_void_p, _c_void_p, _c_int, _c_int,
                _c_int, _c_int, _c_int, _c_int, _c_void_p]
_OUTSCALE_ARGS = [_c_void_p, _c_int, _c_void_p, _c_void_p, _c_int, _c_void_p,
                  _c_void_p, _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int,
                  _c_int, _c_void_p]
_sm_count: dict = {}
_counters: dict = {}


def _stream_check(q: torch.Tensor, tk: int, tn: int):
    if q.dtype != torch.int8 or q.dim() != 2:
        raise TypeError(f"exp_stream: q must be a 2-D int8 tensor, got "
                        f"{q.dtype} {tuple(q.shape)}")
    K, N = q.shape
    if tk <= 0 or tn <= 0 or K % tk or N % tn:
        raise ValueError(f"exp_stream: tiles ({tk}, {tn}) do not divide "
                         f"q [{K}, {N}]")


def outscale_tiles(K: int, N: int, tk: int = 2048, tn: int = 512):
    """JAX's clamps (tk <= K, tn <= N), then the checks: whole tiles of
    whole 64-row groups."""
    tk, tn = min(tk, K), min(tn, N)
    if K % tk or N % tn or tk % G:
        raise ValueError(f"exp_outscale: tiles ({tk}, {tn}) do not divide "
                         f"[{K}, {N}] in whole groups of {G}")
    return tk, tn


def split_bounds(n: int, r: int):
    """The r + 1 boundaries of n rows (or groups) split r ways as the kernels
    split them: part i is [i n // r, (i + 1) n // r), sizes within one."""
    return [i * n // r for i in range(r + 1)]


def outscale_plan(K: int, N: int, tk: int, sms: int,
                  blocks_per_sm: int = OUTSCALE_BLOCKS_PER_SM) -> int:
    """Splits r of each k-tile's tk / 64 groups: the fewest that give the
    grid of 128-column tiles x k-tiles x r blocks_per_sm blocks per SM, at
    most one split a group."""
    blocks = -(-N // OUTSCALE_BN) * (K // tk)
    return max(1, min(tk // G, -(-blocks_per_sm * sms // blocks)))


def stream_plan(K: int, N: int, tk: int, tn: int, sms: int,
                blocks_per_sm: int = STREAM_BLOCKS_PER_SM) -> int:
    """Row splits r of each (tk, tn) tile: the fewest that give the grid of
    tiles x r blocks_per_sm blocks per SM, at most one split a row."""
    return max(1, min(tk, -(-blocks_per_sm * sms // ((K // tk) * (N // tn)))))


# ---------------------------------------------------------------------------
# Plain versions


def stream_ref(q: torch.Tensor, tk: int, tn: int) -> torch.Tensor:
    """[1, 1] fp32: the last column tile's integer tile sums, added as fp32
    in k order (what `_stream_kernel` leaves in its output)."""
    _stream_check(q, tk, tn)
    K, N = q.shape
    sums = q[:, N - tn:].reshape(K // tk, tk, tn).sum(dim=(1, 2), dtype=torch.int64)
    acc = torch.zeros((), dtype=torch.float32, device=q.device)
    for v in sums.float():
        acc = acc + v
    return acc.reshape(1, 1)


def outscale_sums(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                  tk: int = 2048, tn: int = 512) -> torch.Tensor:
    """fp32 [M, N]: per k-tile, the fp32 products of bf16 x and bf16 q over
    each 64-row group, scaled by the group's row of s and summed; the
    k-tiles added in order."""
    M, K = x.shape
    N = q.shape[1]
    tk, tn = outscale_tiles(K, N, tk, tn)
    nk, ngt = K // tk, tk // G
    xg = x.to(torch.bfloat16).float().reshape(M, nk, ngt, G)
    part = torch.einsum("mkgc,kgcn->kgmn", xg, q.float().reshape(nk, ngt, G, N))
    tiles = (part * s[:K // G].float().reshape(nk, ngt, 1, N)).sum(dim=1)
    acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for t in tiles:
        acc = acc + t
    return acc


def outscale_ref(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                 tk: int = 2048, tn: int = 512) -> torch.Tensor:
    """bf16 [M, N]: `outscale_sums` rounded once to bf16."""
    return outscale_sums(x, q, s, tk, tn).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Kernel wrappers


def _on_current_cuda(name, *ts):
    dev = ts[0].device
    if not all(t.is_cuda and t.device == dev for t in ts):
        raise ValueError(f"{name}: operands must share one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: operands are on {dev}, the current device "
                         f"is cuda:{torch.cuda.current_device()}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: operands must be contiguous")


def sm_count(device) -> int:
    n = _sm_count.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_count[device.index] = n
    return n


def _counters_for(device, n: int) -> torch.Tensor:
    """The kernels' split counters, kept per device and zero between
    launches (the kernels reset them): calls on one stream share them, two
    streams must not."""
    t = _counters.get(device.index)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1), dtype=torch.int32, device=device)
        _counters[device.index] = t
    return t


def stream_launch(q: torch.Tensor, tk: int, tn: int, r: int | None = None) -> torch.Tensor:
    """One launch of the stream kernel on checked CUDA operands with r row
    splits a tile, uncounted: `exp_stream` calls it with `stream_plan`'s."""
    K, N = q.shape
    r = r or stream_plan(K, N, tk, tn, sm_count(q.device))
    partial = torch.empty((N // tn, (K // tk) * r), dtype=torch.int32, device=q.device)
    out = torch.empty((1, 1), dtype=torch.float32, device=q.device)
    vec = int(tn % 16 == 0 and N % 16 == 0 and q.data_ptr() % 16 == 0)
    rc = build.entry(SOURCE, "exp_stream", _STREAM_ARGS)(
        q.data_ptr(), partial.data_ptr(), _counters_for(q.device, 1).data_ptr(),
        out.data_ptr(), K, N, tk, tn, r, vec,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"exp_stream: kernel launch failed, CUDA error {rc}")
    return out


def exp_stream(q: torch.Tensor, tk: int, tn: int) -> torch.Tensor:
    """The stream probe of q int8 [K, N] in (tk, tn) tiles -> [1, 1] fp32."""
    if q.device.type == "cpu":
        return stream_ref(q, tk, tn)
    _stream_check(q, tk, tn)
    _on_current_cuda("exp_stream", q)
    out = stream_launch(q, tk, tn)
    exp_stream.launches += 1
    return out


def outscale_launch(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, tk: int,
                    r: int | None = None) -> torch.Tensor:
    """One launch of the outscale kernel on checked CUDA operands with each
    k-tile's groups split r ways, uncounted: `exp_outscale` calls it with
    `outscale_plan`'s."""
    M, K = x.shape
    N = q.shape[1]
    r = r or outscale_plan(K, N, tk, sm_count(x.device))
    splits = K // tk * r
    y = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    partial = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
               if splits > 1 else y)
    vec = int(x.data_ptr() % 16 == 0 and s.data_ptr() % 16 == 0)
    rc = build.entry(SOURCE, "exp_outscale", _OUTSCALE_ARGS)(
        x.data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(), s.data_ptr(),
        int(s.dtype == torch.bfloat16), partial.data_ptr(),
        _counters_for(x.device, -(-N // OUTSCALE_BN)).data_ptr(), y.data_ptr(),
        M, K, N, tk, r, vec, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"exp_outscale: kernel launch failed, CUDA error {rc}")
    return y


def exp_outscale(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                 tk: int = 2048, tn: int = 512) -> torch.Tensor:
    """x [M, K] (fp32 or bf16) @ q int8 [K, N] with group-64 scales s
    [K / 64, N] (fp32 or bf16) applied to each group's product -> bf16 [M, N]."""
    if x.dim() != 2 or q.dim() != 2 or s.dim() != 2 or q.dtype != torch.int8:
        raise TypeError("exp_outscale: x, s must be 2-D and q a 2-D int8 tensor")
    M, K = x.shape
    N = q.shape[1]
    if q.shape[0] != K or s.shape[0] < K // G or s.shape[1] != N:
        raise ValueError(f"exp_outscale: shapes x {tuple(x.shape)}, q "
                         f"{tuple(q.shape)}, s {tuple(s.shape)} do not fit")
    tk, tn = outscale_tiles(K, N, tk, tn)
    if x.device.type == "cpu":
        return outscale_ref(x, q, s, tk, tn)
    _on_current_cuda("exp_outscale", x, q, s)
    if x.dtype not in (torch.float32, torch.bfloat16) or s.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"exp_outscale: x and s must be fp32 or bf16, got "
                        f"{x.dtype}, {s.dtype}")
    if M > MAX_M or N % 64 or q.data_ptr() % 16:
        raise ValueError(f"exp_outscale: the kernel takes M <= {MAX_M}, N a "
                         f"multiple of 64 and a 16-byte aligned q; got M {M}, N {N}")
    y = outscale_launch(x, q, s, tk)
    exp_outscale.launches += 1
    return y


exp_stream.launches = 0
exp_outscale.launches = 0


def coop_cluster_probe(device, blocks: int = 16, cluster: int = 2) -> dict:
    """Whether one cudaLaunchKernelEx takes the cooperative attribute and a
    cluster dimension together on this card: the launch's CUDA error code,
    and whether every block then read its cluster neighbour's shared
    memory and met the others at a grid barrier."""
    flags = torch.zeros(blocks + 1, dtype=torch.int32, device=device)
    rc = build.entry(SOURCE, "exp_coop_cluster", [_c_void_p, _c_int, _c_int, _c_void_p])(
        flags.data_ptr(), blocks, cluster, torch.cuda.current_stream(device).cuda_stream)
    torch.cuda.synchronize(device)
    return dict(blocks=blocks, cluster=cluster, launch_error=rc,
                accepted=rc == 0, all_blocks_met=rc == 0 and int(flags[-1]) == blocks)


def empty_launch(device) -> None:
    """One launch of an empty kernel through this library's ctypes path,
    uncounted: the fixed floor of a probe's call (tools/probe_costs.py)."""
    rc = build.entry(SOURCE, "exp_empty", [_c_void_p])(
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"exp_empty: kernel launch failed, CUDA error {rc}")


# ---------------------------------------------------------------------------
# The tool


def sweep_tiles(K: int, N: int):
    """The outscale tiles main() takes at [K, N]: the largest tk of 2048,
    1024, 512 and tn of 512, 256, 128, 64 that divide the shape (the JAX
    defaults 2048 x 512 leave whole tiles at neither w2 nor lm_head)."""
    tk = next(t for t in (2048, 1024, 512, 256, 128, 64) if K % min(t, K) == 0)
    tn = next(t for t in (512, 256, 128, 64) if N % min(t, N) == 0)
    return outscale_tiles(K, N, tk, tn)


def _parse_shapes(text):
    if not text:
        return dict(SHAPES)
    shapes = {}
    for item in text.split(","):
        name, _, dims = item.rpartition("=")
        K, N = (int(v) for v in dims.split("x"))
        shapes[name or dims] = (K, N)
    return shapes


def run(dev, shapes=None):
    """Times every variant at every shape at M = 8; returns one dict per row."""
    M, rows = M_DECODE, []
    for name, (K, N) in (shapes or SHAPES).items():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        w = quantize_q80(torch.randn((K, N), generator=gen, device=dev), G)
        q, s = w.q, w.s
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        del w
        qs = [(q,)] + [(q.clone(),) for _ in range(l2_copies(K * N, dev) - 1)]
        mm_bytes = K * N + (K // G) * N * 4 + M * K * 2 + M * N * 2

        def row(variant, seconds, nbytes, tk=None, tn=None):
            r = dict(variant=variant, shape=name, K=K, N=N, M=M, tk=tk, tn=tn,
                     us=seconds * 1e6, GBps=nbytes / seconds / 1e9, bytes=nbytes,
                     device=device_name(dev))
            print(json.dumps(r), flush=True)
            rows.append(r)

        for tk, tn in STREAM_TILES:
            if K % tk or N % tn:
                continue
            t = device_time(lambda qq: exp_stream(qq, tk, tn), variants=qs, iters=ITERS)
            row("stream", t, K * N, tk, tn)
        t = device_time(lambda qq: qm.quant_gemm(x, qq, s, G), variants=qs, iters=ITERS)
        row("current", t, mm_bytes)
        tk, tn = sweep_tiles(K, N)
        t = device_time(lambda qq: exp_outscale(x, qq, s, tk, tn), variants=qs,
                        iters=ITERS)
        row("outscale", t, mm_bytes, tk, tn)
        del qs
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(ap)
    ap.add_argument("--shapes", default=None,
                    help="comma list of [name=]KxN (default: the five "
                         "TinyLlama-1.1B projections)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    return run(dev, _parse_shapes(args.shapes))


if __name__ == "__main__":
    main()
