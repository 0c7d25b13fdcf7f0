#!/usr/bin/env python
"""Probe: where a call of the W8A16 GEMM (csrc/quant_gemm.cu, fast mode)
spends its time, route by route, beside its bound and the library.

Cells: the four Llama-2-7B projections of chip_smoke.py's GEMV_SHAPES
(wqkv, wo, w13, w2) at g 256 with bf16 x and scales, at M of 8, 16, 32,
64, 128, 192, 255 and 256; w2 at M = 1 and g 64 (172 groups, past the
GEMV's cap); the lm_head at M = 8. Each variant's time is the median of
25 calls by CUDA events on weight copies rotated past the 50 MB L2
(`utils.profiling.device_time`), in ROUNDS interleaved rounds (a new
process runs a few percent apart from another, so variants are compared
only within one run):

  mma_sync     the mma.sync route (PR 6's kernel) through `gemm_launch`
  no_dequant   its tool-only variant: the packed int8 words go to the mma
               as if they were bf16 (`quant_gemm_probe`, probe 1)
  no_mma       its tool-only variant: the A fragments are made, no mma or
               x fragment read follows (probe 2)
  wgmma        the wgmma route (TMA, mbarrier ring, wgmma) through
               `gemm_launch`, at its own plan
  wgmma_ring_only   its source variant whose consumers only wait for each
               stage and release it: the TMA ring's stream alone
  wgmma_no_dequant  the int8 words go to wgmma as if they were bf16
  wgmma_no_mma the A fragments are made, no wgmma follows
  library      bf16 x @ the dequantized bf16 weight (`torch.matmul`)

The wgmma_* source variants of csrc/quant_gemm.cu are built at once
(`big_phase_costs.build_variants`, one nvcc each) and launched through
`gemm_launch`. The probes' and variants' values are wrong; each other
variant is held against the plain version (2^-7 of max|ref|, one bf16
ulp) before it is timed. Per
cell also: each route's split and the fp32 partial bytes it writes, its
device kernels apart (the main kernel and `reduce_splits`, us per launch,
by torch.profiler), the wgmma kernel's geometry, and the bound (bytes and
bf16 operations over the data sheet's rates, as chip_smoke.py `bound`).
`--variants` and `--cells` (e.g. `wqkv:255,wo:8`) pick a subset. Prints
one JSON line per cell, then the card's nvidia-smi line. Needs the card.

    python -m kuiperllama_tpu_torch.tools.gemm_costs [--rounds 3]
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from ..ops.kernels import build
from ..ops.kernels import quant_matmul as qm
from ..utils.profiling import device_time, l2_copies, nvidia_smi_line
from .probe_costs import kernel_split

SHAPES = {"wqkv": (4096, 12288), "wo": (4096, 4096), "w13": (4096, 22016),
          "w2": (11008, 4096), "lm_head": (4096, 32000)}
ROWS = (8, 16, 32, 64, 128, 192, 255, 256)
GROUP = 256
# (name, M, g)
CELLS = ([(name, M, GROUP) for M in ROWS for name in ("wqkv", "wo", "w13", "w2")]
         + [("w2", 1, 64), ("lm_head", 8, GROUP)])
PROBES = {"no_dequant": 1, "no_mma": 2}
# (old, new) substitutions in csrc/quant_gemm.cu, each found exactly once
WGMMA_VARIANTS = {
    "wgmma_ring_only": [(
        "    mbar_wait(smem_u32(&full[st]), (it / stages) & 1);\n",
        "    mbar_wait(smem_u32(&full[st]), (it / stages) & 1);\n"
        "    if (lane < 32) {\n"
        "      if (it > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(it - 1) % stages]));\n"
        "      continue;\n"
        "    }\n")],
    "wgmma_no_dequant": [(
        "    dequant_frag(u[2 * h], u[2 * h + 1], sa, sb, a[h]);",
        "    a[h][0] = u[2 * h];\n    a[h][1] = u[2 * h + 1];\n"
        "    a[h][2] = u[2 * h] ^ sa;\n    a[h][3] = u[2 * h + 1] ^ sb;")],
    "wgmma_no_mma": [(
        "  for (int h = 0; h < 2; ++h) wgmma_rows<NW>(acc, a[h], bx + 2 * (2 * H + h));",
        "  for (int h = 0; h < 2; ++h)\n"
        "    asm volatile(\"\" :: \"r\"(a[h][0]), \"r\"(a[h][1]), \"r\"(a[h][2]), "
        "\"r\"(a[h][3]), \"l\"(bx));")],
}
VARIANTS = ("mma_sync", "no_dequant", "no_mma", "wgmma", *WGMMA_VARIANTS, "library")
ROUNDS = 3
ITERS = 25
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_OPS_PER_S = 989e12
BF16_ULP = 2.0 ** -7

_PROBE_ARGS = [qm._c_void_p] * 5 + [qm._c_int] * 6 + [qm._c_void_p]


def bound_us(M, K, N, g):
    """(bytes us, operations us): bf16 x, int8 q, bf16 scales and the bf16
    output each moved once; 2 M K N bf16 operations."""
    nbytes = M * K * 2 + K * N + (K // g) * N * 2 + M * N * 2
    return nbytes / HBM_BYTES_PER_S * 1e6, 2.0 * M * K * N / BF16_OPS_PER_S * 1e6


def probe_launch(x, q, s, g, probe):
    """One launch of the mma.sync kernel's tool-only variant `probe` at
    quant_gemm's split (bf16 x and scales)."""
    M = x.shape[0]
    K, N = q.shape
    kps = qm.gemm_k_per_split(M, K, N, qm._sms(x.device))
    splits = -(-K // kps)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    partial = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
               if splits > 1 else y)
    rc = build.entry(qm.GEMM_SOURCE, "quant_gemm_probe", _PROBE_ARGS)(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(), partial.data_ptr(),
        M, K, N, g, kps, probe, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quant_gemm_probe: CUDA error {rc}")
    return y


def operands(dev, M, K, N, g, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
    s = (torch.rand((K // g, N), generator=gen, device=dev) * 0.015 + 0.005).to(torch.bfloat16)
    return x, q, s


def variant_source(name: str, text: str) -> str:
    """`text` (csrc/quant_gemm.cu) with variant `name`'s substitutions;
    raises if a piece no longer occurs exactly once."""
    for old, new in WGMMA_VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    return text


def variant_libs(names) -> dict:
    """{variant: the loaded library} of the wgmma source variants asked for,
    built at once."""
    from .big_phase_costs import build_variants

    text = (build.CSRC / f"{qm.GEMM_SOURCE}.cu").read_text()
    jobs = {name: (qm.GEMM_SOURCE, {f"{qm.GEMM_SOURCE}.cu": variant_source(name, text)})
            for name in names if name in WGMMA_VARIANTS}
    return {name: lib for name, (lib, _) in build_variants(jobs).items()} if jobs else {}


def with_lib(lib, fn):
    """fn with csrc/quant_gemm.cu's library swapped for `lib` while it runs."""
    def call(*args):
        kept = build._libs.get(qm.GEMM_SOURCE)
        build._libs[qm.GEMM_SOURCE] = lib
        try:
            return fn(*args)
        finally:
            build._libs[qm.GEMM_SOURCE] = kept
    return call


def variant_fns(g, libs):
    """{variant: fn(x, q, s)} for the weight-rotating variants."""
    wgmma = lambda x, q, s: qm.gemm_launch(x, q, s, g, "wgmma")
    fns = {"mma_sync": lambda x, q, s: qm.gemm_launch(x, q, s, g, "mma_sync"), "wgmma": wgmma}
    for name, probe in PROBES.items():
        fns[name] = lambda x, q, s, p=probe: probe_launch(x, q, s, g, p)
    for name, lib in libs.items():
        fns[name] = with_lib(lib, wgmma)
    return fns


def rel_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


def cell_row(dev, name, M, g, variants, rounds, seed, libs):
    K, N = SHAPES[name]
    x, q, s = operands(dev, M, K, N, g, seed)
    sms = qm._sms(dev)
    want = qm.quant_gemm_ref(x, q, s, g)
    fns = variant_fns(g, libs)
    errors = {}
    for v in ("mma_sync", "wgmma"):
        if v in variants:
            errors[v] = rel_err(fns[v](x, q, s), want)
    torch.cuda.synchronize()
    qs = [q] + [q.clone() for _ in range(l2_copies(K * N, dev) - 1)]
    rot = [(x, qc, s) for qc in qs]
    lib = None
    if "library" in variants:
        wd = qm.dequantize_bf16(q, s, g)
        lib = [(x, wd)] + [(x, wd.clone()) for _ in range(l2_copies(2 * K * N, dev) - 1)]
    us = {v: [] for v in variants}
    for _ in range(rounds):
        for v in variants:
            fn, ops = (torch.matmul, lib) if v == "library" else (fns[v], rot)
            us[v].append(device_time(fn, variants=ops, iters=ITERS, device="cuda") * 1e6)
    kernels = {v: kernel_split(fns[v], rot) for v in ("mma_sync", "wgmma") if v in variants}
    kps = {"mma_sync": qm.gemm_k_per_split(M, K, N, sms),
           "wgmma": qm.gemm_wgmma_plan(M, K, N, sms)}
    splits = {r: -(-K // k) for r, k in kps.items()}
    b_bytes, b_ops = bound_us(M, K, N, g)
    del qs, rot, lib
    ok = all(e <= BF16_ULP for e in errors.values())
    return dict(
        cell=f"{name}:{M}", weight=name, M=M, K=K, N=N, g=g,
        us={v: statistics.median(t) for v, t in us.items()}, us_rounds=us,
        kernels=kernels, k_per_split=kps, splits=splits,
        partial_bytes={r: 4 * n * M * N if n > 1 else 0 for r, n in splits.items()},
        weight_bytes=K * N,
        wgmma=qm.wgmma_geometry(M, K, g, True, kps["wgmma"]),
        bound_us=max(b_bytes, b_ops), bound_by="bytes" if b_bytes >= b_ops else "operations",
        bound_bytes_us=b_bytes, bound_ops_us=b_ops, rel_err=errors, ok=ok)


def run(dev, cells, variants, rounds):
    libs = variant_libs(variants)
    rows = []
    for i, (name, M, g) in enumerate(cells):
        row = cell_row(dev, name, M, g, variants, rounds, seed=i, libs=libs)
        print(json.dumps(row), flush=True)
        rows.append(row)
        if not row["ok"]:
            raise SystemExit(f"gemm_costs: {row['cell']} disagrees with the plain version")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--cells", default=None, help="name:M[,name:M...] (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gemm_costs: needs a CUDA device")
    variants = tuple(args.variants.split(","))
    if set(variants) - set(VARIANTS):
        raise SystemExit(f"gemm_costs: variants are {VARIANTS}")
    cells = CELLS
    if args.cells:
        want = set(args.cells.split(","))
        cells = [c for c in CELLS if f"{c[0]}:{c[1]}" in want]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    run(dev, cells, variants, args.rounds)
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    main()
