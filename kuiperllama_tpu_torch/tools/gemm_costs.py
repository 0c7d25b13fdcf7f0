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
  wgmma_no_sum the split partials are written and never summed (no
               reduce_splits launch)
  wgmma_empty  a kernel that returns at once, on the same grid, no sum
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

`--fit` measures instead what a call costs apart from its stream: every
FIT_KERNELS kernel over N of 1,024-22,016 at K = 4,096 and 11,008 (M = 1
for the GEMV, 8, 32 and 128 for the GEMMs), each point's CUDA-event time
and torch.profiler's device time apart from `reduce_splits`, then per
kernel and M the least-squares line t = a + bytes / BW over the points
(a the fixed cost of a call in us, BW the stream's rate in TB/s, bytes
the weight's: int8 K N, the library's bf16 2 K N) with its residuals,
beside each point's blocks and waves and `roofline.probe_read`. The
source variants cut the fixed cost into parts: `*_no_sum` without the
split sum, `*_empty` a kernel that returns at once on the same grid,
`wgmma_ring_only` the TMA ring's stream alone, `wgmma_one_wave` the wgmma
route with its splits capped at one wave of blocks. Two commits are
compared by running the tool from a `git archive` of each in one call
(parent, this, this, parent) and reading the JSON lines side by side.

    python -m kuiperllama_tpu_torch.tools.gemm_costs [--rounds 3]
`--layer` times the same kernels on a Llama-2-7B layer's four projections
at M of LAYER_ROWS (and a 7B token's 129 GEMV calls at M = 1), in the same
interleaved rounds, and prints each kernel's sum; `--graph` replays the
GEMMs' layers from CUDA graphs instead, as the decode and prefill steps do.

    python -m kuiperllama_tpu_torch.tools.gemm_costs --fit
    python -m kuiperllama_tpu_torch.tools.gemm_costs --layer [--graph]
"""

from __future__ import annotations

import argparse
import json
import statistics
from concurrent.futures import ThreadPoolExecutor

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
# the wgmma route's entry returns before its reduce_splits launch
_NO_SUM = ("  if (err != cudaSuccess || splits == 1) return err;\n  return y_bf16 ? sum_",
           "  if (err != cudaSuccess || splits >= 1) return err;\n  return y_bf16 ? sum_")
# (old, new) substitutions in csrc/quant_gemm.cu, each found exactly once
WGMMA_VARIANTS = {
    "wgmma_ring_only": [(
        "    mbar_wait(smem_u32(&full[st]), (it / stages) & 1);\n",
        "    mbar_wait(smem_u32(&full[st]), (it / stages) & 1);\n"
        "    if (lane < 32) {\n"
        "      if (it > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(it - 1) % stages]));\n"
        "      continue;\n"
        "    }\n")],
    "wgmma_no_sum": [_NO_SUM],
    "wgmma_empty": [_NO_SUM, (
        "  __shared__ __align__(8) uint64_t full[kTmaMaxStages], empty[kTmaMaxStages];\n",
        "  if (M > 0) return;\n"
        "  __shared__ __align__(8) uint64_t full[kTmaMaxStages], empty[kTmaMaxStages];\n")],
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
# (old, new) substitutions in csrc/quant_gemv.cu, each found exactly once
GEMV_VARIANTS = {
    "gemv_no_sum": [("  if (!SPLIT) return;\n  // the last block", "  return;\n  // the last block")],
    "gemv_empty": [("  extern __shared__ float smem[];\n  const int nwarps",
                    "  if (N > 0) return;\n  extern __shared__ float smem[];\n  const int nwarps")],
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
    """`text` (csrc/quant_gemm.cu, or csrc/quant_gemv.cu for a GEMV_VARIANTS
    name) with variant `name`'s substitutions; raises if a piece no longer
    occurs exactly once."""
    for old, new in {**WGMMA_VARIANTS, **GEMV_VARIANTS}[name]:
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


def with_lib(lib, fn, source=qm.GEMM_SOURCE, mod=build):
    """fn with `source`'s library in the build module `mod` swapped for
    `lib` while it runs."""
    def call(*args):
        kept = mod._libs.get(source)
        mod._libs[source] = lib
        try:
            return fn(*args)
        finally:
            mod._libs[source] = kept
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


# ---------------------------------------------------------------------------
# --fit: a call's fixed cost apart from its stream

FIT_K = (4096, 11008)
FIT_N = (1024, 2048, 4096, 8192, 12288, 16384, 22016)
FIT_ROWS = (1, 8, 32, 128)
FIT_GROUP = 256
WGMMA_FIT = ("wgmma_ring_only", "wgmma_no_sum", "wgmma_empty", "wgmma_one_wave")
GEMV_KERNELS = ("gemv", *GEMV_VARIANTS)
FIT_KERNELS = (*GEMV_KERNELS, "wgmma", *WGMMA_FIT, "mma_sync", "library")


def takes(kernel, M):
    """Whether `kernel` runs at M rows: the GEMVs at one, the GEMMs past it,
    the library at any."""
    return kernel == "library" or (kernel in GEMV_KERNELS) == (M == 1)


def fit_line(nbytes, us):
    """The least-squares line us = a + nbytes / BW: (a in us, BW in TB/s,
    each point's residual in us)."""
    n = len(us)
    mb, mu = sum(nbytes) / n, sum(us) / n
    sxx = sum((b - mb) ** 2 for b in nbytes)
    slope = sum((b - mb) * (u - mu) for b, u in zip(nbytes, us)) / sxx  # us a byte
    a = mu - slope * mb
    return a, 1e-6 / slope, [u - a - slope * b for b, u in zip(nbytes, us)]


def fit_libs(kernels):
    """Builds at once this checkout's two sources and the source variants
    `kernels` name. Returns {variant: loaded library}."""
    from .big_phase_costs import build_variants

    jobs = {}
    for name in kernels:
        if name in WGMMA_VARIANTS or name in GEMV_VARIANTS:
            source = qm.GEMV_SOURCE if name in GEMV_VARIANTS else qm.GEMM_SOURCE
            text = variant_source(name, (build.CSRC / f"{source}.cu").read_text())
            jobs[name] = (source, {f"{source}.cu": text})
    with ThreadPoolExecutor(2) as pool:
        own = pool.submit(build.build, [qm.GEMM_SOURCE, qm.GEMV_SOURCE])
        built = pool.submit(build_variants, jobs) if jobs else None
        own.result()
        return {n: lib for n, (lib, _) in built.result().items()} if built else {}


def one_wave_kps(M, K, N, sms):
    """The wgmma route's split with its blocks capped at the SM slots (two
    an SM up to 64 rows, else one): one wave."""
    slots = sms * (2 if -(-M // 8) * 8 <= 64 else 1)
    splits = max(1, min(-(-K // qm.gemm_wgmma_plan(M, K, N, sms)), slots // -(-N // 128)))
    return -(-K // (splits * 64)) * 64


def fit_fns(g, libs):
    """{kernel: fn(x, q, s)} of every --fit kernel, through the wrappers;
    a source variant on its own library."""
    fns = {"gemv": lambda x, q, s: qm.gemv_launch(x, q, s, g),
           "wgmma": lambda x, q, s: qm.gemm_launch(x, q, s, g, "wgmma"),
           "wgmma_one_wave": lambda x, q, s: qm.gemm_launch(
               x, q, s, g, "wgmma", k_per_split=one_wave_kps(x.shape[0], *q.shape,
                                                             qm._sms(x.device))),
           "mma_sync": lambda x, q, s: qm.gemm_launch(x, q, s, g, "mma_sync")}
    for name, lib in libs.items():
        if name in GEMV_VARIANTS:
            fns[name] = with_lib(lib, fns["gemv"], qm.GEMV_SOURCE)
        elif name in WGMMA_VARIANTS:
            fns[name] = with_lib(lib, fns["wgmma"])
    return fns


def fit_grid(name, M, K, N, g, sms):
    """Blocks a call of kernel `name` launches and the SM slots they fill
    at once: the waves."""
    if name in GEMV_KERNELS:
        ct = qm.gemv_col_threads(K, N, g, sms)
        gps = qm.gemv_plan(K, N, g, sms, col_threads=ct)
        blocks = -(-N // (16 * ct)) * -(-(K // g) // gps)
        slots = sms * qm._GEMV_BLOCKS_PER_SM[ct]
    elif name == "mma_sync":
        kps = qm.gemm_k_per_split(M, K, N, sms)
        blocks = -(-N // 128) * -(-M // qm.gemm_block_rows(M)) * -(-K // kps)
        slots = sms * qm._GEMM_BLOCKS_PER_SM
    else:
        kps = (one_wave_kps(M, K, N, sms) if name == "wgmma_one_wave"
               else qm.gemm_wgmma_plan(M, K, N, sms))
        blocks = -(-N // 128) * -(-K // kps)
        slots = sms * (2 if -(-M // 8) * 8 <= 64 else 1)
    return dict(blocks=blocks, slots=slots, waves=blocks / slots)


def profiled_us(fn, rot):
    """(device us a call apart from reduce_splits, reduce_splits us a
    call) by torch.profiler."""
    split = kernel_split(fn, rot)
    main = sum(v["us"] * max(1, round(v["per_call"])) for k, v in split.items()
               if "reduce_splits" not in k)
    red = sum(v["us"] * max(1, round(v["per_call"])) for k, v in split.items()
              if "reduce_splits" in k)
    return main, red


def fit_point(dev, K, N, M, kernels, fns, rounds, seed):
    """One (K, N, M) point: each kernel's median us by CUDA events over
    `rounds` interleaved rounds, its profiled split and grid."""
    g = FIT_GROUP
    x, q, s = operands(dev, M, K, N, g, seed)
    qs = [q] + [q.clone() for _ in range(l2_copies(K * N, dev) - 1)]
    rot = [(x, qc, s) for qc in qs]
    lib = None
    if "library" in kernels:
        wd = qm.dequantize_bf16(q, s, g)
        lib = [(x, wd)] + [(x, wd.clone()) for _ in range(l2_copies(2 * K * N, dev) - 1)]
    us = {k: [] for k in kernels}
    for r in range(rounds):  # every other round backwards
        for k in (kernels if r % 2 == 0 else kernels[::-1]):
            fn, ops = (torch.matmul, lib) if k == "library" else (fns[k], rot)
            us[k].append(device_time(fn, variants=ops, iters=ITERS, device="cuda") * 1e6)
    sms = qm._sms(dev)
    out = []
    for k in kernels:
        fn, ops = (torch.matmul, lib) if k == "library" else (fns[k], rot)
        main, red = profiled_us(fn, ops)
        row = dict(point="fit", kernel=k, K=K, N=N, M=M, g=g,
                   stream_bytes=(2 if k == "library" else 1) * K * N,
                   us=statistics.median(us[k]), us_rounds=us[k], device_us=main,
                   reduce_splits_us=red)
        if k != "library":
            row.update(fit_grid(k, M, K, N, g, sms))
        out.append(row)
        print(json.dumps(row), flush=True)
    del qs, rot, lib
    return out


def run_fit(dev, kernels, rounds):
    """Every point of the sweep, then one fit line per kernel and M."""
    from .roofline import probe_read

    libs = fit_libs(kernels)
    fns = fit_fns(FIT_GROUP, libs)
    read = probe_read(dev)
    points = []
    seed = 0
    for M in FIT_ROWS:
        ks = [k for k in kernels if takes(k, M)]
        for K in FIT_K:
            for N in FIT_N:
                seed += 1
                points += fit_point(dev, K, N, M, ks, fns, rounds, seed)
    fits = []
    for k in kernels:
        for M in FIT_ROWS:
            pts = [p for p in points if p["kernel"] == k and p["M"] == M]
            if len(pts) < 3:
                continue
            nbytes = [p["stream_bytes"] for p in pts]
            a, bw, res = fit_line(nbytes, [p["us"] for p in pts])
            da, dbw, dres = fit_line(nbytes, [p["device_us"] for p in pts])
            row = dict(fit=k, M=M, points=len(pts), intercept_us=a, slope_TBps=bw,
                       residuals_us=res, max_abs_residual_us=max(map(abs, res)),
                       device_intercept_us=da, device_slope_TBps=dbw,
                       device_max_abs_residual_us=max(map(abs, dres)),
                       reduce_splits_us=[p["reduce_splits_us"] for p in pts],
                       waves=[p.get("waves") for p in pts], probe_read_GBps=read)
            print(json.dumps(row), flush=True)
            fits.append(row)
    return points, fits


# --layer: a Llama-2-7B layer's four projections (and, at M = 1, the
# lm_head) at these rows, per kernel
LAYER_ROWS = (1, 8, 32, 128, 255)
LAYERS = 32
GRAPH_LAYERS = 8  # layers of weight copies one captured graph walks


def graph_layer_us(dev, M, fns, kernels, rounds, seed):
    """Per kernel, us a 7B layer's four projections take replayed from one
    CUDA graph (as a decode or prefill step replays them): GRAPH_LAYERS
    layers of distinct weight copies (past the L2) captured once, each
    replay timed by CUDA events, kernels in alternating rounds; the best
    replay per kernel."""
    from ..utils.profiling import event_times

    names = ["wqkv", "wo", "w13", "w2"]
    layers = []
    for j in range(GRAPH_LAYERS):
        layers.append([operands(dev, M, *SHAPES[n], FIT_GROUP, seed + 10 * j + i)
                       for i, n in enumerate(names)])
    graphs = {}
    for k in kernels:
        for ops in layers[0]:
            fns[k](*ops)  # the first calls size the workspace outside the capture
        torch.cuda.synchronize(dev)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for layer in layers:
                for ops in layer:
                    fns[k](*ops)
        graphs[k] = g
    best = {k: float("inf") for k in kernels}
    for r in range(rounds):
        for k in (kernels if r % 2 == 0 else kernels[::-1]):
            t = min(event_times(graphs[k].replay, 3, dev))
            best[k] = min(best[k], t * 1e6 / GRAPH_LAYERS)
    return best


def run_layer(dev, kernels, rounds, graph=False):
    """Per M of LAYER_ROWS, each kernel's time on a 7B layer (the sum of its
    four projections' medians) and, at M = 1, a 7B token's (32 layers and
    the lm_head), from interleaved rounds; with `graph` the GEMMs' layer
    replayed from a CUDA graph instead (`graph_layer_us`). One JSON line
    per M."""
    libs = fit_libs(kernels)
    fns = fit_fns(FIT_GROUP, libs)
    rows = []
    if graph:
        for i, M in enumerate(LAYER_ROWS[1:]):
            ks = [k for k in kernels if takes(k, M) and k != "library"]
            row = dict(layer=M, graph=True, kernels=ks,
                       layer_us=graph_layer_us(dev, M, fns, ks, rounds, 1000 * i))
            print(json.dumps(row), flush=True)
            rows.append(row)
        return rows
    for i, M in enumerate(LAYER_ROWS):
        ks = [k for k in kernels if takes(k, M)]
        names = ["wqkv", "wo", "w13", "w2"] + (["lm_head"] if M == 1 else [])
        pts = {name: fit_point(dev, *SHAPES[name], M, ks, fns, rounds, 100 * i + j)
               for j, name in enumerate(names)}
        layer = {k: sum(next(p["us"] for p in pts[n] if p["kernel"] == k) for n in names[:4])
                 for k in ks}
        row = dict(layer=M, kernels=ks, layer_us=layer,
                   by_weight={n: {p["kernel"]: p["us"] for p in pts[n]} for n in names},
                   bound_us=sum(max(bound_us(M, *SHAPES[n], FIT_GROUP)) for n in names[:4]))
        if M == 1:
            row["token_ms"] = {k: (LAYERS * layer[k] + next(
                p["us"] for p in pts["lm_head"] if p["kernel"] == k)) / 1e3 for k in ks}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--variants", default=None,
                    help=f"default: {','.join(VARIANTS)}; with --fit the kernels "
                         "of FIT_KERNELS this run has")
    ap.add_argument("--cells", default=None, help="name:M[,name:M...] (default: all)")
    ap.add_argument("--fit", action="store_true",
                    help="the fixed cost and stream rate of each kernel by a fit over N")
    ap.add_argument("--layer", action="store_true",
                    help="each kernel on a 7B layer (and token, at M = 1) by LAYER_ROWS")
    ap.add_argument("--graph", action="store_true",
                    help="with --layer: the GEMMs' layers replayed from CUDA graphs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gemm_costs: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    if args.fit or args.layer:
        kernels = tuple(args.variants.split(",")) if args.variants else FIT_KERNELS
        if set(kernels) - set(FIT_KERNELS):
            raise SystemExit(f"gemm_costs: --fit kernels are {FIT_KERNELS}")
        if args.layer:
            run_layer(dev, kernels, args.rounds, args.graph)
        if args.fit:
            run_fit(dev, kernels, args.rounds)
    else:
        variants = tuple(args.variants.split(",")) if args.variants else VARIANTS
        if set(variants) - set(VARIANTS):
            raise SystemExit(f"gemm_costs: variants are {VARIANTS}")
        cells = CELLS
        if args.cells:
            want = set(args.cells.split(","))
            cells = [c for c in CELLS if f"{c[0]}:{c[1]}" in want]
        run(dev, cells, variants, args.rounds)
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    main()
