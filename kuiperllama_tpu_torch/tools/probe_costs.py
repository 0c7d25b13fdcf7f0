#!/usr/bin/env python
"""Probe: what a call of the two exp_kernel probes costs, beside its
yardsticks.

At the five TinyLlama-1.1B shapes (`exp_kernel.SHAPES`), with the operands
`exp_kernel.main` makes (Q8_0 of normal draws, group 64, fp32 scales, bf16
x of M = 8 rows), each time the median of 25 calls by CUDA events on
operand copies rotated past the 50 MB L2 (`utils.profiling.device_time`):
  floor     one launch of an empty kernel through the same ctypes path
            (`exp_kernel.empty_launch`), once
  stream    `exp_stream` at every stream tile of the JAX tool that divides
            the shape
  outscale  `exp_outscale` at the shape's sweep tile
  library   bf16 x @ the dequantized bf16 weight (`torch.matmul`)
  gemm      the port's GEMM (`quant_gemm`, fast mode) on the same operands
and, for each probe, every device kernel of one call with its us per
launch and launches per call (torch.profiler over 20 calls): the kernel
and any finishing pass apart. `bound_us` is the bytes the function must
move over 3.35 TB/s. Where the tree offers them, one launch asks whether
a cooperative launch takes a cluster dimension. Then, at each shape's sweep tile, both probes at split
plans for 1 to 8 blocks per SM, and, in turns with the kept kernel, twice,
built from source variants of csrc/exp_kernel.cu (one nvcc each, all at
once) with one piece changed or taken out:
  cluster_sum      the stream's row splits added inside thread-block
                   clusters through distributed shared memory first, one
                   ticket a cluster (timed with the kept kernel in each
                   stream row, `sum_via`, at r rounded up to a multiple of 8)
  sc_fences        the split counter's ticket as a relaxed atomic between
                   two sequentially consistent fences (__threadfence)
  no_split_sum     the splits write their partials and exit: no counter or
                   last-block sum (the value is wrong)
  no_finish_sum    the counter's ticket, but the last block does not sum
                   (the value is wrong)
  no_weight_bytes  every weight load reads the first 2 MB of q, which stay
                   in L2: the weight bytes leave L2, not HBM (the value is
                   wrong)
  finish_pass      outscale's splits summed by a second kernel (launched
                   with programmatic dependent launch), not by the last
                   block behind a counter
Prints one JSON line per row, then the card's nvidia-smi line. Needs the
card.

`--tree DIR` measures another checkout's package instead (a `git archive`
of an earlier commit): the script runs again as a child process with DIR
first on the import path, which is why it imports the package by its
absolute name. What that tree lacks (the floor, the variants) is left out.

    python -m kuiperllama_tpu_torch.tools.probe_costs [--tree DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from kuiperllama_tpu_torch.ops.kernels import build
from kuiperllama_tpu_torch.ops.kernels import quant_matmul as qm
from kuiperllama_tpu_torch.quant import quantize_q80
from kuiperllama_tpu_torch.tools import HBM_SHEET_GBPS
from kuiperllama_tpu_torch.tools import exp_kernel as ek
from kuiperllama_tpu_torch.utils.profiling import device_time, l2_copies, nvidia_smi_line

HBM_BYTES_PER_S = HBM_SHEET_GBPS * 1e9
ITERS = 25
PROFILED_CALLS = 20
PLANS = (1, 2, 3, 4, 6, 8)  # blocks per SM
# finish_pass: the outscale splits' sum as a second kernel, launched with
# programmatic dependent launch so that it is set up while the first runs
FINISH_KERNEL = r"""
__global__ void __launch_bounds__(128)
outscale_finish(const float* __restrict__ partial, __nv_bfloat16* __restrict__ y, int n4,
                int Z, int r) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int i = blockIdx.x * 128 + threadIdx.x;
  if (i >= n4) return;
  const float4* p = reinterpret_cast<const float4*>(partial) + i;
  float4 tot = make_float4(0.f, 0.f, 0.f, 0.f), til = tot;
  for (int z0 = 0; z0 < Z; z0 += 16) {
    float4 v[16];
#pragma unroll
    for (int b = 0; b < 16; ++b)
      v[b] = z0 + b < Z ? __ldcg(p + (size_t)(z0 + b) * n4) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      if (z0 + b >= Z) break;
      const int spz = (z0 + b) % r;
      til = spz == 0 ? v[b] : add4(til, v[b]);
      if (spz == r - 1) tot = add4(tot, til);
    }
  }
  store_bf16x4(y + 4 * (size_t)i, tot.x, tot.y, tot.z, tot.w);
}

template <typename XT, typename ST, int NT>
cudaError_t launch_outscale("""
LAUNCH_TAIL = """      static_cast<__nv_bfloat16*>(y), M, K, N, tk, r, vec);
  return cudaGetLastError();
}"""
LAUNCH_TAIL_PASS = """      static_cast<__nv_bfloat16*>(y), M, K, N, tk, r, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || grid.y == 1) return err;
  const int n4 = M * N / 4;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n4 + 127) / 128);
  cfg.blockDim = dim3(128);
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, outscale_finish, static_cast<const float*>(partial),
                           static_cast<__nv_bfloat16*>(y), n4, (int)grid.y, r);
  return err != cudaSuccess ? err : cudaGetLastError();
}"""
# cluster_sum: the stream's row splits added inside thread-block clusters
# (C blocks along a tile's splits, C the largest power of two up to 8 that
# divides r) through distributed shared memory, then one ticket a cluster
STREAM_SUM = """  const int v = block_sum(acc);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partial[(size_t)j * gridDim.y + z] = v;
    // only the last column tile's blocks count: its sums are the value
    last = j == gridDim.x - 1 && ticket(counter) == gridDim.y - 1;
  }
  __syncthreads();
  if (!last) return;
  // Tile sums of the last column in int64 (warp w takes tiles w, w + 8, ...),
  // then thread 0 adds them as fp32 in k order.
  const int n_k = gridDim.y / r, P = r;
  const int* p = partial + (size_t)j * gridDim.y;
"""
STREAM_SUM_CLUSTER = """  int v = block_sum(acc);
  __shared__ int mine;
  cg::cluster_group cl = cg::this_cluster();
  if (threadIdx.x == 0) mine = v;
  cl.sync();
  const unsigned rank = cl.block_rank(), C = cl.num_blocks();
  if (rank == 0 && threadIdx.x < 32) {
    v = threadIdx.x < C ? *cl.map_shared_rank(&mine, threadIdx.x) : 0;
    v = warp_sum(v);
  }
  cl.sync();
  if (rank != 0) return;
  const int per_col = gridDim.y / C;
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partial[(size_t)j * per_col + z / C] = v;
    last = j == gridDim.x - 1 && ticket(counter) == (unsigned)per_col - 1;
  }
  __syncthreads();
  if (!last) return;
  const int n_k = gridDim.y / r, P = per_col / n_k;
  const int* p = partial + (size_t)j * per_col;
"""
STREAM_LAUNCH = """  if (vec) stream_kernel<true><<<grid, kStreamThreads, 0, st>>>(qp, pp, cp, op, N, tk, tn, r);
  else stream_kernel<false><<<grid, kStreamThreads, 0, st>>>(qp, pp, cp, op, N, tk, tn, r);
  return static_cast<int>(cudaGetLastError());"""
STREAM_LAUNCH_CLUSTER = """  unsigned C = 1;
  while (C < 8 && r % (2 * C) == 0) C *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kStreamThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = C;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      vec ? cudaLaunchKernelEx(&cfg, stream_kernel<true>, qp, pp, cp, op, N, tk, tn, r)
          : cudaLaunchKernelEx(&cfg, stream_kernel<false>, qp, pp, cp, op, N, tk, tn, r);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());"""
# (old, new) pieces of csrc/exp_kernel.cu, each of which occurs once
SUBSTITUTIONS = {
    "cluster_sum": [(STREAM_SUM, STREAM_SUM_CLUSTER), (STREAM_LAUNCH, STREAM_LAUNCH_CLUSTER)],
    "sc_fences": [("""  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\\n"
               : "=r"(old) : "l"(counter) : "memory");
  return old;""", """  __threadfence();
  const unsigned old = atomicAdd(counter, 1u);
  __threadfence();
  return old;""")],
    "no_split_sum": [("    last = j == gridDim.x - 1 && ticket", "    last = false && ticket"),
                     ("  if (direct) return;\n", "  return;\n")],
    "no_finish_sum": [
        ("    last = j == gridDim.x - 1 && ticket(counter) == gridDim.y - 1;\n",
         "    if (j == gridDim.x - 1 && ticket(counter) == gridDim.y - 1) *counter = 0u;\n"
         "    last = false;\n"),
        ("  if (!last) return;\n  constexpr int RM",
         "  if (true) {\n    if (last && tid == 0) counters[blockIdx.x] = 0u;\n    return;\n  }\n"
         "  constexpr int RM")],
    "finish_pass": [("  if (direct) return;\n", "  return;\n"),
                    ("\ntemplate <typename XT, typename ST, int NT>\ncudaError_t launch_outscale(",
                     FINISH_KERNEL),
                    (LAUNCH_TAIL, LAUNCH_TAIL_PASS)],
    "no_weight_bytes": [
        ("base + (size_t)(e / vpr) * N) + e % vpr",
         "q + ((base - q + (size_t)(e / vpr) * N) & ((1 << 21) - 1))) + e % vpr"),
        ("in ? q + (size_t)(k0 + r) * N + n0 + c : q",
         "in ? q + (((size_t)(k0 + r) * N + n0 + c) & ((1 << 21) - 1)) : q")],
}


def operands(dev, K, N, seed=0):
    """x bf16 [8, K], q int8 [K, N], s fp32 [K / 64, N], as exp_kernel.run
    makes them."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    w = quantize_q80(torch.randn((K, N), generator=gen, device=dev), ek.G)
    x = torch.randn((ek.M_DECODE, K), generator=gen, device=dev).to(torch.bfloat16)
    return x, w.q, w.s


def outscale_bytes(M, K, N):
    """x bf16, q, fp32 scales and the bf16 output, each moved once."""
    return M * K * 2 + K * N + (K // ek.G) * N * 4 + M * N * 2


def us(fn, variants):
    return device_time(fn, variants=variants, iters=ITERS, device="cuda") * 1e6


def kernel_split(fn, variants):
    """{device kernel name: {us per launch, launches per call}} over
    PROFILED_CALLS calls of fn, by torch.profiler (which can lose a ctypes
    launch's record: launches per call may read below 1)."""
    from torch.profiler import ProfilerActivity, profile

    fn(*variants[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(PROFILED_CALLS):
            fn(*variants[i % len(variants)])
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total, n = by.get(e.name, (0.0, 0))
            by[e.name] = (total + e.time_range.elapsed_us(), n + 1)
    return {name[:80]: dict(us=total / n, per_call=n / PROFILED_CALLS)
            for name, (total, n) in by.items()}


def variant_source(name: str, text: str) -> str:
    """`text` (csrc/exp_kernel.cu) with variant `name`'s substitutions;
    raises if a piece no longer occurs exactly once."""
    for old, new in SUBSTITUTIONS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    return text


def variant_libs() -> dict:
    """{variant: the loaded library of its source}, one nvcc each, all at once."""
    from kuiperllama_tpu_torch.tools.big_phase_costs import build_variants

    text = (build.CSRC / f"{ek.SOURCE}.cu").read_text()
    jobs = {f"probe_{name}": (ek.SOURCE, {f"{ek.SOURCE}.cu": variant_source(name, text)})
            for name in SUBSTITUTIONS}
    return {tag[len("probe_"):]: lib for tag, (lib, _) in build_variants(jobs).items()}


def with_lib(lib, fn):
    """fn() with `lib` in place of the built csrc/exp_kernel.cu."""
    kept = build.load(ek.SOURCE)
    build._libs[ek.SOURCE] = lib
    try:
        return fn()
    finally:
        build._libs[ek.SOURCE] = kept


def run_plans(dev, emit, libs):
    """Both probes at each shape's sweep tile under every plan of PLANS,
    then, in turns and twice, under the kept kernel and each source variant
    that changes them at their default plans."""
    sms, cases = ek.sm_count(dev), []
    for i, (name, (K, N)) in enumerate(ek.SHAPES.items()):
        x, q, s = operands(dev, K, N, seed=i)
        qs = [(q,)] + [(q.clone(),) for _ in range(l2_copies(K * N, dev) - 1)]
        tiles = [(tk, tn) for tk, tn in ek.STREAM_TILES if K % tk == 0 and N % tn == 0]
        cases.append((name, K, N, x, s, qs, tiles[0] if tiles else None,
                      ek.sweep_tiles(K, N)))
    for name, K, N, x, s, qs, st, (tk, _) in cases:
        row = dict(probe="plans", shape=name, outscale_us={b: us(
            lambda qq: ek.outscale_launch(x, qq, s, tk, ek.outscale_plan(K, N, tk, sms, b)),
            qs) for b in PLANS})
        if st:
            row["stream_us"] = {b: us(
                lambda qq: ek.stream_launch(qq, *st, ek.stream_plan(K, N, *st, sms, b)), qs)
                for b in PLANS}
        emit(row)

    def times(x, s, qs, st, tk, tn):
        row = dict(outscale_us=us(lambda qq: ek.exp_outscale(x, qq, s, tk, tn), qs))
        if st:
            row["stream_us"] = us(lambda qq: ek.exp_stream(qq, *st), qs)
        return row

    for rnd in range(2):
        for variant, lib in libs.items():
            if variant == "cluster_sum":  # no cluster at most default plans: sum_via
                continue
            for name, K, N, x, s, qs, st, (tk, tn) in cases:
                emit(dict(probe="variant", variant=variant, round=rnd, shape=name,
                          **with_lib(lib, lambda: times(x, s, qs, st, tk, tn))))


def run(dev, label):
    """Every row of the probe on `dev`; prints and returns them."""
    rows = []

    def emit(row):
        row = dict(row, tree=label)
        print(json.dumps(row), flush=True)
        rows.append(row)

    libs = {"kernel": build.load(ek.SOURCE), **variant_libs()} if hasattr(
        ek, "stream_launch") else {}
    floor = None
    if hasattr(ek, "empty_launch"):
        floor = us(lambda: ek.empty_launch(dev), [()])
        emit(dict(probe="floor", us=floor,
                  kernels=kernel_split(lambda: ek.empty_launch(dev), [()])))
    if hasattr(ek, "coop_cluster_probe"):
        emit(dict(probe="coop_cluster", **ek.coop_cluster_probe(dev)))
    for i, (name, (K, N)) in enumerate(ek.SHAPES.items()):
        x, q, s = operands(dev, K, N, seed=i)
        qs = [(q,)] + [(q.clone(),) for _ in range(l2_copies(K * N, dev) - 1)]
        tiles = [(tk, tn) for tk, tn in ek.STREAM_TILES if K % tk == 0 and N % tn == 0]
        for j, (tk, tn) in enumerate(tiles):
            fn = lambda qq: ek.exp_stream(qq, tk, tn)  # noqa: E731
            row = dict(probe="stream", shape=name, K=K, N=N, tk=tk, tn=tn, sweep=j == 0,
                       us=us(fn, qs), floor_us=floor,
                       bound_us=K * N / HBM_BYTES_PER_S * 1e6,
                       kernels=kernel_split(fn, qs))
            if libs:
                r = ek.stream_plan(K, N, tk, tn, ek.sm_count(dev))
                r8 = min(tk, -(-r // 8) * 8)
                row.update(plan=r, sum_via=dict(r=r8, **{
                    way: with_lib(libs[name], lambda: us(
                        lambda qq: ek.stream_launch(qq, tk, tn, r8), qs))
                    for way, name in (("l2", "kernel"), ("cluster", "cluster_sum"))}))
            emit(row)
        tk, tn = ek.sweep_tiles(K, N)
        fn = lambda qq: ek.exp_outscale(x, qq, s, tk, tn)  # noqa: E731
        wd = qm.dequantize_bf16(q, s, ek.G)
        wds = [(x, wd)] + [(x, wd.clone()) for _ in range(l2_copies(2 * K * N, dev) - 1)]
        row = dict(probe="outscale", shape=name, M=x.shape[0], K=K, N=N, tk=tk, tn=tn,
                   sweep=True,
                   us=us(fn, qs), floor_us=floor,
                   library_us=us(torch.matmul, wds),
                   gemm_us=us(lambda qq: qm.quant_gemm(x, qq, s, ek.G), qs),
                   bound_us=outscale_bytes(x.shape[0], K, N) / HBM_BYTES_PER_S * 1e6,
                   kernels=kernel_split(fn, qs))
        if hasattr(ek, "outscale_plan"):
            row["plan"] = ek.outscale_plan(K, N, tk, ek.sm_count(dev))
        emit(row)
        del qs, wd, wds
    # a sweep: every shape once, the stream at its first tile (chip_smoke's)
    for probe in ("stream", "outscale"):
        sel = [r for r in rows if r["probe"] == probe and r["sweep"]]
        emit(dict(probe=f"{probe}_sweep", us=sum(r["us"] for r in sel),
                  bound_us=sum(r["bound_us"] for r in sel),
                  shapes=[f"{r['shape']} {r['tk']}x{r['tn']}" for r in sel]))
    if libs:
        run_plans(dev, emit, libs)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=None,
                    help="measure the package of this checkout instead")
    ap.add_argument("--label", default=".", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.tree:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(args.tree))
        return subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--label", args.tree], env=env, check=True).returncode
    if not torch.cuda.is_available():
        raise SystemExit("probe_costs: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    run(dev, args.label)
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    main()
