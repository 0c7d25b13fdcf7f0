#!/usr/bin/env python
"""Benchmark harness of the PyTorch/CUDA port (kuiperllama_tpu_torch), a
port of bench.py. Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

The default run: Llama-2-7B INT8 (group 256, bf16 scales, fused qkv and
gate/up) greedy decode at B = 1 on one card, tokens/s with roofline
accounting, with the kernels' selftest errors merged in. `--model
tinyllama-1.1b` for the reference's headline model, `--engine` for
continuous batching over the paged KV cache (tokens/s, p50/p99 TTFT),
`--selftest` for the kernels against their plain versions alone.

Weights are random, drawn on the card from a seed (compute cost is that of
real weights). Roofline: the bytes a decode step must read (every weight
and scale but the embedding table, plus the bucketed KV window) over the
H100 SXM data sheet's 3.35 TB/s (`pct_of_spec_bw_roofline`) and over the
decode-shaped read rate `tools/roofline.py` `probe_gemv` measures at start
(`pct_of_roofline`). A selftest failure propagates: the run exits non-zero
with no result line.

    python3 bench_torch.py [--model llama2-7b] [--engine] [--selftest] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

# The only figure the reference publishes: TinyLlama fp32 decode at 60.34
# tokens/s on an RTX 3060 laptop GPU (its readme.md:25); another model
# class on other silicon, so pct_of_roofline is the quality signal.
REFERENCE_TOKS_PER_S = 60.34
SPEC_HBM_GBPS = 3350.0  # H100 SXM data sheet, HBM3
SPEC_BF16_TFLOPS = 989.0  # H100 SXM data sheet, dense bf16 tensor cores
# activations, blocked prefill scores and slack on top of weights and cache
ENGINE_ACT_HIGHWATER = 1_200_000_000
PAGE_SIZE = 128
# projection weights: the matmuls a prefill token multiplies through
PROJECTIONS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "wqkv", "w13")
# launch counters of every kernel the bench reaches: (kernel, module of
# ops/kernels, wrapper)
_COUNTERS = (("quant_gemv", "quant_matmul", "quant_gemv"),
             ("quant_gemm", "quant_matmul", "quant_gemm"),
             ("fused_decode", "fused_decode", "fused_decode_step"),
             ("fused_decode_chunk", "fused_decode", "fused_decode_chunk"),
             ("fused_decode_big", "fused_decode_big", "fused_decode_step_big"),
             ("paged_attention", "paged_attention", "paged_attention_flat"))


def parse_args(argv=None):
    from kuiperllama_tpu_torch.tools import add_device_arg

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="llama2-7b")
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=1024)
    ap.add_argument("--fp", action="store_true", help="bf16 weights, no quant")
    ap.add_argument("--group", type=int, default=256,
                    help="Q8_0 quant group size (the reference exports 64; "
                         "256 holds the |dppl| <= 0.1 gate: "
                         "checkpoints/tinychar_g256/GATE_PPL_G256_r05.json)")
    ap.add_argument("--no-fuse", action="store_true",
                    help="disable qkv/gate-up weight fusion")
    ap.add_argument("--scales-fp32", action="store_true",
                    help="keep fp32 quant scales (default: cast to bf16)")
    ap.add_argument("--engine", action="store_true",
                    help="continuous-batching serving bench (paged KV cache)")
    ap.add_argument("--engine-backend", default="paged", choices=["paged", "dense"],
                    help="KV backend for --engine (dense: the same scheduler "
                         "over the preallocated dense cache)")
    ap.add_argument("--engine-chunk", type=int, default=64,
                    help="decode steps per engine chunk")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked-prefill size for --engine (0 = single-shot "
                         "admission)")
    ap.add_argument("--long-prompt", type=int, default=0,
                    help="with --engine: every --long-every'th request gets "
                         "this prompt length")
    ap.add_argument("--long-every", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="with --engine: mean Poisson arrival rate (req/s); "
                         "0 = every request submitted at t0 (burst)")
    ap.add_argument("--selftest", action="store_true",
                    help="run ONLY the kernels-against-plain selftest")
    ap.add_argument("--no-selftest", action="store_true",
                    help="skip merging the selftest errors into the default "
                         "bench output")
    add_device_arg(ap)  # on the CPU: no probe and no selftest
    ap.add_argument("--verbose", action="store_true")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    if args.engine and not any(a == "--batch" or a.startswith("--batch=")
                               for a in argv):
        args.batch = 8  # serving slots; B = 1 is a latency config
    return args


def streamed_bytes_per_token(params) -> int:
    """Bytes a decode step must read: every weight and quant scale except
    the embedding table (one row gathered per token)."""
    from kuiperllama_tpu_torch.params import param_bytes

    emb = params["tok_emb"]
    return param_bytes(params) - emb.numel() * emb.element_size()


def kv_bytes_per_step(cfg, args) -> int:
    """KV-cache bytes a decode step reads: the dense-cache attention scans
    the bucketed active window of every row, every layer (k and v, bf16)."""
    from kuiperllama_tpu_torch.serving.generate import _bucket_len

    active = min(_bucket_len(args.prompt_len + args.steps + 1),
                 max(args.cache_len, 256))
    per_row = cfg.n_layers * active * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    return per_row * args.batch


def _weights(w) -> int:
    from kuiperllama_tpu_torch.quant import QuantTensor

    return (w.q if isinstance(w, QuantTensor) else w).numel()


def projection_params(params) -> int:
    """Weights of the layers' projections, which every prefill token
    multiplies through: the int8 payloads, or the float matrices under
    --fp. Norms, biases and the embedding are left out."""
    return sum(_weights(w) for name, w in params["blocks"].items()
               if name in PROJECTIONS)


def prefill_flops(params, padded_tokens: int, rows: int) -> float:
    """2 x projection weights x padded prefill tokens, plus 2 x lm_head
    weights x prefilled rows: the lm_head projects each row's last token
    only. Attention (about 1-2% at these prompt lengths) is left out."""
    return 2.0 * (projection_params(params) * padded_tokens
                  + _weights(params["lm_head"]) * rows)


def kernel_launches() -> dict:
    """Every kernel's launch count so far in this process, by kernel."""
    import importlib

    out = {}
    for name, mod, fn in _COUNTERS:
        m = importlib.import_module(f"kuiperllama_tpu_torch.ops.kernels.{mod}")
        out[name] = getattr(m, fn).launches
    return out


def _launch_delta(before: dict) -> dict:
    after = kernel_launches()
    return {k: after[k] - before[k] for k in after if after[k] - before[k]}


def make_params(args, cfg, dev):
    """Random params on `dev` (INT8 unless --fp), fused and with bf16
    scales unless told otherwise."""
    import torch

    from kuiperllama_tpu_torch.fuse import fuse_params
    from kuiperllama_tpu_torch.params import random_params_device
    from kuiperllama_tpu_torch.quant import cast_scales

    params = random_params_device(cfg, device=dev, quantize=not args.fp,
                                  group_size=args.group, dtype=torch.bfloat16)
    if not args.no_fuse:
        params = fuse_params(params)
    if not args.fp and not args.scales_fp32:
        params = cast_scales(params, torch.bfloat16)
    return params


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    args = parse_args(argv)

    from kuiperllama_tpu_torch.config import preset_config
    from kuiperllama_tpu_torch.params import param_bytes
    from kuiperllama_tpu_torch.tools import resolve_device

    dev = resolve_device(args.device)
    if args.selftest:
        if dev.type != "cuda":
            raise SystemExit("--selftest holds the kernels on the card: run it "
                             "with --device cuda")
        print(json.dumps(selftest(dev)))
        return 0

    cfg = preset_config(args.model, seq_len=max(args.cache_len, 256))
    t0 = time.perf_counter()
    params = make_params(args, cfg, dev)
    _sync(dev)
    if args.verbose:
        print(f"[bench] {args.model} params {param_bytes(params) / 1e9:.2f} GB "
              f"({time.perf_counter() - t0:.1f}s to init)", file=sys.stderr)
    probes = probe(dev, mxu=args.engine)

    if args.engine:
        print(json.dumps(bench_engine(args, cfg, params, dev, probes)))
        return 0
    out = bench_decode(args, cfg, params, dev, probes)
    if not args.no_selftest and dev.type == "cuda":
        st = selftest(dev)  # a failure propagates: no result line
        out.update({k: v for k, v in st.items()
                    if k.endswith(("_err", "_match"))})
    print(json.dumps(out))
    return 0


def probe(dev, mxu: bool) -> dict:
    """The card's decode-shaped read rate (and bf16 tensor-core rate for
    the prefill MFU), measured now by tools/roofline.py; {} on the CPU."""
    if dev.type != "cuda":
        return {}
    from kuiperllama_tpu_torch.tools import roofline

    out = {"gemv_weightread_GBps": roofline.probe_gemv(dev)}
    if mxu:
        out["mxu_bf16_TFLOPs"] = roofline.probe_mxu(dev)
    return out


def bench_decode(args, cfg, params, dev, probes) -> dict:
    """B = args.batch greedy decode through the Generator: one warm-up, then
    the best of three runs of args.steps tokens. On the card the prefill
    and the decode steps replay CUDA graphs (the Generator's default); the
    warm-up's 8 tokens open the 256-slot attention window that the timed
    runs read at the default lengths (32 + 128 tokens), so its first step
    captures the step graph, and its prefill captures the prefill's. A
    second warm-up prefill captures that graph again if the first decode
    step grew a workspace after it (a megakernel's scratch), so
    `prefill_ms` is a replay's. No timed run includes a capture
    (`graph_captures_timed` and `prefill_captures_timed` count any that
    does)."""
    import torch

    from kuiperllama_tpu_torch.serving.generate import Generator

    gen = Generator(cfg, params, cache_len=args.cache_len,
                    cache_dtype=torch.bfloat16, chunk=args.steps)
    prompts = [list(range(5, 5 + args.prompt_len))] * args.batch
    t0 = time.perf_counter()
    gen.generate_batch_ids(prompts, max_new_tokens=8)
    gen.generate_batch_ids(prompts, max_new_tokens=1)
    captures = gen.graph_cache.n_captures
    prefill_captures = gen.graph_cache.prefill.captures
    if args.verbose:
        print(f"[bench] warmup {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    best, best_prefill = 0.0, None
    for _ in range(3):
        before = kernel_launches()
        rows, prefill_s, decode_s = gen.generate_batch_ids(
            prompts, max_new_tokens=args.steps)
        launches = _launch_delta(before)
        n_tokens = sum(len(r) for r in rows)
        tps = n_tokens / decode_s
        if tps > best:
            best, best_prefill = tps, prefill_s
        if args.verbose:
            print(f"[bench] {n_tokens} tokens  prefill {prefill_s * 1e3:.1f}ms  "
                  f"decode {decode_s:.3f}s  {tps:.2f} tok/s", file=sys.stderr)

    quant = "fp" if args.fp else "int8"
    bpt = streamed_bytes_per_token(params)
    kv_step = kv_bytes_per_step(cfg, args)
    step_bytes = bpt + kv_step  # every HBM read of a decode step
    spec_roofline = SPEC_HBM_GBPS * 1e9 / step_bytes * args.batch
    measured = probes.get("gemv_weightread_GBps")
    roofline = measured * 1e9 / step_bytes * args.batch if measured else None
    return {
        "metric": f"{args.model} {quant} decode tokens/s/card (B={args.batch})",
        "value": round(best, 2),
        "unit": "tokens/s",
        "vs_baseline": round(best / REFERENCE_TOKS_PER_S, 2),
        "ms_per_token": round(1e3 * args.batch / best, 3),
        "prefill_ms": round(best_prefill * 1e3, 2),
        "weight_bytes_per_step": bpt,
        "kv_bytes_per_step": kv_step,
        "pct_of_spec_bw_roofline": round(100 * best / spec_roofline, 2),
        "roofline_toks_spec_bw": round(spec_roofline, 1),
        "roofline_toks_measured_bw": round(roofline, 1) if roofline else None,
        "pct_of_roofline": round(100 * best / roofline, 2) if roofline else None,
        "effective_GBps": round(best * step_bytes / args.batch / 1e9, 1),
        "probes": probes,
        "launches_per_run": launches,
        "decode_graphs": gen.graphs_on(),
        "graph_capture_s": round(gen.graph_cache.capture_s, 4),
        "graph_captures_timed": gen.graph_cache.n_captures - captures,
        **_prefill_graph_fields(gen.graph_cache if gen.graphs_on() else None,
                                prefill_captures),
        "device": _device_name(dev),
    }


def _prefill_graph_fields(cache, captures_before_timed: int) -> dict:
    """Whether prefills replay CUDA graphs, their captures (warm-up and
    timed runs), recaptures, seconds in captures and the captures inside the
    timed runs; None values on the eager route."""
    p = None if cache is None else cache.prefill
    return {
        "prefill_graphs": p is not None,
        "prefill_captures": None if p is None else p.captures,
        "prefill_recaptures": None if p is None else p.recaptures,
        "prefill_graph_capture_s": None if p is None else round(p.capture_s, 4),
        "prefill_captures_timed": (None if p is None
                                   else p.captures - captures_before_timed),
    }


def _device_name(dev) -> str:
    from kuiperllama_tpu_torch.tools import device_name

    return device_name(dev)


# ---------------------------------------------------------------------------
# Selftest: every kernel of the bench's paths against its plain version


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / max(float(want.float().abs().max()), 1e-6))


def _plain_of(x2, q, s, g, mode):
    """The plain version of the kernel `quant_kernel` picks for these
    operands."""
    from kuiperllama_tpu_torch.ops.kernels.quant_matmul import (quant_gemm_ref,
                                                                quant_gemv_ref)
    from kuiperllama_tpu_torch.ops.linear import GEMV_MAX_GROUPS

    K = q.shape[0]
    if x2.shape[0] == 1 and mode == "fast" and K // g <= GEMV_MAX_GROUPS:
        return quant_gemv_ref(x2, q, s, g)
    return quant_gemm_ref(x2, q, s, g, mode)


def selftest(dev) -> dict:
    """The kernels on the card against their plain versions on the same
    inputs (the keys of bench.py's selftest, whose oracles are XLA): the
    INT8 matmul in fast and exact mode at M = 8 (the GEMM) and M = 1 (the
    GEMV in fast mode), the Llama-2-7B projections of layer 1 of a 2-layer
    stack, paged attention at a GQA and an MHA geometry (fp32 pools), and
    the decode megakernel's logits at a small INT8 g 64 model. Matmul and
    megakernel errors are relative to max|plain|, attention's absolute;
    `launches` counts the kernel launches the selftest made."""
    import numpy as np
    import torch

    from kuiperllama_tpu_torch.ops.kernels.paged_attention import (
        build_work_list, paged_attention, paged_attention_flat_ref)
    from kuiperllama_tpu_torch.ops.linear import linear_layered, quant_kernel
    from kuiperllama_tpu_torch.quant import QuantTensor

    rng = np.random.default_rng(0)
    out = {"metric": "kernel selftest (card against plain) max error",
           "unit": "error", "device": _device_name(dev)}
    before = kernel_launches()

    def t(a, dtype):
        return torch.from_numpy(np.asarray(a)).to(device=dev, dtype=dtype)

    def bf16_values(*shape):
        # bf16 activations held in fp32: the kernels round x to bf16 as on
        # the path, and the outputs stay fp32, so no output rounding lands
        # the two sides a bf16 ulp apart
        return t(rng.standard_normal(shape), torch.bfloat16).float()

    K, N, g = 2048, 1024, 64
    for M, tag in ((8, ""), (1, "_m1")):
        x = bf16_values(M, K)
        q = t(rng.integers(-127, 128, (K, N)), torch.int8)
        s = t(rng.uniform(0.005, 0.02, (K // g, N)), torch.float32)
        for mode in ("fast", "exact"):
            got = quant_kernel(x, q, s, g, mode)
            out[f"quant_matmul_{mode}{tag}_rel_err"] = _rel(got, _plain_of(x, q, s, g, mode))

    # the Llama-2-7B projections at layer 1 of a 2-layer stack, as the
    # layered decode (M = 1) and the engine (M = 8) call them
    for tag, (K, N) in {"wqkv": (4096, 12288), "w13": (4096, 22016),
                        "w2": (11008, 4096)}.items():
        ws = QuantTensor(q=t(rng.integers(-127, 128, (2, K, N)), torch.int8),
                         s=t(rng.uniform(0.005, 0.02, (2, K // g, N)), torch.float32),
                         group_size=g)
        for M, mtag in ((8, ""), (1, "_m1")):
            xs = bf16_values(M, K)
            got = linear_layered(xs, ws, 1)
            want = _plain_of(xs, ws.q[1], ws.s[1], g, "fast")
            out[f"quant_matmul_layered_{tag}{mtag}_rel_err"] = _rel(got, want)
        del ws

    for tag, (KH, kv_mul, hd) in {"gqa": (4, 8, 64), "mha": (8, 1, 128)}.items():
        ps, B, S = 128, 2, 256
        H = KH * kv_mul
        q = rng.standard_normal((B, H, hd)).astype(np.float32)
        k_all = rng.standard_normal((B, S, KH, hd)).astype(np.float32)
        v_all = rng.standard_normal((B, S, KH, hd)).astype(np.float32)
        mp = S // ps
        kp = np.zeros((B * mp + 1, ps, KH * hd), np.float32)
        vp = np.zeros((B * mp + 1, ps, KH * hd), np.float32)
        pt = np.zeros((B, mp), np.int32)
        for b in range(B):
            for pi in range(mp):
                page = 1 + b * mp + pi
                pt[b, pi] = page
                kp[page] = k_all[b, pi * ps:(pi + 1) * ps].reshape(ps, KH * hd)
                vp[page] = v_all[b, pi * ps:(pi + 1) * ps].reshape(ps, KH * hd)
        sl = np.asarray([200, 129], np.int32)
        qd, kpd, vpd = (t(a, torch.float32) for a in (q, kp, vp))
        got = paged_attention(qd, kpd, vpd, pt, sl, page_size=ps)
        meta = [torch.from_numpy(a).to(dev) for a in build_work_list(pt, sl, ps)]
        acc, _, l = paged_attention_flat_ref(qd, kpd, vpd, *meta,
                                             torch.from_numpy(sl).to(dev),
                                             page_size=ps)
        want = acc / torch.clamp(l[..., None], min=1e-30)
        out[f"paged_attention_{tag}_abs_err"] = float((got - want).abs().max())

    out.update(_fused_selftest(dev))
    out["launches"] = _launch_delta(before)
    out["value"] = max(out["quant_matmul_exact_rel_err"],
                       out["paged_attention_mha_abs_err"])
    out["vs_baseline"] = 0.0
    return out


def _fused_selftest(dev) -> dict:
    """The decode megakernel against its plain version on the card, both
    followed by the lm_head: one step at pos 5 after a 5-token prefill of a
    small INT8 g 64 model (dim 512, GQA 8/4 heads)."""
    import torch

    from kuiperllama_tpu_torch.config import tiny_config
    from kuiperllama_tpu_torch.fuse import fuse_params
    from kuiperllama_tpu_torch.models import decoder
    from kuiperllama_tpu_torch.ops.kernels.fused_decode import (
        fused_decode_step, fused_decode_step_ref)
    from kuiperllama_tpu_torch.ops.linear import linear
    from kuiperllama_tpu_torch.params import random_params, to_device
    from kuiperllama_tpu_torch.quant import quantize_q80

    cfg = tiny_config("llama2", dim=512, n_heads=8, n_kv_heads=4,
                      hidden_dim=1024, vocab_size=2048, seq_len=128)
    params = to_device(random_params(cfg, seed=9), device=dev, dtype=torch.bfloat16)
    qb = dict(params["blocks"])
    for nm in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
        qb[nm] = quantize_q80(params["blocks"][nm], group_size=64)
    params = fuse_params(dict(params, blocks=qb))
    A = 128
    cache = decoder.init_kv_cache(cfg, batch=1, max_len=A, dtype=torch.bfloat16,
                                  device=dev)
    toks = torch.tensor([[3, 1, 4, 1, 5]], dtype=torch.int32, device=dev)
    last, cache = decoder.prefill(cfg, params, toks, cache)
    token = torch.argmax(last, -1).to(torch.int32)
    pos = torch.tensor([5], dtype=torch.int32, device=dev)
    L, _, _, KH, hd = cache["k"].shape
    sin, cos = decoder.build_rope(cfg, dev)
    x0 = params["tok_emb"][token.long()]
    logits = {}
    for name, step in (("kernel", fused_decode_step), ("plain", fused_decode_step_ref)):
        k = cache["k"].clone().view(L, A, KH * hd)
        v = cache["v"].clone().view(L, A, KH * hd)
        x_fin, _, _ = step(cfg, params, x0, k, v, pos, sin, cos)
        logits[name] = linear(x_fin, params["lm_head"]).float()
    got, want = logits["kernel"], logits["plain"]
    return {"fused_step_rel_err": _rel(got, want),
            "fused_step_argmax_match": bool(int(got.argmax()) == int(want.argmax()))}


# ---------------------------------------------------------------------------
# Engine bench


def engine_hbm_estimate(args, cfg, params, batch: int) -> int:
    """Weights + KV cache + an activation high-water mark for an engine
    configuration (bf16 cache)."""
    from kuiperllama_tpu_torch.params import param_bytes

    L, KH, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    S = args.cache_len
    if args.engine_backend == "dense":
        cache = 2 * L * batch * S * KH * hd * 2
    else:
        n_pages = batch * (-(-S // PAGE_SIZE)) + 1
        cache = 2 * L * n_pages * PAGE_SIZE * KH * hd * 2
    return param_bytes(params) + cache + ENGINE_ACT_HIGHWATER


def hbm_budget(params, dev) -> int:
    """What this process can hold on the card: its weights (already
    resident) plus the card's free memory now."""
    import torch

    from kuiperllama_tpu_torch.params import param_bytes

    free, _ = torch.cuda.mem_get_info(dev)
    return param_bytes(params) + free


def bench_engine(args, cfg, params, dev, probes) -> dict:
    """Continuous-batching serving bench: aggregate decode tokens/s and
    p50/p99 TTFT over a queued burst or Poisson arrivals, after the whole
    workload once as a warm-up."""
    import numpy as np
    import torch

    from kuiperllama_tpu_torch.serving.engine import Engine, PagedEngine, Request

    # memory precheck: halve the slots rather than fail mid-bench
    batch = requested = args.batch
    est = engine_hbm_estimate(args, cfg, params, batch)
    budget = hbm_budget(params, dev) if dev.type == "cuda" else None
    if budget is not None:
        while batch > 1 and est > budget:
            batch //= 2
            est = engine_hbm_estimate(args, cfg, params, batch)
        if batch != requested:
            print(f"[bench] memory precheck: {est / 1e9:.1f} GB at batch="
                  f"{requested} exceeds the card's {budget / 1e9:.1f} GB; "
                  f"batch={batch}", file=sys.stderr)
    args.batch = batch

    common = dict(max_batch=args.batch, max_len=args.cache_len,
                  chunk=args.engine_chunk, cache_dtype=torch.bfloat16)
    if args.engine_backend == "dense":
        eng = Engine(cfg, params, **common)
    else:
        eng = PagedEngine(cfg, params, page_size=PAGE_SIZE,
                          prefill_chunk=args.prefill_chunk, **common)

    def plen(i):
        if args.long_prompt and i % args.long_every == 0:
            return args.long_prompt
        return args.prompt_len

    def mk():
        return [Request(prompt_ids=list(range(5, 5 + plen(i))),
                        max_new_tokens=args.steps) for i in range(args.requests)]

    eng.run(mk())  # warm-up on the whole workload: it captures every key
    prefill_captures = (eng.graph_cache.prefill.captures
                        if eng.graph_cache is not None else 0)
    eng.prefill_wall_s = 0.0
    eng.prefill_tokens = 0
    eng.prefill_padded_tokens = 0
    prefill_calls = eng.n_prefill_calls

    before = kernel_launches()
    if args.arrival_rate > 0:
        # Poisson arrivals: TTFT then measures queueing and prefill under load
        rng = np.random.default_rng(7)
        arrivals = np.cumsum(rng.exponential(1.0 / args.arrival_rate, args.requests))
        arrivals[0] = 0.0
        reqs = mk()
        t0 = time.perf_counter()
        done, i = [], 0
        while i < len(reqs) or eng.has_work:
            now = time.perf_counter() - t0
            while i < len(reqs) and arrivals[i] <= now:
                eng.submit(reqs[i])
                i += 1
            if eng.has_work:
                done.extend(eng.step())
            elif i < len(reqs):
                time.sleep(min(arrivals[i] - now, 0.05))
        wall = time.perf_counter() - t0
    else:
        t0 = time.perf_counter()
        done = eng.run(mk())
        wall = time.perf_counter() - t0
    launches = _launch_delta(before)
    total_tokens = sum(len(r.out_ids) for r in done)
    ttfts = sorted(r.ttft_s for r in done)
    p50 = ttfts[len(ttfts) // 2]
    p99 = ttfts[min(len(ttfts) - 1, int(len(ttfts) * 0.99))]
    tps = total_tokens / wall
    if args.verbose:
        print(f"[bench] engine: {len(done)} reqs, {total_tokens} tokens in "
              f"{wall:.2f}s; p50 TTFT {p50 * 1e3:.1f} ms", file=sys.stderr)
    quant = "fp" if args.fp else "int8"
    rec = {
        "metric": f"{args.model} {quant} continuous-batching decode tokens/s "
                  f"({args.engine_backend} KV, {args.requests} reqs, "
                  f"{args.batch} slots)",
        "value": round(tps, 2),
        "unit": "tokens/s",
        "vs_baseline": round(tps / REFERENCE_TOKS_PER_S, 2),
        "p50_ttft_ms": round(p50 * 1e3, 2),
        "p99_ttft_ms": round(p99 * 1e3, 2),
        "n_requests": len(done),
        "total_tokens": total_tokens,
        "wall_s": round(wall, 3),
        "prompt_len": args.prompt_len,
        "max_new_tokens": args.steps,
        "slots": args.batch,
        "backend": args.engine_backend,
        "hbm_estimate_gb": round(est / 1e9, 2),
        "hbm_budget_gb": round(budget / 1e9, 2) if budget is not None else None,
        "probes": probes,
        "launches_per_run": launches,
        "decode_graphs": eng.graph_cache is not None,
        "graph_capture_s": (round(eng.graph_cache.capture_s, 4)
                            if eng.graph_cache is not None else None),
        **_prefill_graph_fields(eng.graph_cache, prefill_captures),
        "device": _device_name(dev),
    }
    if (eng.prefill_wall_s > 0 and eng.prefill_padded_tokens
            and args.arrival_rate == 0 and not args.prefill_chunk):
        # single-shot burst admissions only: under staggered arrivals the
        # admission waits behind the decode chunk in flight, and in chunked
        # mode prefill and decode interleave, so the wall is not the
        # prefill's. Each admission is one forward over the tokens the
        # engine counts as computed (the paged engine's packed stream, the
        # dense one's [slots, T] grid), and its lm_head over `slots` rows.
        rows = (eng.n_prefill_calls - prefill_calls) * args.batch
        flops = prefill_flops(params, eng.prefill_padded_tokens, rows)
        rate = flops / eng.prefill_wall_s
        rec["prefill_wall_s"] = round(eng.prefill_wall_s, 4)
        rec["prefill_padded_tokens"] = eng.prefill_padded_tokens
        rec["prefill_tokens"] = eng.prefill_tokens
        rec["prefill_rows"] = rows
        rec["prefill_flops"] = flops
        rec["prefill_mfu_pct_spec"] = round(100.0 * rate / (SPEC_BF16_TFLOPS * 1e12), 3)
        mxu = probes.get("mxu_bf16_TFLOPs")
        rec["prefill_mfu_pct"] = round(100.0 * rate / (mxu * 1e12), 3) if mxu else None
    if args.batch != requested:
        rec["hbm_degraded_from_slots"] = requested
    if args.prefill_chunk:
        rec["prefill_chunk"] = args.prefill_chunk
    if args.long_prompt:
        rec["long_prompt"] = args.long_prompt
        rec["long_every"] = args.long_every
    if args.arrival_rate > 0:
        rec["arrival_rate_req_s"] = args.arrival_rate
    if eng.n_preemptions:
        rec["n_preemptions"] = eng.n_preemptions
    return rec


if __name__ == "__main__":
    sys.exit(main())
