#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kuiperllama_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero before the
last line:
  1. device: the card's name, power limit and count; fails without CUDA.
  2. build: nvcc builds every kernel of the path from csrc/, one process
     per source, all at once.
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the Llama-2-7B main-path shapes, with CUDA-event times (median of 25
     launches) of the kernel, the plain version and one library call
     (x @ w_bf16 with the weight dequantized ahead of time: a yardstick the
     port never calls), beside the least time the card could take.
  4. fused kernel: the decode megakernel against its plain version on the
     card at TinyLlama-1.1B INT8 g 256, Llama-3.2-1B INT8 g 256,
     Qwen2.5-0.5B bf16 and TinyLlama-1.1B INT8 g 64 (int8 activations), full
     width and 2 layers, one step at pos 100 in a 256-slot window: error,
     CUDA-event times of the kernel and the plain version, the port's
     layered eager step on the same weights, and the byte bound.
  5. fixture: checkpoints/tinychar/tinychar.q8.bin, 24 greedy tokens on the
     card equal to the same run on the CPU (which uses the plain versions);
     the layered route with fp32 params, then the megakernel route
     (fused_step=True) with bf16 params and cache.
  6. main path: Llama-2-7B at full width (INT8 group 256, bf16 scales,
     activations and cache, cache length 1024, random weights from a seed),
     Generator.generate_batch_ids on one 32-token prompt, 128 new tokens,
     greedy. Kernel launch counts are zeroed just before and read just after.
     Llama-2-7B does not fit the megakernel's plan and decodes layered.
  7. main paths of the megakernel route: TinyLlama-1.1B INT8 g 256 and
     Qwen2.5-0.5B bf16, full width and depth, the same setup and the auto
     route; each with its decode profile, then the megakernel alone at the
     main path's shapes: held against its plain version (card and CPU),
     timed, and one launch traced for the time of each phase per layer.
Then one {"kernels": [...]} line, the nvidia-smi line of the card, and the
last line {"ok": true, "device": {...}}.

Tolerances (max-abs error relative to max|plain|; the rounding is the same
on both sides, only the fp32 summation order differs): fast mode 1e-3 and
exact mode 1e-5 with fp32 outputs; a bf16 output is rounded once on each
side and may land one bf16 ulp apart, 2^-7 of max|plain|. The megakernel:
x_final and the new K/V row of every layer (each layer's rows relative to
their own max) against the plain version run on the card and run on the
CPU, in phase 4 and again at full depth in phase 7. The bf16 roundings carry
a last-bit difference of summation order through the layers, and where a
GEMV requantizes its activation to int8 a last-bit difference before it
flips an int8 rounding, so the limit is keyed on the activation type
(FUSED_TOL; PERF.md records the readings each was set from). Where the
activations stay bf16, layer 0's new K/V rows, made from the same input on
both sides, are also held within one bf16 ulp (a K row at its head's
magnitude: rope sums two products).
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12}  # dense; fp32 off the tensor cores
TOL = {"fast": 1e-3, "exact": 1e-5}
BF16_ULP = 2.0 ** -7
L2_BYTES = 50 * 2 ** 20
SEED = 0
HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = "checkpoints/tinychar/tinychar.q8.bin"

# megakernel limits by depth and by whether any GEMV takes int8 activations
FUSED_TOL = {("2 layers", False): 2e-2, ("2 layers", True): 5e-2,
             ("full depth", False): 5e-2}
FUSED_LAYERS, FUSED_POS, FUSED_WINDOW, CACHE_LEN = 2, 100, 256, 1024
# megakernel geometries: (label, preset, INT8, group size)
FUSED_CASES = [("tinyllama-1.1b", "tinyllama-1.1b", True, 256),
               ("llama3.2-1b", "llama3.2-1b", True, 256),
               ("qwen2.5-0.5b", "qwen2.5-0.5b", False, 0),
               ("tinyllama-1.1b g64", "tinyllama-1.1b", True, 64)]

# Llama-2-7B main-path projections: (name, K, N, launches per decode token)
GEMV_SHAPES = [("wqkv", 4096, 12288, 32), ("wo", 4096, 4096, 32),
               ("w13", 4096, 22016, 32), ("w2", 11008, 4096, 32),
               ("lm_head", 4096, 32000, 1)]
PREFILL_M = 32

CARD = ""


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def gpu_ms(fn, variants, n=25):
    """Median device time of `fn(v)` over n launches, by CUDA events.

    The stream is first held by a spin kernel so that the host queues all n
    launches before the first runs: the events then time the device alone,
    not the Python that launches it. `variants` rotate copies of the
    operands, so the weights do not sit in L2 between launches, as they do
    not in a decode step that streams gigabytes between two reads of one
    weight."""
    import torch

    fn(variants[0])
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(100_000_000)
    for i, (a, b) in enumerate(events):
        a.record()
        fn(variants[i % len(variants)])
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def bound(M, K, N, g, x_bytes, s_bytes, out_bytes, ops_type):
    """(bytes_ms, ops_ms): the bytes the function must move (each input read
    once, each output written once) over HBM bandwidth, and its operations
    over the peak rate of their type. The least time is the larger."""
    nbytes = M * K * x_bytes + K * N + (K // g) * N * s_bytes + M * N * out_bytes
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            2.0 * M * K * N / PEAK_OPS_PER_S[ops_type] * 1e3)


def operands(dev, M, K, N, g, seed):
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn((M, K), generator=gen, device=dev)
    q = torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                      dtype=torch.int8)
    s = torch.rand((K // g, N), generator=gen, device=dev) * 0.015 + 0.005
    return x, q, s


def rel_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


def check_kernel(kind, dev, M, K, N, g, mode, seed, name=""):
    """One shape: correctness at fp32 and at the main path's bf16 dtypes,
    then times at the main path's dtypes (bf16 x, bf16 scales)."""
    import torch

    from kuiperllama_tpu_torch.ops.kernels import quant_matmul as qm

    if kind == "quant_gemv":
        kernel = lambda x, q, s: qm.quant_gemv(x, q, s, g)
        plain = lambda x, q, s: qm.quant_gemv_ref(x, q, s, g)
    else:
        kernel = lambda x, q, s: qm.quant_gemm(x, q, s, g, mode)
        plain = lambda x, q, s: qm.quant_gemm_ref(x, q, s, g, mode)

    x, q, s = operands(dev, M, K, N, g, seed)
    err32 = rel_err(kernel(x, q, s), plain(x, q, s))
    xb, sb = x.to(torch.bfloat16), s.to(torch.bfloat16)
    got, want = kernel(xb, q, sb), plain(xb, q, sb)
    torch.cuda.synchronize()
    err16 = rel_err(got, want)
    abs16 = (got.float() - want.float()).abs().max().item()
    ok = (err32 <= TOL[mode] and err16 <= BF16_ULP
          and bool(torch.isfinite(got).all()))

    copies = max(1, math.ceil(2 * L2_BYTES / (K * N)))
    qs = [q] + [q.clone() for _ in range(copies - 1)]
    variants = [(xb, qc, sb) for qc in qs]
    ms = gpu_ms(lambda v: kernel(*v), variants)
    plain_ms = gpu_ms(lambda v: plain(*v), variants)
    wd = qm.dequantize_bf16(q, sb, g)
    lib_copies = max(1, math.ceil(2 * L2_BYTES / (2 * K * N)))
    lib_variants = [(xb, wd)] + [(xb, wd.clone()) for _ in range(lib_copies - 1)]
    library_ms = gpu_ms(lambda v: v[0] @ v[1], lib_variants)
    bytes_ms, ops_ms = bound(M, K, N, g, 2, 2, 2,
                             "bf16" if mode == "fast" else "fp32")
    del qs, variants, wd, lib_variants
    row = dict(phase="kernel", kernel=kind, weight=name, M=M, K=K, N=N, g=g,
               mode=mode,
               rel_err_fp32_out=err32, rel_err_bf16_out=err16,
               max_abs_err=abs16, ok=ok, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               bound_bytes_ms=bytes_ms, bound_ops_ms=ops_ms, card=CARD)
    emit(row)
    if not ok:
        raise AssertionError(f"{kind} disagrees with its plain version: {row}")
    return row


def phase_kernels(dev):
    gemv, gemm = [], []
    for i, (name, K, N, per_token) in enumerate(GEMV_SHAPES):
        row = check_kernel("quant_gemv", dev, 1, K, N, 256, "fast", SEED + i,
                           name)
        gemv.append((row, per_token))
    check_kernel("quant_gemv", dev, 1, 4096, 4096, 64, "fast", SEED + 10)
    for i, (name, K, N, _) in enumerate(GEMV_SHAPES[:4]):
        row = check_kernel("quant_gemm", dev, PREFILL_M, K, N, 256, "fast",
                           SEED + 20 + i, name)
        gemm.append((row, 32))
    for M in (2, 255):
        check_kernel("quant_gemm", dev, M, 4096, 12288, 256, "fast", SEED + 30 + M)
    for M in (2, 32, 255):
        check_kernel("quant_gemm", dev, M, 4096, 4096, 256, "exact", SEED + 40 + M)
    check_kernel("quant_gemm", dev, 1, 11008, 4096, 64, "fast", SEED + 50)
    return gemv, gemm


def phase_fixture(dev):
    import torch

    from kuiperllama_tpu_torch.checkpoint.binfmt import load_bin
    from kuiperllama_tpu_torch.fuse import fuse_params
    from kuiperllama_tpu_torch.params import to_device
    from kuiperllama_tpu_torch.serving.generate import Generator

    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd

    cfg, params = load_bin(os.path.join(HERE, FIXTURE))
    prompt = [1, 20, 33, 45, 60, 7, 90]
    for route, dtype, fused in (("layered", torch.float32, False),
                                ("fused", torch.bfloat16, True)):
        ids = {}
        launches = fd.fused_decode_step.launches
        for where in ("cpu", dev):
            gen = Generator(cfg, fuse_params(to_device(params, device=where,
                                                       dtype=dtype)),
                            cache_len=128, cache_dtype=dtype, fused_step=fused)
            ids[str(where)] = gen.generate_ids(prompt, max_new_tokens=24)[0]
        torch.cuda.synchronize()
        launches = fd.fused_decode_step.launches - launches
        ok = (ids["cpu"] == ids[str(dev)] and len(ids["cpu"]) == 24
              and (launches == 23 if fused else launches == 0))
        emit(dict(phase="fixture", checkpoint=FIXTURE, route=route,
                  dtype=str(dtype).replace("torch.", ""),
                  tokens_gpu=ids[str(dev)], tokens_cpu=ids["cpu"],
                  fused_decode_launches=launches, ok=ok, card=CARD))
        if not ok:
            raise AssertionError(f"tinychar greedy tokens ({route} route) "
                                 "differ between GPU and CPU")


def phase_main_path(dev):
    import torch

    from kuiperllama_tpu_torch.config import preset_config
    from kuiperllama_tpu_torch.fuse import fuse_params
    from kuiperllama_tpu_torch.models import decoder
    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd
    from kuiperllama_tpu_torch.ops.kernels import quant_matmul as qm
    from kuiperllama_tpu_torch.params import param_bytes, random_params_device
    from kuiperllama_tpu_torch.quant import cast_scales
    from kuiperllama_tpu_torch.serving.generate import Generator

    cfg = preset_config("llama2-7b", seq_len=1024)
    t0 = time.perf_counter()
    params = random_params_device(cfg, device=dev, seed=SEED, quantize=True,
                                  group_size=256)
    params = cast_scales(fuse_params(params), torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    b = params["blocks"]
    stream = [b["wqkv"], b["wo"], b["w13"], b["w2"], params["lm_head"]]
    weight_bytes = sum(param_bytes({"w": w}) for w in stream)

    gen = Generator(cfg, params, cache_len=1024, cache_dtype=torch.bfloat16,
                    chunk=128)
    prompt = list(range(5, 5 + 32))
    gen.generate_batch_ids([prompt], max_new_tokens=8)  # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats(dev)
    qm.quant_gemv.launches = 0
    qm.quant_gemm.launches = 0
    fd.fused_decode_step.launches = 0
    rows, prefill_s, decode_s = gen.generate_batch_ids([prompt],
                                                       max_new_tokens=128)
    launches = {"quant_gemv": qm.quant_gemv.launches,
                "quant_gemm": qm.quant_gemm.launches}
    fused_launches = fd.fused_decode_step.launches
    peak = torch.cuda.max_memory_allocated(dev)

    steps = len(rows[0]) - 1
    ms_per_token = decode_s / steps * 1e3
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    expect = {"quant_gemv": 1 + steps * (4 * cfg.n_layers + 1),
              "quant_gemm": 4 * cfg.n_layers}

    cache = decoder.init_kv_cache(cfg, 1, 1024, torch.bfloat16, device=dev)
    logits, _ = decoder.prefill(cfg, params, torch.tensor([prompt], device=dev),
                                cache, rope=gen.rope)
    finite = bool(torch.isfinite(logits).all())
    in_vocab = all(0 <= t < cfg.vocab_size for t in rows[0])
    ok = (len(rows[0]) == 128 and finite and in_vocab
          and logits.shape == (1, cfg.vocab_size)
          and all(launches[k] > 0 for k in launches) and launches == expect
          and fused_launches == 0 and not gen._fused_ok(1))
    emit(dict(phase="main_path", model="llama2-7b", group_size=256,
              dtype="bf16", cache_len=1024, prompt_len=32, new_tokens=len(rows[0]),
              prefill_ms=prefill_s * 1e3, decode_steps=steps,
              decode_ms_per_token=ms_per_token,
              decode_tokens_per_s=steps / decode_s,
              weight_bytes_per_token=weight_bytes,
              weight_bound_ms_per_token=bound_ms,
              share_of_weight_bound=bound_ms / ms_per_token,
              peak_memory_bytes=peak, init_s=init_s, launches=launches,
              launches_expected=expect, fused_decode_launches=fused_launches,
              logits_finite=finite, ok=ok, card=CARD))
    if not ok:
        raise AssertionError("Llama-2-7B main path failed its checks")
    profile_decode(cfg, params, gen, prompt, dev)
    return launches


def profile_decode(cfg, params, gen, prompt, dev, steps=16, fused=False,
                   model="llama2-7b"):
    """Where a decode step's time goes: `steps` greedy steps of the main
    path under torch.profiler, summed by kernel name. Emits the card's busy
    time per step against the step's wall time (the idle share is host
    time the card waits through) and the kernels that take the most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kuiperllama_tpu_torch.models import decoder
    from kuiperllama_tpu_torch.serving.generate import _stop_array, decode_chunk

    cache = decoder.init_kv_cache(cfg, 1, gen.cache_len, gen.cache_dtype,
                                  device=dev)
    toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
    logits, cache = decoder.prefill(cfg, params, toks, cache, rope=gen.rope)
    state = (logits.argmax(-1).to(torch.int32),
             torch.tensor([len(prompt)], dtype=torch.int32, device=dev),
             cache, torch.zeros(1, dtype=torch.bool, device=dev))
    run = lambda: decode_chunk(cfg, params, *state, None, _stop_array((), dev),
                               steps, active_len=256, rope=gen.rope,
                               fused=fused)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    row = dict(phase="decode_profile", model=model,
               route="fused" if fused else "layered", steps=steps,
               wall_ms_per_step_profiled=wall_ms / steps,
               device_busy_ms_per_step=busy_ms / steps if by_name else "not measured",
               device_idle_share=1 - busy_ms / wall_ms if by_name else "not measured",
               kernels_per_step=sum(n for _, n in by_name.values()) / steps,
               top_kernels=[dict(name=k[:80], ms_per_step=ms / steps,
                                 launches_per_step=n / steps)
                            for k, (ms, n) in top],
               card=CARD)
    emit(row)
    return row


def fused_model(dev, preset, quantize, g, layers=None, seed=SEED):
    """Random fused params of a preset at full width (INT8 with bf16 scales,
    or dense bf16), drawn on the card from a seed."""
    import torch

    from kuiperllama_tpu_torch.config import preset_config
    from kuiperllama_tpu_torch.fuse import fuse_params
    from kuiperllama_tpu_torch.params import random_params_device
    from kuiperllama_tpu_torch.quant import cast_scales

    over = dict(seq_len=CACHE_LEN)
    if layers:
        over["n_layers"] = layers
    cfg = preset_config(preset, **over)
    params = random_params_device(cfg, device=dev, seed=seed,
                                  quantize=quantize, group_size=g or 64)
    if quantize:
        params = cast_scales(params, torch.bfloat16)
    return cfg, fuse_params(params)


def _to_cpu(x):
    from kuiperllama_tpu_torch.quant import QuantTensor

    if isinstance(x, QuantTensor):
        return QuantTensor(x.q.cpu(), x.s.cpu(), x.group_size)
    return x.cpu()


def _clone_blocks(params):
    """A second copy of the per-layer weights, so that timed launches
    alternate between copies and do not find the weights in L2."""
    from kuiperllama_tpu_torch.quant import QuantTensor

    def c(x):
        if isinstance(x, QuantTensor):
            return QuantTensor(x.q.clone(), x.s.clone(), x.group_size)
        return x.clone()

    return dict(params, blocks={k: c(v) for k, v in params["blocks"].items()})


def fused_step_bytes(cfg, params, pos, cache_itemsize):
    """Bytes one megakernel step must move: every layer's weights (int8 and
    scales, or bf16, plus bias and norms) read once, the K/V history of
    slots < pos read once, the new K/V rows written, x0 and x_out."""
    from kuiperllama_tpu_torch.params import param_bytes

    b = params["blocks"]
    names = ("wqkv", "wo", "w13", "w2", "bqkv", "attn_norm", "ffn_norm")
    weights = sum(param_bytes({"w": b[n]}) for n in names if n in b)
    weights += param_bytes({"w": params["final_norm"]})
    kv = cfg.n_layers * cfg.kv_dim * cache_itemsize
    return weights + 2 * kv * pos + 2 * kv + 2 * cfg.dim * 2


def fused_step_ops(cfg, params):
    """Multiply-adds of one step's projections, 2 operations each."""
    b = params["blocks"]
    return 2.0 * sum(b[n].shape[-3] * b[n].shape[-2] * b[n].shape[-1]
                     for n in ("wqkv", "wo", "w13", "w2"))


def fused_inputs(cfg, params, dev, pos=FUSED_POS, window=FUSED_WINDOW):
    """x0, a window view of bf16 caches with random history, pos, rope."""
    import torch

    from kuiperllama_tpu_torch.models import decoder

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    L, KV = cfg.n_layers, cfg.kv_dim
    full_k = torch.randn((L, CACHE_LEN, KV), generator=gen, device=dev).to(torch.bfloat16)
    full_v = torch.randn((L, CACHE_LEN, KV), generator=gen, device=dev).to(torch.bfloat16)
    sin, cos = decoder.build_rope(cfg, dev)
    x0 = params["tok_emb"][torch.tensor([5], device=dev)]
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    return x0, full_k, full_v, window, p, sin, cos


def _bf16_ulp(t):
    import torch

    mag = t.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def hold_fused(cfg, params, x0, full_k, full_v, A, p, sin, cos, depth):
    """The megakernel against its plain version on the same inputs, each run
    on its own copy of the caches: the plain version on the card and on the
    CPU (whose summation order the CPU tests tie to the JAX package's).
    Holds x_final and the new K/V rows of every layer within the depth's
    FUSED_TOL, and checks that no other slot changed. Returns (the errors
    and checks, the kernel's x_final on the card)."""
    import torch

    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd

    pos, L, hd = int(p.item()), cfg.n_layers, cfg.head_dim
    cpu = torch.device("cpu")
    cpu_params = dict(blocks={k: _to_cpu(v) for k, v in params["blocks"].items()},
                      final_norm=params["final_norm"].cpu())
    runs = {}
    for name, fn, prm, where in (
            ("kernel", fd.fused_decode_step, params, x0.device),
            ("plain", fd.fused_decode_step_ref, params, x0.device),
            ("plain_cpu", fd.fused_decode_step_ref, cpu_params, cpu)):
        kc, vc = full_k.to(where, copy=True), full_v.to(where, copy=True)
        x, _, _ = fn(cfg, prm, x0.to(where), kc[:, :A], vc[:, :A], p.to(where),
                     sin.to(where), cos.to(where))
        runs[name] = (x, kc.cpu(), vc.cpu())
    x_dev = runs["kernel"][0]
    xk, kk, vk = x_dev.cpu(), *runs["kernel"][1:]
    k_in, v_in = full_k.cpu(), full_v.cpu()
    untouched = all(torch.equal(a[:, :pos], b[:, :pos])
                    and torch.equal(a[:, pos + 1:], b[:, pos + 1:])
                    for a, b in ((kk, k_in), (vk, v_in)))

    def errors(got, want):  # x_final, and the new rows of the worst layer
        (x, k, v), (xr, kr, vr) = got, want
        return (rel_err(x.cpu(), xr.cpu()),
                max(rel_err(a[li, pos], b[li, pos])
                    for a, b in ((k, kr), (v, vr)) for li in range(L)))

    errs = {ref: errors(runs["kernel"], runs[ref]) for ref in ("plain", "plain_cpu")}
    # not held: the spread of one plain version between two summation orders
    spread = errors(runs["plain"], runs["plain_cpu"])
    xr, kr, vr = runs["plain"]
    k0, k0r = kk[0, pos].float(), kr[0, pos].float()
    head_mag = k0r.abs().reshape(-1, hd).amax(-1, keepdim=True)
    k_ulp_ok = bool(((k0 - k0r).abs().reshape(-1, hd) <= _bf16_ulp(head_mag)).all())
    v_ulp_ok = bool(((vk[0, pos].float() - vr[0, pos].float()).abs()
                     <= _bf16_ulp(vr[0, pos])).all())
    flags = fd.gemv_int8_flags(params["blocks"],
                               fd.plan_tiles(params["blocks"], full_k.dtype, A))
    # with int8 activations even layer 0's input differs in the last bit
    # (torch's rmsnorm mean sums in another order) and a flipped int8
    # rounding moves the row by more than an ulp: no one-ulp check there
    ulp_checked = not any(flags)
    tol = FUSED_TOL[(depth, any(flags))]
    ok = (all(e <= tol for pair in errs.values() for e in pair)
          and (k_ulp_ok and v_ulp_ok or not ulp_checked)
          and untouched and bool(torch.isfinite(xk.float()).all()))
    check = dict(int8_activation=list(flags), tol=tol,
                 rel_err_x=errs["plain"][0], rel_err_x_vs_plain_on_cpu=errs["plain_cpu"][0],
                 rel_err_new_rows=errs["plain"][1],
                 rel_err_new_rows_vs_plain_on_cpu=errs["plain_cpu"][1],
                 plain_card_vs_cpu_rel_err_x=spread[0],
                 plain_card_vs_cpu_rel_err_new_rows=spread[1],
                 max_abs_err=(xk.float() - xr.cpu().float()).abs().max().item(),
                 layer0_rows_within_one_ulp=k_ulp_ok and v_ulp_ok,
                 layer0_ulp_check_applies=ulp_checked, other_slots_untouched=untouched,
                 ok=ok)
    return check, x_dev


def phase_fused_kernel(dev):
    """The megakernel against its plain version on the card, at full width
    and FUSED_LAYERS layers of each geometry; times beside the layered
    eager step on the same weights and the byte bound."""
    import torch

    from kuiperllama_tpu_torch.models import decoder
    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd
    from kuiperllama_tpu_torch.ops.linear import linear

    rows = []
    for i, (label, preset, quantize, g) in enumerate(FUSED_CASES):
        cfg, params = fused_model(dev, preset, quantize, g, FUSED_LAYERS,
                                  seed=SEED + 60 + i)
        x0, full_k, full_v, A, p, sin, cos = fused_inputs(cfg, params, dev)
        pos, hd = FUSED_POS, cfg.head_dim
        check, xk = hold_fused(cfg, params, x0, full_k, full_v, A, p, sin, cos,
                               "2 layers")

        variants = [params, _clone_blocks(params)]
        kc, vc = full_k[:, :A], full_v[:, :A]
        ms = gpu_ms(lambda v: fd.fused_decode_step(cfg, v, x0, kc, vc, p, sin, cos),
                    variants)
        p_host = p.cpu()  # the plain version reads pos on the host
        plain_ms = gpu_ms(lambda v: fd.fused_decode_step_ref(
            cfg, v, x0, kc, vc, p_host, sin, cos), variants, n=5)
        cache = dict(k=full_k[:, None, :A].reshape(cfg.n_layers, 1, A, cfg.n_kv_heads, hd),
                     v=full_v[:, None, :A].reshape(cfg.n_layers, 1, A, cfg.n_kv_heads, hd))
        tok = torch.tensor([5], dtype=torch.int32, device=dev)
        layered_ms = gpu_ms(lambda v: decoder.decode_step(
            cfg, v, tok, p, cache, rope=(sin, cos)), variants, n=10)
        xf = xk.to(torch.bfloat16)
        lm_head_ms = gpu_ms(lambda v: linear(xf, v["lm_head"]), [params], n=10)
        nbytes = fused_step_bytes(cfg, params, pos, 2)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = fused_step_ops(cfg, params) / PEAK_OPS_PER_S["bf16"] * 1e3
        row = dict(phase="kernel", kernel="fused_decode", model=label,
                   layers=FUSED_LAYERS, group_size=g, quant="int8" if quantize else "bf16",
                   pos=pos, window=A, **check,
                   ms=ms, plain_ms=plain_ms, layered_step_ms=layered_ms,
                   layered_lm_head_ms=lm_head_ms, library_ms=None,
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   bound_bytes_ms=bytes_ms, bound_ops_ms=ops_ms, step_bytes=nbytes,
                   card=CARD)
        emit(row)
        rows.append(row)
        del params, variants, cache, full_k, full_v
        if not check["ok"]:
            raise AssertionError(f"fused_decode disagrees with its plain version: {row}")
    return rows


def phase_fused_main_path(dev, label, preset, quantize):
    """One model of the megakernel route at full width and depth through
    Generator.generate_batch_ids (auto route), as the Llama-2-7B main path;
    then the kernel alone on the main path's shapes for the kernels line."""
    import torch

    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd
    from kuiperllama_tpu_torch.ops.kernels import quant_matmul as qm
    from kuiperllama_tpu_torch.params import param_bytes
    from kuiperllama_tpu_torch.serving.generate import Generator

    t0 = time.perf_counter()
    cfg, params = fused_model(dev, preset, quantize, 256)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    b = params["blocks"]
    stream = [b[n] for n in ("wqkv", "wo", "w13", "w2", "bqkv") if n in b]
    weight_bytes = sum(param_bytes({"w": w}) for w in stream + [params["lm_head"]])
    floor_ms = weight_bytes / HBM_BYTES_PER_S * 1e3

    gen = Generator(cfg, params, cache_len=CACHE_LEN, cache_dtype=torch.bfloat16,
                    chunk=128)
    prompt = list(range(5, 5 + 32))
    gen.generate_batch_ids([prompt], max_new_tokens=8)  # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats(dev)
    qm.quant_gemv.launches = 0
    qm.quant_gemm.launches = 0
    fd.fused_decode_step.launches = 0
    rows, prefill_s, decode_s = gen.generate_batch_ids([prompt], max_new_tokens=128)
    launches = {"fused_decode": fd.fused_decode_step.launches,
                "quant_gemv": qm.quant_gemv.launches,
                "quant_gemm": qm.quant_gemm.launches}
    peak = torch.cuda.max_memory_allocated(dev)

    steps = len(rows[0]) - 1
    ms_per_token = decode_s / steps * 1e3
    expect = {"fused_decode": steps,
              "quant_gemv": 1 + steps if quantize else 0,
              "quant_gemm": 4 * cfg.n_layers if quantize else 0}
    layered = Generator(cfg, params, cache_len=CACHE_LEN, cache_dtype=torch.bfloat16,
                        chunk=128, fused_step=False)
    rows_layered, _, layered_decode_s = layered.generate_batch_ids([prompt], 128)
    first_diff = next((i for i, (a, c) in enumerate(zip(rows[0], rows_layered[0]))
                       if a != c), None)
    in_vocab = all(0 <= t < cfg.vocab_size for t in rows[0])
    ok = (len(rows[0]) == 128 and in_vocab and gen._fused_ok(1)
          and launches == expect)
    prof = profile_decode(cfg, params, gen, prompt, dev, fused=True, model=label)
    busy = prof["device_busy_ms_per_step"]
    emit(dict(phase="main_path", model=label, quant="int8" if quantize else "bf16",
              group_size=256 if quantize else None, dtype="bf16", cache_len=CACHE_LEN,
              prompt_len=32, new_tokens=len(rows[0]), route="fused (auto)",
              prefill_ms=prefill_s * 1e3, decode_steps=steps,
              decode_ms_per_token=ms_per_token, decode_tokens_per_s=steps / decode_s,
              weight_bytes_per_token=weight_bytes, floor_ms_per_token=floor_ms,
              share_of_floor=floor_ms / ms_per_token,
              layered_decode_ms_per_token=layered_decode_s / (len(rows_layered[0]) - 1) * 1e3,
              first_token_differing_from_layered=first_diff,
              launches_per_step_profiled=prof["kernels_per_step"],
              device_busy_ms_per_step=busy,
              device_idle_share_unprofiled=(1 - busy / ms_per_token
                                            if isinstance(busy, float) else "not measured"),
              peak_memory_bytes=peak, init_s=init_s, launches=launches,
              launches_expected=expect, ok=ok, card=CARD))
    if not ok:
        raise AssertionError(f"{label} main path failed its checks")

    # the kernel alone at the main path's shapes (full depth, pos 100 of a
    # 256-slot window, one step): held against its plain version, timed,
    # and one launch traced for the time of each phase per layer
    x0, full_k, full_v, A, p, sin, cos = fused_inputs(cfg, params, dev)
    check, _ = hold_fused(cfg, params, x0, full_k, full_v, A, p, sin, cos,
                          "full depth")
    kc, vc = full_k[:, :A], full_v[:, :A]
    ms = gpu_ms(lambda v: fd.fused_decode_step(cfg, v, x0, kc, vc, p, sin, cos),
                [params])
    p_host = p.cpu()
    plain_ms = gpu_ms(lambda v: fd.fused_decode_step_ref(cfg, v, x0, kc, vc, p_host,
                                                         sin, cos), [params], n=3)
    L = cfg.n_layers
    trace = torch.zeros(2 + 5 * L, dtype=torch.int64, device=dev)
    fd.fused_decode_step(cfg, params, x0, kc, vc, p, sin, cos, trace=trace)
    phases = fd.phase_times(trace, L)
    us_per_layer = {k: phases[k] / L for k in fd.PHASES}
    check["ok"] = check["ok"] and all(t > 0 for t in us_per_layer.values())
    nbytes = fused_step_bytes(cfg, params, FUSED_POS, 2)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = fused_step_ops(cfg, params) / PEAK_OPS_PER_S["bf16"] * 1e3
    step = dict(phase="fused_step", model=label, layers=L, pos=FUSED_POS,
                window=A, **check, ms=ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bound_bytes_ms=bytes_ms, bound_ops_ms=ops_ms, step_bytes=nbytes,
                share_of_bound=max(bytes_ms, ops_ms) / ms,
                traced_phase_us_per_layer=us_per_layer,
                traced_final_norm_us=phases["final"], traced_total_us=phases["total"],
                card=CARD)
    emit(step)
    if not step["ok"]:
        raise AssertionError(f"fused_decode disagrees with its plain version "
                             f"at full depth ({label})")
    return launches, step


def _sum(rows, key):
    return sum(r[key] * n for r, n in rows)


def kernels_line(gemv, gemm, fused_rows, fused_step, launches_by_path):
    """One entry per kernel. `launches` is the count on the kernel's main
    path (Llama-2-7B for the GEMV and GEMM, TinyLlama-1.1B for the
    megakernel); `launches_by_path` has every path's count."""
    main_7b = launches_by_path["llama2-7b"]

    def by_path(name):
        return {path: counts.get(name, 0) for path, counts in launches_by_path.items()}

    def entry(name, rows, replaces, per):
        by_bytes = _sum(rows, "bound_bytes_ms") >= _sum(rows, "bound_ops_ms")
        return dict(
            name=name, route="cuda",
            source=f"kuiperllama_tpu_torch/csrc/{name}.cu",
            replaces=replaces, launches=main_7b[name],
            max_abs_err=max(r["max_abs_err"] for r, _ in rows),
            ms=_sum(rows, "ms"), plain_ms=_sum(rows, "plain_ms"),
            bound_ms=_sum(rows, "bound_ms"),
            bound_by="bytes" if by_bytes else "operations",
            library_ms=_sum(rows, "library_ms"), per=per,
            launches_by_path=by_path(name), card=CARD)

    fused = dict(
        name="fused_decode", route="cuda",
        source="kuiperllama_tpu_torch/csrc/fused_decode.cu",
        replaces="kuiperllama_tpu/ops/pallas/fused_decode.py:241",
        launches=launches_by_path["tinyllama-1.1b"]["fused_decode"],
        max_abs_err=max(r["max_abs_err"] for r in fused_rows),
        ms=fused_step["ms"], plain_ms=fused_step["plain_ms"],
        bound_ms=fused_step["bound_ms"], bound_by=fused_step["bound_by"],
        # no single PyTorch call computes a decode step of the layer stack
        library_ms=None,
        per="one TinyLlama-1.1B decode step: 22 layers, INT8 g 256, bf16 "
            "scales and cache, pos 100 in a 256-slot window",
        launches_by_path=by_path("fused_decode"), card=CARD)
    return {"kernels": [
        entry("quant_gemv", gemv, "kuiperllama_tpu/ops/pallas/quant_matmul.py:202",
              "one Llama-2-7B decode token: 32 x (wqkv, wo, w13, w2) + lm_head, "
              "g 256, bf16"),
        entry("quant_gemm", gemm, "kuiperllama_tpu/ops/pallas/quant_matmul.py:132",
              "one Llama-2-7B prefill of 32 tokens: 32 x (wqkv, wo, w13, w2), "
              "fast, g 256, bf16"),
        fused,
    ]}


def main() -> int:
    global CARD
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from kuiperllama_tpu_torch.ops.kernels import build
    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd
    from kuiperllama_tpu_torch.ops.kernels import quant_matmul as qm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    CARD = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit(dict(phase="device", kind=kind, count=torch.cuda.device_count(),
              nvidia_smi=CARD, torch=torch.__version__, cuda=torch.version.cuda))

    t0 = time.perf_counter()
    built = build.build([qm.GEMV_SOURCE, qm.GEMM_SOURCE, fd.SOURCE])
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              per_source_s=built, flags=" ".join(build.NVCC_FLAGS)))

    gemv, gemm = phase_kernels(dev)
    fused_rows = phase_fused_kernel(dev)
    phase_fixture(dev)
    launches = {"llama2-7b": phase_main_path(dev)}
    launches["tinyllama-1.1b"], fused_step = phase_fused_main_path(
        dev, "tinyllama-1.1b", "tinyllama-1.1b", True)
    launches["qwen2.5-0.5b"], qwen_step = phase_fused_main_path(
        dev, "qwen2.5-0.5b", "qwen2.5-0.5b", False)
    emit(kernels_line(gemv, gemm, fused_rows + [fused_step, qwen_step],
                      fused_step, launches))
    print(CARD, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # report and fail: no result line after a failed phase
        traceback.print_exc()
        code = 1
    sys.exit(code)
