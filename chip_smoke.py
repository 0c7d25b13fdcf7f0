#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kuiperllama_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero before the
last line:
  1. device: the card's name, power limit and count; fails without CUDA.
  2. build: nvcc builds every kernel of the path from csrc/, one process
     per source, all at once.
  2b. tools: the kernel-measurement tools (kuiperllama_tpu_torch/tools): the
     roofline probes (HBM read, decode GEMV weight stream in bf16 and int8,
     bf16 tensor-core matmul) at their default sizes; the three tool kernels
     held against their plain versions and timed beside their bounds:
     exp_stream at the five TinyLlama-1.1B shapes over the JAX tool's tiles
     that divide them (equal), exp_outscale and the GEMM (exp_kernel's
     `current`) there at M = 8 (within 2^-7; yardstick bf16 x @ the
     pre-dequantized weight), exp_int8 in its six modes held at L 2 and on
     the tool's own L 64 stack (1e-5, nodot equal) and timed there; the GEMM
     at bench_kernels' shapes (Llama-2-7B, M = 8, g 64, fp32 scales); then
     the tools' entry points (exp_kernel, exp_int8, bench_kernels at
     Llama-2-7B M = 8, kernel and torch variants) with exact launch counts.
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the Llama-2-7B main-path shapes, with CUDA-event times (median of 25
     launches) of the kernel, the plain version and one library call
     (x @ w_bf16 with the weight dequantized ahead of time: a yardstick the
     port never calls), beside the least time the card could take; the GEMV
     also at a ragged N, and at the five Llama-2-7B shapes with 4 and 8
     column threads a warp at the plans for 2, 4 and 8 blocks per SM.
  4. fused kernel: the decode megakernel against its plain version on the
     card at TinyLlama-1.1B INT8 g 256, Llama-3.2-1B INT8 g 256,
     Qwen2.5-0.5B bf16 and TinyLlama-1.1B INT8 g 64 (int8 activations), full
     width and 2 layers, one step at pos 100 in a 256-slot window: error,
     CUDA-event times of the kernel and the plain version, the port's
     layered eager step on the same weights, and the byte bound.
  4b. big kernel: the big-model megakernel against its plain version on the
     card (and on the CPU) at Llama-2-7B INT8 g 64 with bf16 scales,
     Llama-2-7B g 256 with fp32 scales and Llama-3-8B g 64 (BIG_CASES), full
     width and 2 layers, one step at pos 100 in a 256-slot window: error,
     CUDA-event times of the kernel and the plain version, the byte bound,
     and us per phase per layer from one traced launch beside each phase's
     byte time.
  4c. chunk kernel: the greedy chunk megakernel against its plain version on
     the card at TinyLlama-1.1B INT8 g 256, Qwen2.5-0.5B bf16 and
     Llama-3.2-1B INT8 g 256 (CHUNK_CASES), 2 layers, CHUNK_STEPS steps from
     pos 100: tokens equal up to an exact logit tie, the chunk's K/V rows,
     ms per step against the per-step bound (layer stack and lm_head).
  5. fixture: checkpoints/tinychar/tinychar.q8.bin, 24 greedy tokens on the
     card equal to the same run on the CPU (which uses the plain versions);
     the layered route with fp32 params, then the megakernel route
     (fused_step=True) with bf16 params and cache, then the chunk route
     (KT_FUSED_CHUNK=1): one chunk launch for the 23 decode steps.
  6. main path: Llama-2-7B at full width (INT8 group 256, bf16 scales,
     activations and cache, cache length 1024, random weights from a seed),
     Generator.generate_batch_ids on one 32-token prompt, 128 new tokens,
     greedy. Kernel launch counts are zeroed just before and read just after.
     Llama-2-7B does not fit the megakernel's plan and decodes layered.
  6b. big route: Llama-2-7B INT8 g 64 (bf16 scales), the same setup under
     KT_FUSED_BIG=1: one big-kernel launch and one lm_head GEMV per decode
     step, counted exactly; the same weights on the layered route beside it
     and a decode profile of the big route; then the big kernel alone at
     full depth, held against its plain version on the CPU, timed and
     traced.
  7. main paths of the megakernel route: TinyLlama-1.1B INT8 g 256 and
     Qwen2.5-0.5B bf16, full width and depth, the same setup and the auto
     route; each with its decode profile, then the megakernel alone at the
     main path's shapes: held against its plain version (card and CPU),
     timed, and one launch traced for the time of each phase per layer.
  7b. chunk route: TinyLlama-1.1B and Qwen2.5-0.5B as in 7 under
     KT_FUSED_CHUNK=1 (64-step chunks): two chunk launches for the 127
     decode steps, beside the per-step route's numbers, with a profile of
     one chunk; then the chunk kernel alone at full depth (CHUNK_STEPS steps
     from pos 100), held against its plain version on the card and timed.
  8. paged kernel (run after phase 4): the paged flash-decode kernel against
     its plain version on the card at B = 8 ragged rows (1 to 1024 tokens)
     on 128-token pages of a shuffled page table, layer 1 of a stacked pool:
     Llama-2-7B, Llama-3-8B, TinyLlama-1.1B and Qwen2.5-0.5B head geometries
     with bf16 pools, TinyLlama's with fp32 pools; errors at PAGED_SEEDS
     seeds, CUDA-event times of the kernel, the plain version and
     scaled_dot_product_attention on K/V gathered ahead (the yardstick).
  9. engine fixture (after phase 5): Engine, PagedEngine (8-token pages, a
     pool small enough to preempt) and chunked PagedEngine on the tinychar
     fixture, fp32: greedy tokens equal on the card and on the CPU and
     across the three engines; paged attention launched n_layers times per
     decode step.
 10. engine main paths (after phase 7): PagedEngine at 8 slots, cache
     length 1024, 64-step chunks, 128-token pages (the bench.py --engine
     defaults), 16 requests of 32 prompt and 128 new tokens submitted at
     once: Llama-2-7B, then TinyLlama-1.1B with prefill_chunk 256 and a
     768-token prompt on every 4th request. Tokens/s, TTFT, exact launch
     counts, peak memory, and a profile of one decode chunk.
 11. server: InferenceServer and its HTTP front end on 127.0.0.1 over a
     PagedEngine of the fixture: concurrent requests answer the CPU
     engine's tokens, an invalid one gets a 400 and serving continues; a
     request that times out is cancelled (the pool's free pages come back).
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
magnitude: rope sums two products). The big kernel takes int8 activations
in every GEMV (FUSED_TOL's int8 limits); at full depth it is held to the
plain version run on the CPU, since the plain version run on the card sits
about 0.1 from it (cuBLAS summation order through 32 layers of int8
requantization). The chunk kernel's tokens must be equal up to a logit tie
(the plain version's logits of the two tokens within 2e-3 of max(1,
max|logit|) at the first difference at 2 layers, within FUSED_TOL at full
depth, where x_final itself moves by 2-3% between two valid summation
orders; nothing after it compared), its K/V rows up to there within
FUSED_TOL.
"""

import contextlib
import json
import os
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# dense; fp32 off the tensor cores
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
TOL = {"fast": 1e-3, "exact": 1e-5}
BF16_ULP = 2.0 ** -7
SEED = 0
HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = "checkpoints/tinychar/tinychar.q8.bin"

# megakernel limits by depth and by whether any GEMV takes int8 activations
FUSED_TOL = {("2 layers", False): 2e-2, ("2 layers", True): 5e-2,
             ("full depth", False): 5e-2, ("full depth", True): 1e-1}
FUSED_LAYERS, FUSED_POS, FUSED_WINDOW, CACHE_LEN = 2, 100, 256, 1024
# megakernel geometries: (label, preset, INT8, group size)
FUSED_CASES = [("tinyllama-1.1b", "tinyllama-1.1b", True, 256),
               ("llama3.2-1b", "llama3.2-1b", True, 256),
               ("qwen2.5-0.5b", "qwen2.5-0.5b", False, 0),
               ("tinyllama-1.1b g64", "tinyllama-1.1b", True, 64)]

# big-model megakernel geometries: (label, preset, group size, bf16 scales)
BIG_CASES = [("llama2-7b g64", "llama2-7b", 64, True),
             ("llama2-7b g256 fp32 scales", "llama2-7b", 256, False),
             ("llama3-8b g64", "llama3-8b", 64, True)]
# chunk megakernel geometries: (label, preset, INT8, group size), CHUNK_STEPS
# greedy steps per launch from FUSED_POS
CHUNK_CASES = [("tinyllama-1.1b", "tinyllama-1.1b", True, 256),
               ("qwen2.5-0.5b", "qwen2.5-0.5b", False, 0),
               ("llama3.2-1b", "llama3.2-1b", True, 256)]
CHUNK_STEPS = 16

# paged attention: (label, H, KH, hd) at B = 8 ragged rows on 128-token
# pages of a shuffled page table, read at layer 1 of a stacked pool
PAGED_CASES = [("llama2-7b", 32, 32, 128), ("llama3-8b", 32, 8, 128),
               ("tinyllama-1.1b", 32, 4, 64), ("qwen2.5-0.5b", 14, 2, 64)]
PAGED_LENS = [1, 127, 128, 129, 300, 512, 777, 1024]
PAGED_PS = 128
PAGED_SEEDS = 3
# the normalised output acc / l relative to max|plain|, by pool dtype, and
# m relative to max|m| (PERF.md records the readings they were set from)
PAGED_TOL = {"bf16": 1e-3, "fp32": 1e-6}
PAGED_M_TOL = 1e-6
# engine main paths (the bench.py --engine defaults): slots, cache length,
# decode chunk, page size, requests, prompt and new tokens
ENGINE_SLOTS, ENGINE_CHUNK, ENGINE_PS = 8, 64, 128
ENGINE_REQUESTS, ENGINE_PROMPT, ENGINE_NEW = 16, 32, 128
PROFILE_STEPS = 16
# the tinychar engines: (name, engine class, options)
FIXTURE_ENGINES = [("dense", "Engine", {}),
                   ("paged", "PagedEngine", dict(page_size=8, n_pages=13,
                                                 reserve_growth=False)),
                   ("paged_chunked", "PagedEngine", dict(page_size=8,
                                                         prefill_chunk=16))]
FIXTURE_PROMPTS = [[1, 20, 33, 45, 60, 7, 90], [5, 6], list(range(10, 40)),
                   [3] * 12, [100, 2, 7], list(range(50, 70))]
FIXTURE_NEW = 24

# Llama-2-7B main-path projections: (name, K, N, launches per decode token)
GEMV_SHAPES = [("wqkv", 4096, 12288, 32), ("wo", 4096, 4096, 32),
               ("w13", 4096, 22016, 32), ("w2", 11008, 4096, 32),
               ("lm_head", 4096, 32000, 1)]
PREFILL_M = 32

CARD = ""
T0 = time.perf_counter()


def emit(obj):
    """One JSON line; phase rows carry the run's elapsed seconds (t_s)."""
    if "phase" in obj:
        obj = dict(obj, t_s=round(time.perf_counter() - T0, 1))
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def knob(name):
    """Set the route knob `name` (a KT_* variable) to "1" for the block;
    None sets nothing."""
    old = os.environ.get(name) if name else None
    if name:
        os.environ[name] = "1"
    try:
        yield
    finally:
        if name and old is None:
            del os.environ[name]
        elif name:
            os.environ[name] = old


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


def check_kernel(kind, dev, M, K, N, g, mode, seed, name="", scales="bfloat16"):
    """One shape: correctness at fp32 and at the path's dtypes (bf16 x,
    `scales` scales: bfloat16 on the decode path, float32 in bench_kernels), then
    times at the path's dtypes. Times rotate weight copies past L2, as a
    decode step streams gigabytes between two reads of one weight."""
    import torch

    from kuiperllama_tpu_torch.ops.kernels import quant_matmul as qm
    from kuiperllama_tpu_torch.utils.profiling import device_time, l2_copies

    if kind == "quant_gemv":
        kernel = lambda x, q, s: qm.quant_gemv(x, q, s, g)
        plain = lambda x, q, s: qm.quant_gemv_ref(x, q, s, g)
    else:
        kernel = lambda x, q, s: qm.quant_gemm(x, q, s, g, mode)
        plain = lambda x, q, s: qm.quant_gemm_ref(x, q, s, g, mode)

    x, q, s = operands(dev, M, K, N, g, seed)
    err32 = rel_err(kernel(x, q, s), plain(x, q, s))
    xb, sb = x.to(torch.bfloat16), s.to(getattr(torch, scales))
    got, want = kernel(xb, q, sb), plain(xb, q, sb)
    torch.cuda.synchronize()
    err16 = rel_err(got, want)
    abs16 = (got.float() - want.float()).abs().max().item()
    ok = (err32 <= TOL[mode] and err16 <= BF16_ULP
          and bool(torch.isfinite(got).all()))

    qs = [q] + [q.clone() for _ in range(l2_copies(K * N, dev) - 1)]
    variants = [(xb, qc, sb) for qc in qs]
    ms = device_time(kernel, variants=variants, device="cuda") * 1e3
    plain_ms = device_time(plain, variants=variants, device="cuda") * 1e3
    wd = qm.dequantize_bf16(q, sb, g)
    lib_variants = [(xb, wd)] + [(xb, wd.clone())
                                 for _ in range(l2_copies(2 * K * N, dev) - 1)]
    library_ms = device_time(torch.matmul, variants=lib_variants, device="cuda") * 1e3
    bytes_ms, ops_ms = bound(M, K, N, g, 2, sb.element_size(), 2,
                             "bf16" if mode == "fast" else "fp32")
    del qs, variants, wd, lib_variants
    row = dict(phase="kernel", kernel=kind, weight=name, M=M, K=K, N=N, g=g,
               mode=mode, scales=scales,
               rel_err_fp32_out=err32, rel_err_bf16_out=err16,
               max_abs_err=abs16, ok=ok, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               bound_bytes_ms=bytes_ms, bound_ops_ms=ops_ms, card=CARD)
    emit(row)
    if not ok:
        raise AssertionError(f"{kind} disagrees with its plain version: {row}")
    return row


def gemv_variants(dev, g=256):
    """The GEMV's layout and plan, measured: at each GEMV_SHAPES shape (bf16
    x and scales), CUDA-event times of the kernel with 4 and 8 column
    threads a warp at the plans for 2, 4 and 8 blocks per SM, each launch
    held against the plain version."""
    import torch

    from kuiperllama_tpu_torch.ops.kernels import quant_matmul as qm
    from kuiperllama_tpu_torch.utils.profiling import device_time, l2_copies

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for i, (name, K, N, _) in enumerate(GEMV_SHAPES):
        x, q, s = operands(dev, 1, K, N, g, SEED + 90 + i)
        xb, sb = x.to(torch.bfloat16), s.to(torch.bfloat16)
        want = qm.quant_gemv_ref(xb, q, sb, g)
        qs = [q] + [q.clone() for _ in range(l2_copies(K * N, dev) - 1)]
        ct0 = qm.gemv_col_threads(K, N, g, sms)
        us, ok = {}, True
        for ct in (4, 8):
            for bps in (2, 4, 8):
                gps = qm.gemv_plan(K, N, g, sms, bps, ct)
                launch = lambda x, q, s: qm.gemv_launch(x, q, s, g, gps, ct)
                ok = ok and rel_err(launch(xb, q, sb), want) <= BF16_ULP
                us[f"{ct} column threads, {bps} blocks/SM (gps {gps})"] = device_time(
                    launch, variants=[(xb, qc, sb) for qc in qs], device="cuda") * 1e6
        row = dict(phase="kernel_variants", kernel="quant_gemv", weight=name, K=K,
                   N=N, g=g, plan_col_threads=ct0,
                   plan_gps=qm.gemv_plan(K, N, g, sms, col_threads=ct0), us=us, ok=ok,
                   card=CARD)
        emit(row)
        del qs
        if not ok:
            raise AssertionError(f"quant_gemv variant disagrees: {row}")


def phase_kernels(dev):
    gemv, gemm = [], []
    for i, (name, K, N, per_token) in enumerate(GEMV_SHAPES):
        row = check_kernel("quant_gemv", dev, 1, K, N, 256, "fast", SEED + i,
                           name)
        gemv.append((row, per_token))
    check_kernel("quant_gemv", dev, 1, 4096, 4096, 64, "fast", SEED + 10)
    check_kernel("quant_gemv", dev, 1, 1024, 1000, 64, "fast", SEED + 11, "ragged N")
    gemv_variants(dev)
    for i, (name, K, N, _) in enumerate(GEMV_SHAPES[:4]):
        row = check_kernel("quant_gemm", dev, PREFILL_M, K, N, 256, "fast",
                           SEED + 20 + i, name)
        gemm.append((row, 32))
    # the engine's decode route: M = max_batch = 8 rows
    for i, (name, K, N, _) in enumerate(GEMV_SHAPES[:4]):
        check_kernel("quant_gemm", dev, ENGINE_SLOTS, K, N, 256, "fast",
                     SEED + 60 + i, name)
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
    # (route, dtype, fused_step, knob, expected step and chunk launches)
    for route, dtype, fused, knob_on, expect in (
            ("layered", torch.float32, False, None, (0, 0)),
            ("fused", torch.bfloat16, True, None, (23, 0)),
            ("chunk", torch.bfloat16, True, "KT_FUSED_CHUNK", (0, 1))):
        ids = {}
        step0, chunk0 = fd.fused_decode_step.launches, fd.fused_decode_chunk.launches
        with knob(knob_on):
            for where in ("cpu", dev):
                gen = Generator(cfg, fuse_params(to_device(params, device=where,
                                                           dtype=dtype)),
                                cache_len=128, cache_dtype=dtype, fused_step=fused)
                ids[str(where)] = gen.generate_ids(prompt, max_new_tokens=24)[0]
        torch.cuda.synchronize()
        launches = (fd.fused_decode_step.launches - step0,
                    fd.fused_decode_chunk.launches - chunk0)
        ok = (ids["cpu"] == ids[str(dev)] and len(ids["cpu"]) == 24
              and launches == expect)
        emit(dict(phase="fixture", checkpoint=FIXTURE, route=route,
                  dtype=str(dtype).replace("torch.", ""), knob=knob_on,
                  tokens_gpu=ids[str(dev)], tokens_cpu=ids["cpu"],
                  fused_decode_launches=launches[0],
                  fused_decode_chunk_launches=launches[1], ok=ok, card=CARD))
        if not ok:
            raise AssertionError(f"tinychar greedy tokens ({route} route) "
                                 "differ between GPU and CPU")


def phase_main_path(dev):
    import torch

    from kuiperllama_tpu_torch.config import preset_config
    from kuiperllama_tpu_torch.fuse import fuse_params
    from kuiperllama_tpu_torch.models import decoder
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
    zero_launches()
    rows, prefill_s, decode_s = gen.generate_batch_ids([prompt],
                                                       max_new_tokens=128)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)

    steps = len(rows[0]) - 1
    ms_per_token = decode_s / steps * 1e3
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    expect = dict(NO_LAUNCHES, quant_gemv=1 + steps * (4 * cfg.n_layers + 1),
                  quant_gemm=4 * cfg.n_layers)

    cache = decoder.init_kv_cache(cfg, 1, 1024, torch.bfloat16, device=dev)
    logits, _ = decoder.prefill(cfg, params, torch.tensor([prompt], device=dev),
                                cache, rope=gen.rope)
    finite = bool(torch.isfinite(logits).all())
    in_vocab = all(0 <= t < cfg.vocab_size for t in rows[0])
    ok = (len(rows[0]) == 128 and finite and in_vocab
          and logits.shape == (1, cfg.vocab_size)
          and launches == expect and not gen._fused_ok(1))
    emit(dict(phase="main_path", model="llama2-7b", group_size=256,
              dtype="bf16", cache_len=1024, prompt_len=32, new_tokens=len(rows[0]),
              prefill_ms=prefill_s * 1e3, decode_steps=steps,
              decode_ms_per_token=ms_per_token,
              decode_tokens_per_s=steps / decode_s,
              weight_bytes_per_token=weight_bytes,
              weight_bound_ms_per_token=bound_ms,
              share_of_weight_bound=bound_ms / ms_per_token,
              peak_memory_bytes=peak, init_s=init_s, launches=launches,
              launches_expected=expect, logits_finite=finite, ok=ok, card=CARD))
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
                               fused=fused, drop_past_end=False)
    run()
    torch.cuda.synchronize()
    zero_launches()
    with chunk_kernel_events() as spans:
        by_name, wall_ms = device_profile(run)
    counted = read_launches()
    # The profiler loses launches of the megakernels (the ctypes-launched
    # cooperative kernels): some of the per-step kernels' and every chunk
    # kernel's. A per-step kernel's recorded mean stands for its lost
    # launches (the wrappers count them all); the chunk kernel's launches
    # are timed by CUDA events around its wrapper.
    recorded = {k: 0 for k in ("fused_decode", "fused_decode_big") if counted[k]}
    for key, kname in (("fused_decode", "fused_decode_kernel"),
                       ("fused_decode_big", "fused_big_kernel")):
        for name, (ms, n) in list(by_name.items()):
            if kname in name:
                recorded[key] = n
                by_name[name] = (ms / n * counted[key], counted[key])
    if spans:
        recorded["fused_decode_chunk"] = sum(
            n for name, (_, n) in by_name.items() if "fused_chunk_kernel" in name)
        by_name = {k: v for k, v in by_name.items() if "fused_chunk_kernel" not in k}
        by_name["fused_chunk_kernel (CUDA events)"] = (
            sum(a.elapsed_time(b) for a, b in spans), len(spans))
    busy_ms = sum(ms for ms, _ in by_name.values())
    row = dict(phase="decode_profile", model=model,
               route="fused" if fused else "layered", steps=steps,
               megakernel_launches_counted_vs_profiled={
                   k: [counted[k], recorded[k]] for k in recorded},
               wall_ms_per_step_profiled=wall_ms / steps,
               device_busy_ms_per_step=busy_ms / steps if by_name else "not measured",
               device_idle_share=1 - busy_ms / wall_ms if by_name else "not measured",
               kernels_per_step=sum(n for _, n in by_name.values()) / steps,
               top_kernels=top_kernels(by_name, steps), card=CARD)
    emit(row)
    return row


@contextlib.contextmanager
def chunk_kernel_events():
    """CUDA events recorded around every chunk-kernel launch that the
    Generator's decode_chunk makes inside the block: [(start, end)], read
    after a synchronize."""
    import torch

    from kuiperllama_tpu_torch.serving import generate

    real, spans = generate.fused_decode_chunk, []

    def timed(*args, **kw):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = real(*args, **kw)
        b.record()
        spans.append((a, b))
        return out

    generate.fused_decode_chunk = timed
    try:
        yield spans
    finally:
        generate.fused_decode_chunk = real


def device_profile(run):
    """`run()` under `utils.profiling.trace` (torch.profiler; the Chrome
    trace goes to the temporary directory): ({kernel name: (device ms,
    launches)}, wall ms to the end of its device work)."""
    import torch

    from kuiperllama_tpu_torch.utils.profiling import trace

    with trace() as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return by_name, wall_ms


def top_kernels(by_name, steps):
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return [dict(name=k[:80], ms_per_step=ms / steps, launches_per_step=n / steps)
            for k, (ms, n) in top]


def fused_model(dev, preset, quantize, g, layers=None, seed=SEED, s_bf16=True):
    """Random fused params of a preset at full width (INT8 with bf16 scales,
    or fp32 ones when not s_bf16, or dense bf16), drawn on the card from a
    seed."""
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
    if quantize and s_bf16:
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


def hold_fused(cfg, params, x0, full_k, full_v, A, p, sin, cos, depth,
               kernel=None, plain=None, flags=None, held=("plain", "plain_cpu")):
    """A per-step megakernel (the small one unless `kernel`, `plain` and the
    GEMVs' activation types `flags` say otherwise) against its plain version
    on the same inputs, each run on its own copy of the caches: the plain
    version on the card and on the CPU (whose summation order the CPU tests
    tie to the JAX package's). Holds x_final and the new K/V rows of every
    layer within the depth's FUSED_TOL against the runs named in `held` (the
    others' errors are reported), and checks that no other slot changed.
    Returns (the errors and checks, the kernel's x_final on the card)."""
    import torch

    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd

    kernel = kernel or fd.fused_decode_step
    plain = plain or fd.fused_decode_step_ref
    pos, L, hd = int(p.item()), cfg.n_layers, cfg.head_dim
    cpu = torch.device("cpu")
    cpu_params = dict(blocks={k: _to_cpu(v) for k, v in params["blocks"].items()},
                      final_norm=params["final_norm"].cpu())
    runs = {}
    for name, fn, prm, where in (
            ("kernel", kernel, params, x0.device),
            ("plain", plain, params, x0.device),
            ("plain_cpu", plain, cpu_params, cpu)):
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
    xr, kr, vr = runs[held[0]]
    k0, k0r = kk[0, pos].float(), kr[0, pos].float()
    head_mag = k0r.abs().reshape(-1, hd).amax(-1, keepdim=True)
    k_ulp_ok = bool(((k0 - k0r).abs().reshape(-1, hd) <= _bf16_ulp(head_mag)).all())
    v_ulp_ok = bool(((vk[0, pos].float() - vr[0, pos].float()).abs()
                     <= _bf16_ulp(vr[0, pos])).all())
    if flags is None:
        flags = fd.gemv_int8_flags(params["blocks"],
                                   fd.plan_tiles(params["blocks"], full_k.dtype, A))
    # with int8 activations even layer 0's input differs in the last bit
    # (torch's rmsnorm mean sums in another order) and a flipped int8
    # rounding moves the row by more than an ulp: no one-ulp check there
    ulp_checked = not any(flags)
    tol = FUSED_TOL[(depth, any(flags))]
    ok = (all(e <= tol for ref in held for e in errs[ref])
          and (k_ulp_ok and v_ulp_ok or not ulp_checked)
          and untouched and bool(torch.isfinite(xk.float()).all()))
    check = dict(int8_activation=list(flags), tol=tol, held_against=list(held),
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
    from kuiperllama_tpu_torch.utils.profiling import device_time

    rows = []
    for i, (label, preset, quantize, g) in enumerate(FUSED_CASES):
        cfg, params = fused_model(dev, preset, quantize, g, FUSED_LAYERS,
                                  seed=SEED + 60 + i)
        x0, full_k, full_v, A, p, sin, cos = fused_inputs(cfg, params, dev)
        pos, hd = FUSED_POS, cfg.head_dim
        check, xk = hold_fused(cfg, params, x0, full_k, full_v, A, p, sin, cos,
                               "2 layers")

        variants = [(params,), (_clone_blocks(params),)]
        kc, vc = full_k[:, :A], full_v[:, :A]
        ms = device_time(lambda v: fd.fused_decode_step(cfg, v, x0, kc, vc, p, sin, cos),
                         variants=variants, device="cuda") * 1e3
        p_host = p.cpu()  # the plain version reads pos on the host
        plain_ms = device_time(lambda v: fd.fused_decode_step_ref(
            cfg, v, x0, kc, vc, p_host, sin, cos), variants=variants, iters=5,
            device="cuda") * 1e3
        cache = dict(k=full_k[:, None, :A].reshape(cfg.n_layers, 1, A, cfg.n_kv_heads, hd),
                     v=full_v[:, None, :A].reshape(cfg.n_layers, 1, A, cfg.n_kv_heads, hd))
        tok = torch.tensor([5], dtype=torch.int32, device=dev)
        layered_ms = device_time(lambda v: decoder.decode_step(
            cfg, v, tok, p, cache, rope=(sin, cos)), variants=variants, iters=10,
            device="cuda") * 1e3
        xf = xk.to(torch.bfloat16)
        lm_head_ms = device_time(lambda w: linear(xf, w), params["lm_head"], iters=10,
                                 device="cuda") * 1e3
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
    from kuiperllama_tpu_torch.params import param_bytes
    from kuiperllama_tpu_torch.serving.generate import Generator
    from kuiperllama_tpu_torch.utils.profiling import device_time

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
    zero_launches()
    rows, prefill_s, decode_s = gen.generate_batch_ids([prompt], max_new_tokens=128)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)

    steps = len(rows[0]) - 1
    ms_per_token = decode_s / steps * 1e3
    expect = dict(NO_LAUNCHES, fused_decode=steps,
                  quant_gemv=1 + steps if quantize else 0,
                  quant_gemm=4 * cfg.n_layers if quantize else 0)
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
    main_row = dict(phase="main_path", model=label, quant="int8" if quantize else "bf16",
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
                    launches_expected=expect, ok=ok, card=CARD)
    emit(main_row)
    if not ok:
        raise AssertionError(f"{label} main path failed its checks")

    # the kernel alone at the main path's shapes (full depth, pos 100 of a
    # 256-slot window, one step): held against its plain version, timed,
    # and one launch traced for the time of each phase per layer
    x0, full_k, full_v, A, p, sin, cos = fused_inputs(cfg, params, dev)
    check, _ = hold_fused(cfg, params, x0, full_k, full_v, A, p, sin, cos,
                          "full depth")
    kc, vc = full_k[:, :A], full_v[:, :A]
    ms = device_time(lambda v: fd.fused_decode_step(cfg, v, x0, kc, vc, p, sin, cos),
                     params, device="cuda") * 1e3
    p_host = p.cpu()
    plain_ms = device_time(lambda v: fd.fused_decode_step_ref(cfg, v, x0, kc, vc, p_host,
                                                              sin, cos),
                           params, iters=3, device="cuda") * 1e3
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
    return launches, step, main_row


def paged_inputs(dev, H, KH, hd, dtype, seed, layers):
    """q [B, H, hd] and stacked pools [layers, P, ps, KH*hd] drawn on the
    card, a shuffled page table and its work list for PAGED_LENS."""
    import numpy as np
    import torch

    from kuiperllama_tpu_torch.ops.kernels import paged_attention as pa

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    B, ps = len(PAGED_LENS), PAGED_PS
    max_pages = -(-max(PAGED_LENS) // ps)
    P = B * max_pages + 1
    kp = torch.randn((layers, P, ps, KH * hd), generator=gen, device=dev).to(dtype)
    vp = torch.randn((layers, P, ps, KH * hd), generator=gen, device=dev).to(dtype)
    q = torch.randn((B, H, hd), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    pt = perm.reshape(B, max_pages).to(torch.int32).cpu().numpy()
    sl = np.asarray(PAGED_LENS, np.int32)
    work = [torch.from_numpy(a).to(dev) for a in pa.build_work_list(pt, sl, ps)]
    return q, kp, vp, work, torch.from_numpy(sl).to(dev), pt


def hold_paged(q, kp, vp, work, sl, layer):
    """The kernel against its plain version on the card, both reading
    `layer`: errors of the normalised output, m and l relative to
    max|plain|, and the output's max-abs error."""
    from kuiperllama_tpu_torch.ops.kernels import paged_attention as pa

    args = (q, kp, vp, *work, sl)
    acc, m, l = pa.paged_attention_flat(*args, page_size=PAGED_PS, layer_idx=layer)
    ra, rm, rl = pa.paged_attention_flat_ref(*args, page_size=PAGED_PS,
                                             layer_idx=layer)
    out, ref = acc / l[..., None], ra / rl[..., None]
    return dict(rel_err_out=rel_err(out, ref), rel_err_m=rel_err(m, rm),
                rel_err_l=rel_err(l, rl),
                max_abs_err=(out - ref).abs().max().item(),
                finite=bool(out.isfinite().all()))


def phase_paged_kernel(dev):
    """The paged flash-decode kernel against its plain version on the card
    at four geometries with bf16 pools and one with fp32 pools, errors at
    PAGED_SEEDS seeds; CUDA-event times of the kernel, the plain version and
    scaled_dot_product_attention on K/V gathered ahead into a dense
    [B, H, S, hd] with a length mask (a yardstick the port never calls),
    beside the least time: the valid tokens' K and V bytes read once."""
    import torch
    import torch.nn.functional as F

    from kuiperllama_tpu_torch.ops.kernels import paged_attention as pa
    from kuiperllama_tpu_torch.utils.profiling import device_time, l2_copies

    cases = [(c, torch.bfloat16) for c in PAGED_CASES]
    cases.append((PAGED_CASES[2], torch.float32))
    rows = {}
    B, ps, tokens = len(PAGED_LENS), PAGED_PS, sum(PAGED_LENS)
    for i, ((label, H, KH, hd), dtype) in enumerate(cases):
        dname = "bf16" if dtype == torch.bfloat16 else "fp32"
        size = dtype.itemsize
        kv_bytes = 2 * tokens * KH * hd * size
        # enough stacked layers that timed launches rotate through more K/V
        # than L2 holds; correctness reads layer 1
        layers = 1 + l2_copies(kv_bytes, dev)
        readings = []
        for seed in range(PAGED_SEEDS):  # seed 0's inputs are the timed ones
            inputs = paged_inputs(dev, H, KH, hd, dtype, SEED + 70 + 10 * i + seed,
                                  2 if seed else layers)
            readings.append(hold_paged(*inputs[:5], 1))
            if not seed:
                q, kp, vp, work, sl, pt = inputs
            del inputs
        ms = device_time(lambda li: pa.paged_attention_flat(
            q, kp, vp, *work, sl, page_size=ps, layer_idx=li),
            variants=[(li,) for li in range(1, layers)], device="cuda") * 1e3
        plain_ms = device_time(lambda: pa.paged_attention_flat_ref(
            q, kp, vp, *work, sl, page_size=ps, layer_idx=1), iters=5,
            device="cuda") * 1e3
        # the library yardstick: K/V gathered into [B, H, S, hd] beforehand
        S = pt.shape[1] * ps
        idx = torch.from_numpy(pt).long().to(dev)
        dense = [p[1][idx].reshape(B, S, KH, hd).transpose(1, 2)
                 .repeat_interleave(H // KH, dim=1).contiguous() for p in (kp, vp)]
        mask = (torch.arange(S, device=dev)[None] < sl[:, None])[:, None, None]
        q4 = q[:, :, None]
        variants = [dense] + [[d.clone() for d in dense]
                              for _ in range(l2_copies(2 * dense[0].nbytes, dev) - 1)]
        library_ms = device_time(lambda k, v: F.scaled_dot_product_attention(
            q4, k, v, attn_mask=mask), variants=variants, device="cuda") * 1e3
        nbytes = kv_bytes + q.nbytes + B * H * (hd + 2) * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 4.0 * H * hd * tokens / PEAK_OPS_PER_S[dname] * 1e3
        worst = {k: max(r[k] for r in readings)
                 for k in ("rel_err_out", "rel_err_m", "rel_err_l", "max_abs_err")}
        tol = PAGED_TOL[dname]
        ok = (worst["rel_err_out"] <= tol and worst["rel_err_m"] <= PAGED_M_TOL
              and all(r["finite"] for r in readings))
        row = dict(phase="kernel", kernel="paged_attention", model=label,
                   pool_dtype=dname, B=B, seq_lens=PAGED_LENS, page_size=ps, H=H,
                   KH=KH, hd=hd, kv_mul=H // KH, layer=1, seeds=PAGED_SEEDS, **worst,
                   rel_err_out_by_seed=[r["rel_err_out"] for r in readings],
                   rel_err_m_by_seed=[r["rel_err_m"] for r in readings],
                   tol=tol, ok=ok, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   bound_bytes_ms=bytes_ms, bound_ops_ms=ops_ms, kv_bytes=kv_bytes,
                   card=CARD)
        emit(row)
        rows[(label, dname)] = row
        del q, kp, vp, dense, variants
        if not ok:
            raise AssertionError(f"paged_attention disagrees with its plain "
                                 f"version: {row}")
    return rows


def run_fixture_engines(where, cfg, params):
    """The tinychar requests through every FIXTURE_ENGINES engine on
    `where`, fp32 params and cache: {name: (token lists, engine)}."""
    import torch

    from kuiperllama_tpu_torch.params import to_device
    from kuiperllama_tpu_torch.serving import engine as E

    placed = to_device(params, device=where, dtype=torch.float32)
    out = {}
    for name, cls, kw in FIXTURE_ENGINES:
        eng = getattr(E, cls)(cfg, placed, max_batch=4, max_len=cfg.seq_len,
                              chunk=8, cache_dtype=torch.float32, **kw)
        reqs = [E.Request(prompt_ids=list(p), max_new_tokens=FIXTURE_NEW)
                for p in FIXTURE_PROMPTS]
        eng.run(reqs)
        out[name] = ([r.out_ids for r in reqs], eng)
    return out


def phase_engine_fixture(dev):
    """Engine, PagedEngine on 8-token pages with a pool small enough to
    preempt, and chunked PagedEngine over the tinychar fixture: greedy
    tokens equal on the card and on the CPU, and equal across the engines;
    paged_attention launched n_layers times per decode step on the card."""
    from kuiperllama_tpu_torch.checkpoint.binfmt import load_bin
    from kuiperllama_tpu_torch.ops.kernels import paged_attention as pa

    cfg, params = load_bin(os.path.join(HERE, FIXTURE))
    cpu = run_fixture_engines("cpu", cfg, params)
    pa.paged_attention_flat.launches = 0
    card = run_fixture_engines(dev, cfg, params)
    launches = pa.paged_attention_flat.launches
    steps = sum(eng.n_decode_steps for name, (_, eng) in card.items()
                if name != "dense")
    tokens = {name: toks for name, (toks, _) in card.items()}
    same = all(card[n][0] == cpu[n][0] for n in card)
    across = all(t == tokens["dense"] for t in tokens.values())
    preempted = (card["paged"][1].n_preemptions, cpu["paged"][1].n_preemptions)
    full = all(len(t) == FIXTURE_NEW for t in tokens["dense"])
    ok = (same and across and full and preempted[0] > 0 and preempted[0] == preempted[1]
          and launches == cfg.n_layers * steps)
    emit(dict(phase="engine_fixture", checkpoint=FIXTURE, dtype="fp32",
              requests=len(FIXTURE_PROMPTS), new_tokens=FIXTURE_NEW,
              engines=[n for n, _, _ in FIXTURE_ENGINES],
              tokens_equal_card_cpu=same, tokens_equal_across_engines=across,
              preemptions_card_cpu=list(preempted), paged_decode_steps=steps,
              paged_attention_launches=launches,
              paged_attention_launches_expected=cfg.n_layers * steps,
              tokens_gpu=tokens["paged"], ok=ok, card=CARD))
    if not ok:
        raise AssertionError("tinychar engines differ between card and CPU, "
                             "between engines, or in launch counts")
    return cfg, params, dict(zip(map(tuple, FIXTURE_PROMPTS), cpu["paged"][0]))


def profile_engine_chunk(eng, model, requests):
    """One decode chunk of PROFILE_STEPS steps with every slot active:
    its wall time unprofiled, then under torch.profiler (launches per step,
    device busy and idle share)."""
    import torch

    eng.chunk = PROFILE_STEPS
    for r in requests:
        eng.submit(r)
    eng.step()  # admission and a first chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    by_name, wall_ms = device_profile(eng.step)
    eng.run([])
    busy_ms = sum(ms for ms, _ in by_name.values())
    row = dict(phase="engine_profile", model=model, slots=eng.max_batch,
               steps=PROFILE_STEPS, decode_ms_per_step_unprofiled=step_ms,
               wall_ms_per_step_profiled=wall_ms / PROFILE_STEPS,
               device_busy_ms_per_step=(busy_ms / PROFILE_STEPS if by_name
                                        else "not measured"),
               device_idle_share_unprofiled=(1 - busy_ms / PROFILE_STEPS / step_ms
                                             if by_name else "not measured"),
               launches_per_step=sum(n for _, n in by_name.values()) / PROFILE_STEPS,
               top_kernels=top_kernels(by_name, PROFILE_STEPS),
               # device kernels, not wrapper calls: read_launches counts calls
               device_kernels_per_call={
                   "paged_attention": "2 (per-page statistics, then the row merge)",
                   "quant_gemm": "2 when K is split (the splits, then their "
                                 "ordered sum), else 1"},
               card=CARD)
    emit(row)
    return row


def phase_engine_main_path(dev, label, preset, prefill_chunk=0, long_prompt=0):
    """PagedEngine at full width and depth (INT8 g 256, bf16 scales,
    activations and pools, random weights from a seed): ENGINE_REQUESTS
    requests of ENGINE_PROMPT tokens (every 4th of `long_prompt` tokens when
    it is set) and ENGINE_NEW new tokens, all submitted at t0. Exact launch
    counts: paged_attention n_layers per decode step; the GEMM 4 n_layers + 1
    per decode step (M = 8) and one lm_head per prefill forward (>= 256 rows
    take the dequantize-then-matmul route)."""
    import torch

    from kuiperllama_tpu_torch.serving.engine import PagedEngine, Request

    cfg, params = fused_model(dev, preset, True, 256)
    eng = PagedEngine(cfg, params, max_batch=ENGINE_SLOTS, max_len=CACHE_LEN,
                      chunk=ENGINE_CHUNK, page_size=ENGINE_PS,
                      cache_dtype=torch.bfloat16, prefill_chunk=prefill_chunk)
    pool_bytes = eng.k_pages.nbytes + eng.v_pages.nbytes
    vocab = cfg.vocab_size

    def prompt(i, n):
        return [(7 * i + j) % (vocab - 1) + 1 for j in range(n)]

    eng.run([Request(prompt_ids=prompt(i, 16), max_new_tokens=4) for i in range(2)])
    torch.cuda.synchronize()
    reqs = [Request(prompt_ids=prompt(i, long_prompt if long_prompt and i % 4 == 3
                                      else ENGINE_PROMPT),
                    max_new_tokens=ENGINE_NEW) for i in range(ENGINE_REQUESTS)]
    eng.n_decode_steps = eng.n_prefill_calls = 0
    eng.prefill_wall_s = 0.0
    zero_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run([])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    steps, prefills = eng.n_decode_steps, eng.n_prefill_calls
    L = cfg.n_layers
    expect = dict(NO_LAUNCHES, paged_attention=L * steps,
                  quant_gemm=steps * (4 * L + 1) + prefills)
    generated = sum(len(r.out_ids) for r in reqs)
    ttft = sorted(r.ttft_s for r in reqs)
    pct = lambda v, p: v[min(len(v) - 1, int(len(v) * p / 100))]
    in_vocab = all(0 <= t < vocab for r in reqs for t in r.out_ids)
    ok = (len(done) == ENGINE_REQUESTS and generated == ENGINE_REQUESTS * ENGINE_NEW
          and in_vocab and launches == expect)
    row = dict(phase="engine_main_path", model=label, quant="int8", group_size=256,
               dtype="bf16", slots=ENGINE_SLOTS, max_len=CACHE_LEN, chunk=ENGINE_CHUNK,
               page_size=ENGINE_PS, prefill_chunk=prefill_chunk,
               requests=ENGINE_REQUESTS, prompt_len=ENGINE_PROMPT,
               long_prompt_every_4th=long_prompt or None, new_tokens=ENGINE_NEW,
               generated_tokens=generated, wall_s=wall_s, tokens_per_s=generated / wall_s,
               ttft_s_min=ttft[0], ttft_s_p50=pct(ttft, 50), ttft_s_p99=pct(ttft, 99),
               decode_steps=steps, prefill_calls=prefills,
               single_shot_prefill_s=eng.prefill_wall_s,
               wall_ms_per_decode_step=(wall_s - eng.prefill_wall_s) / steps * 1e3,
               preemptions=eng.n_preemptions, peak_memory_bytes=peak,
               pool_bytes=pool_bytes, launches=launches, launches_expected=expect,
               ok=ok, card=CARD)
    emit(row)
    if not ok:
        raise AssertionError(f"{label} engine main path failed its checks")
    prof = profile_engine_chunk(eng, label, [
        Request(prompt_ids=prompt(100 + i, ENGINE_PROMPT), max_new_tokens=3 * PROFILE_STEPS + 8)
        for i in range(ENGINE_SLOTS)])
    del eng, params
    return launches, row, prof


def phase_server(dev, cfg, params, want):
    """InferenceServer and its HTTP front end on 127.0.0.1 over a PagedEngine
    of the fixture on the card: concurrent /generate requests answer the CPU
    engine's tokens, /healthz and /metrics answer, an invalid request gets a
    400 and the next valid one is served; a request that times out is
    cancelled and its pages come back."""
    import threading
    import urllib.error
    import urllib.request

    import torch

    from kuiperllama_tpu_torch.params import to_device
    from kuiperllama_tpu_torch.serving.engine import PagedEngine
    from kuiperllama_tpu_torch.serving.server import InferenceServer, make_http_server

    eng = PagedEngine(cfg, to_device(params, device=dev, dtype=torch.float32),
                      max_batch=4, max_len=cfg.seq_len, chunk=8,
                      cache_dtype=torch.float32, page_size=8)
    srv = InferenceServer(eng)
    srv.start()
    httpd = make_http_server(srv, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    serving = threading.Thread(target=httpd.serve_forever, daemon=True)
    serving.start()

    def post(body):
        req = urllib.request.Request(f"{base}/generate", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def get(path):
        with urllib.request.urlopen(base + path, timeout=60) as resp:
            return json.loads(resp.read())

    try:
        results = [None] * len(FIXTURE_PROMPTS)

        def client(i):
            results[i] = post({"prompt_ids": FIXTURE_PROMPTS[i],
                               "max_new_tokens": FIXTURE_NEW})

        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(len(FIXTURE_PROMPTS))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
        answers_ok = all(r is not None and r[0] == 200
                         and r[1]["ids"] == want[tuple(p)]
                         for r, p in zip(results, FIXTURE_PROMPTS))
        health = get("/healthz")
        bad_code, bad = post({"prompt_ids": [], "max_new_tokens": 4})
        good_code, good = post({"prompt_ids": FIXTURE_PROMPTS[0],
                                "max_new_tokens": FIXTURE_NEW})
        metrics = get("/metrics")
        # a request that times out is cancelled: its slot and pages come back
        free0 = eng.allocator.n_free_pages
        try:
            srv.submit(prompt_ids=FIXTURE_PROMPTS[2], max_new_tokens=FIXTURE_NEW,
                       timeout_s=1e-3)
            timed_out = False
        except TimeoutError:
            timed_out = True
        end = time.perf_counter() + 60
        while (eng.has_work or eng.allocator.n_free_pages != free0) and \
                time.perf_counter() < end:
            time.sleep(0.01)
        freed = not eng.has_work and eng.allocator.n_free_pages == free0
        health_after = get("/healthz")
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
    ok = (answers_ok and health.get("ok") is True and bad_code == 400
          and good_code == 200 and good["ids"] == want[tuple(FIXTURE_PROMPTS[0])]
          and metrics.get("served") == len(FIXTURE_PROMPTS) + 1
          and timed_out and freed and health_after.get("ok") is True)
    emit(dict(phase="server", concurrent_requests=len(FIXTURE_PROMPTS),
              answers_equal_cpu_engine=answers_ok, healthz=health,
              invalid_request_status=bad_code, invalid_request_error=bad.get("error"),
              next_valid_status=good_code, metrics=metrics,
              timeout_raised=timed_out, timed_out_request_freed=freed,
              healthz_after_timeout=health_after, ok=ok, card=CARD))
    if not ok:
        raise AssertionError("the HTTP server failed its checks")


def layer_byte_us(params):
    """Microseconds at 3.35 TB/s for one layer's weights of each GEMV phase
    (int8 and scales, or bf16), beside the trace's time per phase."""
    from kuiperllama_tpu_torch.params import param_bytes

    b = params["blocks"]
    L = b["attn_norm"].shape[0]
    return {ph: param_bytes({"w": b[n]}) / L / HBM_BYTES_PER_S * 1e6
            for ph, n in (("qkv", "wqkv"), ("wo", "wo"), ("gate_up", "w13"),
                          ("w2", "w2"))}


def time_big_step(cfg, params, x0, kc, vc, p, sin, cos, variants, plain_n):
    """The big kernel's CUDA-event time over `variants` (one-tuples of
    params), its plain version's,
    the byte bound and one traced launch's us per phase per layer."""
    import torch

    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd
    from kuiperllama_tpu_torch.ops.kernels import fused_decode_big as fb
    from kuiperllama_tpu_torch.utils.profiling import device_time

    ms = device_time(lambda v: fb.fused_decode_step_big(cfg, v, x0, kc, vc, p, sin, cos),
                     variants=variants, device="cuda") * 1e3
    p_host = p.cpu()  # the plain version reads pos on the host
    plain_ms = device_time(lambda v: fb.fused_decode_step_big_ref(
        cfg, v, x0, kc, vc, p_host, sin, cos), variants=variants[:1], iters=plain_n,
        device="cuda") * 1e3
    L = cfg.n_layers
    trace = torch.zeros(2 + 5 * L, dtype=torch.int64, device=x0.device)
    fb.fused_decode_step_big(cfg, params, x0, kc, vc, p, sin, cos, trace=trace)

    phases = fd.phase_times(trace, L)
    nbytes = fused_step_bytes(cfg, params, int(p.item()), 2)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = fused_step_ops(cfg, params) / PEAK_OPS_PER_S["bf16"] * 1e3
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bound_bytes_ms=bytes_ms, bound_ops_ms=ops_ms, step_bytes=nbytes,
                share_of_bound=max(bytes_ms, ops_ms) / ms,
                traced_phase_us_per_layer={k: phases[k] / L for k in fd.PHASES},
                phase_byte_us_per_layer=layer_byte_us(params),
                traced_total_us=phases["total"])


def phase_fused_big_kernel(dev):
    """The big-model megakernel against its plain version on the card, at
    full width and FUSED_LAYERS layers of each BIG_CASES geometry, one step
    at pos 100 in a 256-slot window: errors, CUDA-event times of the kernel
    and the plain version, the byte bound and us per phase from the trace."""
    from kuiperllama_tpu_torch.ops.kernels import fused_decode_big as fb
    from kuiperllama_tpu_torch.ops.tuning import BIG_INT8

    rows = []
    for i, (label, preset, g, s_bf16) in enumerate(BIG_CASES):
        cfg, params = fused_model(dev, preset, True, g, FUSED_LAYERS,
                                  seed=SEED + 80 + i, s_bf16=s_bf16)
        x0, full_k, full_v, A, p, sin, cos = fused_inputs(cfg, params, dev)
        plan = fb.plan_big(params["blocks"], full_k.dtype, A)
        check, _ = hold_fused(cfg, params, x0, full_k, full_v, A, p, sin, cos,
                              "2 layers", kernel=fb.fused_decode_step_big,
                              plain=fb.fused_decode_step_big_ref,
                              flags=(BIG_INT8,) * 4)
        times = time_big_step(cfg, params, x0, full_k[:, :A], full_v[:, :A], p,
                              sin, cos, [(params,), (_clone_blocks(params),)], 5)
        row = dict(phase="kernel", kernel="fused_decode_big", model=label,
                   layers=FUSED_LAYERS, group_size=g,
                   scales="bf16" if s_bf16 else "fp32", plan=plan, pos=FUSED_POS,
                   window=A, **check, **times, card=CARD)
        emit(row)
        rows.append(row)
        del params, full_k, full_v
        if not (check["ok"] and plan is not None):
            raise AssertionError(f"fused_decode_big disagrees with its plain "
                                 f"version: {row}")
    return rows


def chunk_step_bytes(cfg, params, pos, steps, cache_itemsize):
    """Bytes per step of a `steps`-step chunk from slot `pos`: one
    megakernel step's (the K/V history grows by a row a step) plus the
    lm_head and the next token's embedding row."""
    from kuiperllama_tpu_torch.params import param_bytes

    extra = param_bytes({"w": params["lm_head"]}) + 2 * cfg.dim
    return sum(fused_step_bytes(cfg, params, pos + s, cache_itemsize) + extra
               for s in range(steps)) / steps


def hold_chunk(cfg, params, x0, full_k, full_v, A, p, sin, cos, steps, depth):
    """The chunk kernel against its plain version on the card, each on its
    own copy of the caches: the tokens equal up to a logit tie (at the first
    difference the plain version's logits of the two tokens lie within
    2e-3 of max(1, max|logit|) at 2 layers, within the depth's FUSED_TOL at
    full depth; nothing after it is compared), the K/V rows of the steps up
    to there within the depth's FUSED_TOL per layer, no other slot changed.
    Returns the checks."""
    import torch

    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd

    pos, L = int(p.item()), cfg.n_layers
    kk, vk = full_k.clone(), full_v.clone()
    got, _, _ = fd.fused_decode_chunk(cfg, params, x0, kk[:, :A], vk[:, :A], p,
                                      sin, cos, steps)
    got = got.tolist()
    kr, vr = full_k.clone(), full_v.clone()
    logits = []
    want, _, _ = fd.fused_decode_chunk_ref(cfg, params, x0, kr[:, :A], vr[:, :A],
                                           p.cpu(), sin, cos, steps, logits=logits)
    want = want.tolist()
    n = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), steps)
    # tie limit relative to max(1, max|logit|): the CPU tests' 2e-3 at 2
    # layers; at full depth x_final itself moves by 2-3% between two valid
    # summation orders (the fused_step rows), so the rows' limit there
    flags = fd.gemv_int8_flags(params["blocks"],
                               fd.plan_tiles(params["blocks"], full_k.dtype, A))
    lm_int8 = fd.lm_int8_activation(params["lm_head"], cfg.dim)
    tol = FUSED_TOL[(depth, any(flags) or lm_int8)]
    tie_tol = 2e-3 if depth == "2 layers" else tol
    gap, tie_ok = None, True
    if n < steps:
        row = logits[n]
        gap = abs(float(row[got[n]]) - float(row[want[n]])) / max(1.0, row.abs().max().item())
        tie_ok = gap <= tie_tol
    untouched = all(torch.equal(a[:, :pos], b[:, :pos])
                    and torch.equal(a[:, pos + steps:], b[:, pos + steps:])
                    for a, b in ((kk, full_k), (vk, full_v)))
    rows = [(a[li, pos:pos + n + 1], b[li, pos:pos + n + 1])
            for a, b in ((kk, kr), (vk, vr)) for li in range(L)]
    err = max(rel_err(a, b) for a, b in rows)
    abs_err = max((a.float() - b.float()).abs().max().item() for a, b in rows)
    ok = (tie_ok and err <= tol and untouched and len(got) == steps
          and all(0 <= t < cfg.vocab_size for t in got))
    return dict(steps=steps, int8_activation=list(flags), lm_int8_activation=lm_int8,
                tokens_kernel=got, tokens_plain=want,
                first_differing_step=None if n == steps else n,
                tie_logit_gap_rel=gap, tie_tol=tie_tol, tol=tol, rel_err_new_rows=err, max_abs_err=abs_err,
                other_slots_untouched=untouched, ok=ok)


def time_chunk(cfg, params, x0, kc, vc, p, sin, cos, steps, variants, plain_n):
    """ms per step of the chunk kernel (CUDA events over launches of `steps`
    steps, rotating `variants`, one-tuples of params), of its plain version,
    and the per-step byte bound."""
    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd
    from kuiperllama_tpu_torch.utils.profiling import device_time

    ms = device_time(lambda v: fd.fused_decode_chunk(cfg, v, x0, kc, vc, p, sin, cos,
                                                     steps),
                     variants=variants, device="cuda") * 1e3 / steps
    p_host = p.cpu()
    plain_ms = device_time(lambda v: fd.fused_decode_chunk_ref(
        cfg, v, x0, kc, vc, p_host, sin, cos, steps), variants=variants[:1],
        iters=plain_n, device="cuda") * 1e3 / steps
    nbytes = chunk_step_bytes(cfg, params, int(p.item()), steps, 2)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    lm = params["lm_head"]
    ops = fused_step_ops(cfg, params) + 2.0 * cfg.dim * lm.shape[-1]
    ops_ms = ops / PEAK_OPS_PER_S["bf16"] * 1e3
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bound_bytes_ms=bytes_ms, bound_ops_ms=ops_ms, step_bytes=nbytes,
                share_of_bound=max(bytes_ms, ops_ms) / ms)


def phase_fused_chunk_kernel(dev):
    """The chunk kernel against its plain version on the card at full width
    and FUSED_LAYERS layers of each CHUNK_CASES geometry, CHUNK_STEPS steps
    from pos 100 in a 256-slot window; ms per step against the per-step
    bound (the layer stack and the lm_head)."""
    rows = []
    for i, (label, preset, quantize, g) in enumerate(CHUNK_CASES):
        cfg, params = fused_model(dev, preset, quantize, g, FUSED_LAYERS,
                                  seed=SEED + 90 + i)
        x0, full_k, full_v, A, p, sin, cos = fused_inputs(cfg, params, dev)
        check = hold_chunk(cfg, params, x0, full_k, full_v, A, p, sin, cos,
                           CHUNK_STEPS, "2 layers")
        times = time_chunk(cfg, params, x0, full_k[:, :A], full_v[:, :A], p, sin,
                           cos, CHUNK_STEPS, [(params,), (_clone_blocks(params),)], 2)
        row = dict(phase="kernel", kernel="fused_decode_chunk", model=label,
                   layers=FUSED_LAYERS, group_size=g,
                   quant="int8" if quantize else "bf16", pos=FUSED_POS, window=A,
                   **check, **times, card=CARD)
        emit(row)
        rows.append(row)
        del params, full_k, full_v
        if not check["ok"]:
            raise AssertionError(f"fused_decode_chunk disagrees with its plain "
                                 f"version: {row}")
    return rows


INT8_HOLD = (2, 4096, 2048, 64)    # exp_int8 held at L, K, N, g (the tool's K, N, g)
INT8_TOOL = (64, 4096, 2048, 64)   # and timed at the tool's defaults
INT8_TOL = 1e-5


def tool_operands(dev, K, N, seed):
    """q, s (Q8_0 of normal draws, group 64, fp32 scales) and bf16 x [8, K],
    as exp_kernel.main makes them."""
    import torch

    from kuiperllama_tpu_torch.quant import quantize_q80
    from kuiperllama_tpu_torch.tools import exp_kernel as ek

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    w = quantize_q80(torch.randn((K, N), generator=gen, device=dev), ek.G)
    x = torch.randn((ek.M_DECODE, K), generator=gen, device=dev).to(torch.bfloat16)
    return x, w.q, w.s


def hold_exp_kernel(dev):
    """exp_stream at every stream tile of the JAX tool that divides each
    TinyLlama-1.1B shape (equal to its plain version; lm_head has none),
    exp_outscale at each shape's sweep tiles and the tool's `current` (the
    GEMM: bf16 x, fp32 scales, g 64) at M = 8 (both within 2^-7), then
    times: kernel, plain version, and the yardstick (torch.sum of q in int32
    for the stream; bf16 x @ the pre-dequantized bf16 weight for outscale)
    beside the bound, on weight copies rotated past L2."""
    import torch

    from kuiperllama_tpu_torch.ops.kernels import quant_matmul as qm
    from kuiperllama_tpu_torch.tools import exp_kernel as ek
    from kuiperllama_tpu_torch.utils.profiling import device_time, l2_copies

    def ms(fn, variants, iters=25):
        return device_time(fn, variants=variants, iters=iters, device="cuda") * 1e3

    stream, outscale = [], []
    for i, (name, (K, N)) in enumerate(ek.SHAPES.items()):
        x, q, s = tool_operands(dev, K, N, SEED + 70 + i)
        M = x.shape[0]
        qs = [(q,)] + [(q.clone(),) for _ in range(l2_copies(K * N, dev) - 1)]
        tiles = [t for t in ek.STREAM_TILES if K % t[0] == 0 and N % t[1] == 0]
        errs = [(ek.exp_stream(q, tk, tn) - ek.stream_ref(q, tk, tn)).abs().item()
                for tk, tn in tiles]
        if tiles:
            tk, tn = tiles[0]
            row = dict(phase="tools", kernel="exp_stream", weight=name, K=K, N=N,
                       tiles_held=tiles, max_abs_err=max(errs), ok=max(errs) == 0,
                       tk=tk, tn=tn,
                       ms=ms(lambda qq: ek.exp_stream(qq, tk, tn), qs),
                       plain_ms=ms(lambda qq: ek.stream_ref(qq, tk, tn), qs, 10),
                       yardstick_ms=ms(lambda qq: torch.sum(qq, dtype=torch.int32), qs),
                       bound_ms=K * N / HBM_BYTES_PER_S * 1e3, bound_by="bytes", card=CARD)
            emit(row)
            stream.append(row)
            if not row["ok"]:
                raise AssertionError(f"exp_stream differs from its plain version: {row}")

        got, want = qm.quant_gemm(x, q, s, ek.G), qm.quant_gemm_ref(x, q, s, ek.G)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        row = dict(phase="tools", kernel="quant_gemm", variant="current", weight=name,
                   M=M, K=K, N=N, g=ek.G, scales="float32", rel_err=err,
                   max_abs_err=(got.float() - want.float()).abs().max().item(),
                   ok=err <= BF16_ULP and bool(torch.isfinite(got).all()), card=CARD)
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"quant_gemm disagrees with its plain version: {row}")

        tk, tn = ek.sweep_tiles(K, N)
        got, want = ek.exp_outscale(x, q, s, tk, tn), ek.outscale_ref(x, q, s, tk, tn)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        wd = qm.dequantize_bf16(q, s, ek.G)
        wds = [(x, wd)] + [(x, wd.clone()) for _ in range(l2_copies(2 * K * N, dev) - 1)]
        bytes_ms, ops_ms = bound(M, K, N, ek.G, 2, 4, 2, "bf16")
        row = dict(phase="tools", kernel="exp_outscale", weight=name, M=M, K=K, N=N,
                   tk=tk, tn=tn, rel_err=err,
                   max_abs_err=(got.float() - want.float()).abs().max().item(),
                   ok=err <= BF16_ULP and bool(torch.isfinite(got).all()),
                   ms=ms(lambda qq: ek.exp_outscale(x, qq, s, tk, tn), qs),
                   plain_ms=ms(lambda qq: ek.outscale_ref(x, qq, s, tk, tn), qs, 10),
                   library_ms=ms(torch.matmul, wds),
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations", card=CARD)
        emit(row)
        outscale.append(row)
        del qs, wd, wds
        if not row["ok"]:
            raise AssertionError(f"exp_outscale disagrees with its plain version: {row}")
    return stream, outscale


def int8_bound(mode, L, K, N, g):
    """(bytes, bound ms, bound_by) of one exp_int8 pass: nodot reads the
    weights alone and adds 16 rows per layer; the GEMV modes read weights,
    fp32 scales and x and do 2 L K N operations at the peak of their type."""
    if mode == "nodot":
        nbytes, ops, kind = L * K * N + 4 * N, 16.0 * L * N, "fp32"
    else:
        nbytes = L * K * N + 4 * L * (K // g) * N + 2 * K + 4 * N
        ops, kind = 2.0 * L * K * N, "int8" if mode.startswith("int8") else "bf16"
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[kind] * 1e3
    return nbytes, max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def hold_exp_int8(dev):
    """Every exp_int8 mode at its tool split, held against its plain version
    at INT8_HOLD and on the tool's own default stack, INT8_TOOL (nodot
    equal, the rest within INT8_TOL), then timed there (ms per pass, GB/s of
    the bytes the mode reads, us per tile) beside its bound and the plain
    version. No single library call sums a GEMV over layers."""
    import torch

    from kuiperllama_tpu_torch.tools import exp_int8 as ei

    def hold(w, s, x, g, mode, nsplit):
        got = ei.exp_int8(w, s, x, g, mode, nsplit)
        want = ei.exp_int8_ref(w, s, x, g, mode, nsplit)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        err = rel_err(got, want)
        return dict(rel_err=err, max_abs_err=(got - want).abs().max().item(),
                    equal=equal, ok=equal if mode == "nodot" else err <= INT8_TOL)

    w, s, x = ei.make_stack(dev, *INT8_HOLD, seed=SEED + 80)
    small = {m: hold(w, s, x, INT8_HOLD[3], m, ei.default_nsplit(m)) for m in ei.MODES}
    del w, s, x
    L, K, N, g = INT8_TOOL
    w, s, x = ei.make_stack(dev, L, K, N, g)  # exp_int8.main's stack
    rows = []
    for mode in ei.MODES:
        nsplit = ei.default_nsplit(mode)
        full = hold(w, s, x, g, mode, nsplit)
        ms = ei.measure(w, s, x, g, mode, nsplit) * 1e3
        nbytes, bound_ms, bound_by = int8_bound(mode, L, K, N, g)
        row = dict(phase="tools", kernel="exp_int8", mode=mode, nsplit=nsplit,
                   held_at={f"L={INT8_HOLD[0]}": small[mode], f"L={L}": full},
                   max_abs_err=max(small[mode]["max_abs_err"], full["max_abs_err"]),
                   ok=small[mode]["ok"] and full["ok"],
                   L=L, K=K, N=N, g=g, ms=ms, bytes=nbytes,
                   GBps=nbytes / ms / 1e6, us_per_tile=ms / L * 1e3,
                   plain_ms=ei.measure(w, s, x, g, mode, nsplit, 3, ei.exp_int8_ref) * 1e3,
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by, card=CARD)
        emit(row)
        rows.append(row)
        if not row["ok"]:
            raise AssertionError(f"exp_int8 ({mode}) disagrees with its plain version: {row}")
    return rows


def phase_tools(dev):
    """The kernel-measurement tools (kuiperllama_tpu_torch/tools): the
    roofline probes at their defaults, the three tool kernels held and
    timed, then the tools' own entry points as a user runs them
    (`exp_kernel` and `exp_int8` with their defaults, `bench_kernels` at
    llama2-7b M = 8, kernel and torch variants), with every launch count
    zeroed just before and read just after: each timed call launches once
    (plus one warm-up per variant), so the counts are exact."""
    from kuiperllama_tpu_torch.tools import ITERS, bench_kernels, roofline
    from kuiperllama_tpu_torch.tools import exp_int8 as ei
    from kuiperllama_tpu_torch.tools import exp_kernel as ek

    emit(dict(phase="tools", tool="roofline", **roofline.run(dev), card=CARD))
    stream, outscale = hold_exp_kernel(dev)
    int8 = hold_exp_int8(dev)
    # bench_kernels' kernel variant at llama2-7b, M = 8: the GEMM at g 64
    # with fp32 scales at each of its five shapes
    for i, (name, K, N, _) in enumerate(GEMV_SHAPES):
        check_kernel("quant_gemm", dev, ENGINE_SLOTS, K, N, 64, "fast", SEED + 100 + i,
                     name, scales="float32")

    zero_launches()
    ek_rows = ek.main(["--device", "cuda"])
    ei_rows = ei.main(["--device", "cuda"])
    bench = {v: bench_kernels.main(["--device", "cuda", "--model", "llama2-7b",
                                    "--m", str(ENGINE_SLOTS),
                                    "--variant", v])
             for v in ("kernel", "torch")}
    launches = read_launches()
    calls = ITERS + 1
    n = {v: sum(r["variant"] == v for r in ek_rows) for v in ("stream", "current", "outscale")}
    expect = dict(NO_LAUNCHES, exp_stream=calls * n["stream"],
                  exp_outscale=calls * n["outscale"], exp_int8=calls * len(ei_rows),
                  quant_gemm=calls * (n["current"] + 5))
    for out in bench.values():
        emit(dict(phase="tools", tool="bench_kernels", **out, card=CARD))
    n_stream = sum(K % tk == 0 and N % tn == 0 for K, N in ek.SHAPES.values()
                   for tk, tn in ek.STREAM_TILES)
    ok = (launches == expect and n == dict(stream=n_stream, current=len(ek.SHAPES),
                                           outscale=len(ek.SHAPES))
          and len(ei_rows) == 5)
    emit(dict(phase="main_path", path="tools", exp_kernel_rows=len(ek_rows),
              exp_int8_rows=len(ei_rows), launches=launches, launches_expected=expect,
              ok=ok, card=CARD))
    if not ok:
        raise AssertionError("the tools' launch counts differ from their rows")
    return dict(exp_stream=stream, exp_outscale=outscale, exp_int8=int8), launches


NO_LAUNCHES = dict.fromkeys(("quant_gemv", "quant_gemm", "fused_decode",
                             "fused_decode_big", "fused_decode_chunk",
                             "paged_attention", "exp_stream", "exp_outscale",
                             "exp_int8"), 0)


def zero_launches():
    """Every kernel wrapper's launch count, set to 0."""
    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd
    from kuiperllama_tpu_torch.ops.kernels import fused_decode_big as fb
    from kuiperllama_tpu_torch.ops.kernels import paged_attention as pa
    from kuiperllama_tpu_torch.ops.kernels import quant_matmul as qm
    from kuiperllama_tpu_torch.tools import exp_int8 as ei
    from kuiperllama_tpu_torch.tools import exp_kernel as ek

    qm.quant_gemv.launches = qm.quant_gemm.launches = 0
    fd.fused_decode_step.launches = fd.fused_decode_chunk.launches = 0
    fb.fused_decode_step_big.launches = pa.paged_attention_flat.launches = 0
    ek.exp_stream.launches = ek.exp_outscale.launches = ei.exp_int8.launches = 0


def read_launches():
    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd
    from kuiperllama_tpu_torch.ops.kernels import fused_decode_big as fb
    from kuiperllama_tpu_torch.ops.kernels import paged_attention as pa
    from kuiperllama_tpu_torch.ops.kernels import quant_matmul as qm
    from kuiperllama_tpu_torch.tools import exp_int8 as ei
    from kuiperllama_tpu_torch.tools import exp_kernel as ek

    return {"quant_gemv": qm.quant_gemv.launches, "quant_gemm": qm.quant_gemm.launches,
            "exp_stream": ek.exp_stream.launches,
            "exp_outscale": ek.exp_outscale.launches,
            "exp_int8": ei.exp_int8.launches,
            "fused_decode": fd.fused_decode_step.launches,
            "fused_decode_big": fb.fused_decode_step_big.launches,
            "fused_decode_chunk": fd.fused_decode_chunk.launches,
            "paged_attention": pa.paged_attention_flat.launches}


def phase_big_main_path(dev):
    """The big route at full width and depth: Llama-2-7B INT8 g 64 (bf16
    scales, activations and cache, cache length 1024, random weights from a
    seed) through Generator.generate_batch_ids under KT_FUSED_BIG=1, one
    32-token prompt, 128 new tokens, greedy; launch counts zeroed just
    before and read just after. The same weights on the layered route
    beside it (its decode profile is the g 256 main path's), a decode
    profile of the big route, then the big kernel alone at the main path's
    shapes: held against its plain version on the CPU, timed, one launch
    traced."""
    import torch

    from kuiperllama_tpu_torch.config import preset_config
    from kuiperllama_tpu_torch.fuse import fuse_params
    from kuiperllama_tpu_torch.ops.kernels import fused_decode_big as fb
    from kuiperllama_tpu_torch.ops.tuning import BIG_INT8
    from kuiperllama_tpu_torch.params import param_bytes, random_params_device
    from kuiperllama_tpu_torch.quant import cast_scales
    from kuiperllama_tpu_torch.serving.generate import Generator

    cfg = preset_config("llama2-7b", seq_len=CACHE_LEN)
    t0 = time.perf_counter()
    params = random_params_device(cfg, device=dev, seed=SEED, quantize=True,
                                  group_size=64)
    params = cast_scales(fuse_params(params), torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    b = params["blocks"]
    stream = [b["wqkv"], b["wo"], b["w13"], b["w2"], params["lm_head"]]
    weight_bytes = sum(param_bytes({"w": w}) for w in stream)
    floor_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    prompt = list(range(5, 5 + 32))
    with knob("KT_FUSED_BIG"):
        gen = Generator(cfg, params, cache_len=CACHE_LEN, cache_dtype=torch.bfloat16,
                        chunk=128)
        gen.generate_batch_ids([prompt], max_new_tokens=8)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_launches()
        rows, prefill_s, decode_s = gen.generate_batch_ids([prompt], max_new_tokens=128)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated(dev)
        fused_ok = gen._fused_ok(1)
        prof = profile_decode(cfg, params, gen, prompt, dev, fused=True,
                              model="llama2-7b g64 big")
    steps = len(rows[0]) - 1
    ms_per_token = decode_s / steps * 1e3
    expect = dict(NO_LAUNCHES, quant_gemv=1 + steps, quant_gemm=4 * cfg.n_layers,
                  fused_decode_big=steps)
    layered = Generator(cfg, params, cache_len=CACHE_LEN, cache_dtype=torch.bfloat16,
                        chunk=128, fused_step=False)
    rows_l, _, layered_s = layered.generate_batch_ids([prompt], 128)
    first_diff = next((i for i, (a, c) in enumerate(zip(rows[0], rows_l[0]))
                       if a != c), None)
    in_vocab = all(0 <= t < cfg.vocab_size for t in rows[0])
    ok = (len(rows[0]) == 128 and in_vocab and fused_ok and launches == expect)
    busy = prof["device_busy_ms_per_step"]
    emit(dict(phase="main_path", model="llama2-7b", quant="int8", group_size=64,
              dtype="bf16", cache_len=CACHE_LEN, prompt_len=32, new_tokens=len(rows[0]),
              route="big (KT_FUSED_BIG=1)", prefill_ms=prefill_s * 1e3,
              decode_steps=steps, decode_ms_per_token=ms_per_token,
              decode_tokens_per_s=steps / decode_s, weight_bytes_per_token=weight_bytes,
              floor_ms_per_token=floor_ms, share_of_floor=floor_ms / ms_per_token,
              layered_decode_ms_per_token=layered_s / (len(rows_l[0]) - 1) * 1e3,
              layered_share_of_floor=floor_ms / (layered_s / (len(rows_l[0]) - 1) * 1e3),
              first_token_differing_from_layered=first_diff,
              launches_per_step_profiled=prof["kernels_per_step"],
              device_busy_ms_per_step=busy,
              device_idle_share_unprofiled=(1 - busy / ms_per_token
                                            if isinstance(busy, float) else "not measured"),
              peak_memory_bytes=peak, init_s=init_s, launches=launches,
              launches_expected=expect, ok=ok, card=CARD))
    if not ok:
        raise AssertionError("Llama-2-7B big-route main path failed its checks")

    x0, full_k, full_v, A, p, sin, cos = fused_inputs(cfg, params, dev)
    check, _ = hold_fused(cfg, params, x0, full_k, full_v, A, p, sin, cos,
                          "full depth", kernel=fb.fused_decode_step_big,
                          plain=fb.fused_decode_step_big_ref,
                          flags=(BIG_INT8,) * 4, held=("plain_cpu",))
    times = time_big_step(cfg, params, x0, full_k[:, :A], full_v[:, :A], p, sin,
                          cos, [(params,)], 1)
    step = dict(phase="fused_big_step", model="llama2-7b g64", layers=cfg.n_layers,
                pos=FUSED_POS, window=A, **check, **times, card=CARD)
    emit(step)
    if not (check["ok"] and all(t > 0 for t in times["traced_phase_us_per_layer"].values())):
        raise AssertionError("fused_decode_big disagrees with its plain version "
                             "at full depth")
    return launches, step


def phase_chunk_main_path(dev, label, preset, quantize, per_step_row):
    """One model of the chunk route at full width and depth through
    Generator.generate_batch_ids under KT_FUSED_CHUNK=1 (64-step chunks, the
    Generator's default), greedy, as the per-step route's main path
    (`per_step_row`, whose numbers stand beside); then the chunk kernel alone
    at the main path's shapes (CHUNK_STEPS steps from pos 100 of a 256-slot
    window): held against its plain version on the card and timed."""
    import torch

    from kuiperllama_tpu_torch.params import param_bytes
    from kuiperllama_tpu_torch.serving.generate import Generator

    cfg, params = fused_model(dev, preset, quantize, 256)
    b = params["blocks"]
    stream = [b[n] for n in ("wqkv", "wo", "w13", "w2", "bqkv") if n in b]
    weight_bytes = sum(param_bytes({"w": w}) for w in stream + [params["lm_head"]])
    floor_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    prompt = list(range(5, 5 + 32))
    with knob("KT_FUSED_CHUNK"):
        gen = Generator(cfg, params, cache_len=CACHE_LEN, cache_dtype=torch.bfloat16)
        gen.generate_batch_ids([prompt], max_new_tokens=8)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_launches()
        rows, prefill_s, decode_s = gen.generate_batch_ids([prompt], max_new_tokens=128)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated(dev)
        prof = profile_decode(cfg, params, gen, prompt, dev, fused=True,
                              model=f"{label} chunk")
    steps = len(rows[0]) - 1
    ms_per_token = decode_s / steps * 1e3
    expect = dict(NO_LAUNCHES, quant_gemv=1 if quantize else 0,
                  quant_gemm=4 * cfg.n_layers if quantize else 0,
                  fused_decode_chunk=-(-steps // gen.chunk))
    in_vocab = all(0 <= t < cfg.vocab_size for t in rows[0])
    ok = len(rows[0]) == 128 and in_vocab and launches == expect
    busy = prof["device_busy_ms_per_step"]
    emit(dict(phase="main_path", model=label, quant="int8" if quantize else "bf16",
              group_size=256 if quantize else None, dtype="bf16", cache_len=CACHE_LEN,
              prompt_len=32, new_tokens=len(rows[0]), route="chunk (KT_FUSED_CHUNK=1)",
              chunk=gen.chunk, prefill_ms=prefill_s * 1e3, decode_steps=steps,
              decode_ms_per_token=ms_per_token, decode_tokens_per_s=steps / decode_s,
              weight_bytes_per_token=weight_bytes, floor_ms_per_token=floor_ms,
              share_of_floor=floor_ms / ms_per_token,
              per_step_route_ms_per_token=per_step_row["decode_ms_per_token"],
              per_step_route_device_idle_share=per_step_row["device_idle_share_unprofiled"],
              launches_per_chunk_profiled=prof["kernels_per_step"] * prof["steps"],
              device_busy_ms_per_step=busy,
              device_idle_share_unprofiled=(1 - busy / ms_per_token
                                            if isinstance(busy, float) else "not measured"),
              peak_memory_bytes=peak, launches=launches, launches_expected=expect,
              ok=ok, card=CARD))
    if not ok:
        raise AssertionError(f"{label} chunk-route main path failed its checks")

    x0, full_k, full_v, A, p, sin, cos = fused_inputs(cfg, params, dev)
    check = hold_chunk(cfg, params, x0, full_k, full_v, A, p, sin, cos,
                       CHUNK_STEPS, "full depth")
    times = time_chunk(cfg, params, x0, full_k[:, :A], full_v[:, :A], p, sin, cos,
                       CHUNK_STEPS, [(params,)], 1)
    step = dict(phase="fused_chunk_step", model=label, layers=cfg.n_layers,
                pos=FUSED_POS, window=A, **check, **times, card=CARD)
    emit(step)
    if not check["ok"]:
        raise AssertionError(f"fused_decode_chunk disagrees with its plain version "
                             f"at full depth ({label})")
    return launches, step


def _sum(rows, key):
    return sum(r[key] * n for r, n in rows)


def tool_entries(tool_rows, launches):
    """The kernels line's entries of the tool kernels; `launches` is the
    tools' main path (their entry points run with their defaults)."""
    st, os_ = tool_rows["exp_stream"], tool_rows["exp_outscale"]
    bf16 = next(r for r in tool_rows["exp_int8"] if r["mode"] == "bf16")

    def total(rows, key):
        return sum(r[key] for r in rows)

    def entry(name, source, replaces, **fields):
        return dict(name=name, route="cuda", source=f"kuiperllama_tpu_torch/csrc/{source}.cu",
                    replaces=replaces, launches=launches[name], **fields, card=CARD)

    return [
        entry("exp_stream", "exp_kernel", "tools/exp_kernel.py:57",
              max_abs_err=max(r["max_abs_err"] for r in st), ms=total(st, "ms"),
              plain_ms=total(st, "plain_ms"), bound_ms=total(st, "bound_ms"),
              bound_by="bytes",
              # torch.sum reads the same bytes but computes another value
              library_ms=None, yardstick_ms=total(st, "yardstick_ms"),
              per="one sweep of the TinyLlama-1.1B shapes that have a stream tile, "
                  "each at its first: " + ", ".join(
                      f"{r['weight']} {r['tk']}x{r['tn']}" for r in st)),
        entry("exp_outscale", "exp_kernel", "tools/exp_kernel.py:86",
              max_abs_err=max(r["max_abs_err"] for r in os_), ms=total(os_, "ms"),
              plain_ms=total(os_, "plain_ms"), bound_ms=total(os_, "bound_ms"),
              bound_by="bytes", library_ms=total(os_, "library_ms"),
              per="one sweep of the five TinyLlama-1.1B shapes at M = 8, bf16 x, "
                  "fp32 scales: " + ", ".join(
                      f"{r['weight']} {r['tk']}x{r['tn']}" for r in os_)),
        entry("exp_int8", "exp_int8", "tools/exp_int8.py:47",
              max_abs_err=max(r["max_abs_err"] for r in tool_rows["exp_int8"]),
              ms=bf16["ms"], plain_ms=bf16["plain_ms"], bound_ms=bf16["bound_ms"],
              bound_by=bf16["bound_by"],
              # no single PyTorch call sums a GEMV over 64 layers
              library_ms=None,
              per="one bf16-mode pass over the tool's stack: L 64, K 4096, N 2048, "
                  "g 64 (every mode's time is in the tools rows)"),
    ]


def kernels_line(gemv, gemm, fused_rows, fused_step, paged_rows, launches_by_path,
                 big_rows, big_step, chunk_rows, chunk_step, tool_rows):
    """One entry per kernel. `launches` is the count on the kernel's main
    path (Llama-2-7B for the GEMV and GEMM, TinyLlama-1.1B for the
    megakernel, the Llama-2-7B engine for paged attention, the Llama-2-7B
    big route for the big-model megakernel, TinyLlama-1.1B's chunk route for
    the chunk kernel); `launches_by_path` has every path's count."""
    from kuiperllama_tpu_torch.config import preset_config

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
    # per engine decode step of Llama-2-7B: one launch per layer at the
    # kernel phase's 7B shapes
    p7 = paged_rows[("llama2-7b", "bf16")]
    n7 = preset_config("llama2-7b").n_layers
    paged = dict(
        name="paged_attention", route="cuda",
        source="kuiperllama_tpu_torch/csrc/paged_attention.cu",
        replaces="kuiperllama_tpu/ops/pallas/paged_attention.py:71",
        launches=launches_by_path["engine llama2-7b"]["paged_attention"],
        max_abs_err=max(r["max_abs_err"] for r in paged_rows.values()),
        ms=n7 * p7["ms"], plain_ms=n7 * p7["plain_ms"], bound_ms=n7 * p7["bound_ms"],
        bound_by=p7["bound_by"], library_ms=n7 * p7["library_ms"],
        per="one Llama-2-7B B = 8 engine decode step: 32 launches, bf16 pools, "
            f"seq_lens {PAGED_LENS}, 128-token pages",
        launches_by_path=by_path("paged_attention"), card=CARD)
    big = dict(
        name="fused_decode_big", route="cuda",
        source="kuiperllama_tpu_torch/csrc/fused_decode_big.cu",
        replaces="kuiperllama_tpu/ops/pallas/fused_decode_big.py:147",
        launches=launches_by_path["llama2-7b big"]["fused_decode_big"],
        max_abs_err=max(r["max_abs_err"] for r in big_rows + [big_step]),
        ms=big_step["ms"], plain_ms=big_step["plain_ms"], bound_ms=big_step["bound_ms"],
        bound_by=big_step["bound_by"],
        # no single PyTorch call computes a decode step of the layer stack
        library_ms=None,
        per="one Llama-2-7B decode step: 32 layers, INT8 g 64, bf16 scales and "
            "cache, pos 100 in a 256-slot window",
        launches_by_path=by_path("fused_decode_big"), card=CARD)
    chunk = dict(
        name="fused_decode_chunk", route="cuda",
        source="kuiperllama_tpu_torch/csrc/fused_decode_chunk.cu",
        replaces="kuiperllama_tpu/ops/pallas/fused_decode.py:627",
        launches=launches_by_path["tinyllama-1.1b chunk"]["fused_decode_chunk"],
        max_abs_err=max(r["max_abs_err"] for r in chunk_rows + [chunk_step]),
        ms=chunk_step["ms"], plain_ms=chunk_step["plain_ms"],
        bound_ms=chunk_step["bound_ms"], bound_by=chunk_step["bound_by"],
        # no single PyTorch call computes greedy decode steps
        library_ms=None,
        per=f"one TinyLlama-1.1B greedy step of a {CHUNK_STEPS}-step chunk: 22 "
            "layers and the lm_head, INT8 g 256, bf16 scales and cache, from "
            "pos 100 in a 256-slot window",
        launches_by_path=by_path("fused_decode_chunk"), card=CARD)
    return {"kernels": [
        entry("quant_gemv", gemv, "kuiperllama_tpu/ops/pallas/quant_matmul.py:202",
              "one Llama-2-7B decode token: 32 x (wqkv, wo, w13, w2) + lm_head, "
              "g 256, bf16"),
        entry("quant_gemm", gemm, "kuiperllama_tpu/ops/pallas/quant_matmul.py:132",
              "one Llama-2-7B prefill of 32 tokens: 32 x (wqkv, wo, w13, w2), "
              "fast, g 256, bf16"),
        fused,
        paged,
        big,
        chunk,
        *tool_entries(tool_rows, launches_by_path["tools"]),
    ]}


def main() -> int:
    global CARD
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from kuiperllama_tpu_torch.ops.kernels import build
    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd
    from kuiperllama_tpu_torch.ops.kernels import fused_decode_big as fb
    from kuiperllama_tpu_torch.ops.kernels import paged_attention as pa
    from kuiperllama_tpu_torch.ops.kernels import quant_matmul as qm
    from kuiperllama_tpu_torch.tools import exp_int8 as ei
    from kuiperllama_tpu_torch.tools import exp_kernel as ek
    from kuiperllama_tpu_torch.utils.profiling import nvidia_smi_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    CARD = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit(dict(phase="device", kind=kind, count=torch.cuda.device_count(),
              nvidia_smi=CARD, torch=torch.__version__, cuda=torch.version.cuda))

    t0 = time.perf_counter()
    built = build.build([qm.GEMV_SOURCE, qm.GEMM_SOURCE, fd.SOURCE, pa.SOURCE,
                         fb.SOURCE, fd.CHUNK_SOURCE, ek.SOURCE, ei.SOURCE])
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              per_source_s=built, flags=" ".join(build.NVCC_FLAGS)))

    tool_rows, tool_launches = phase_tools(dev)
    gemv, gemm = phase_kernels(dev)
    fused_rows = phase_fused_kernel(dev)
    big_rows = phase_fused_big_kernel(dev)
    chunk_rows = phase_fused_chunk_kernel(dev)
    paged_rows = phase_paged_kernel(dev)
    phase_fixture(dev)
    fixture_cfg, fixture_params, fixture_tokens = phase_engine_fixture(dev)
    launches = {"tools": tool_launches, "llama2-7b": phase_main_path(dev)}
    launches["llama2-7b big"], big_step = phase_big_main_path(dev)
    launches["tinyllama-1.1b"], fused_step, tl_row = phase_fused_main_path(
        dev, "tinyllama-1.1b", "tinyllama-1.1b", True)
    launches["qwen2.5-0.5b"], qwen_step, qw_row = phase_fused_main_path(
        dev, "qwen2.5-0.5b", "qwen2.5-0.5b", False)
    launches["tinyllama-1.1b chunk"], chunk_step = phase_chunk_main_path(
        dev, "tinyllama-1.1b", "tinyllama-1.1b", True, tl_row)
    launches["qwen2.5-0.5b chunk"], qwen_chunk_step = phase_chunk_main_path(
        dev, "qwen2.5-0.5b", "qwen2.5-0.5b", False, qw_row)
    launches["engine llama2-7b"], _, _ = phase_engine_main_path(
        dev, "llama2-7b", "llama2-7b")
    launches["engine tinyllama-1.1b"], _, _ = phase_engine_main_path(
        dev, "tinyllama-1.1b", "tinyllama-1.1b", prefill_chunk=256, long_prompt=768)
    phase_server(dev, fixture_cfg, fixture_params, fixture_tokens)
    emit(kernels_line(gemv, gemm, fused_rows + [fused_step, qwen_step],
                      fused_step, paged_rows, launches, big_rows, big_step,
                      chunk_rows + [qwen_chunk_step], chunk_step, tool_rows))
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
