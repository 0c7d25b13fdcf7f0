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
  4. fixture: checkpoints/tinychar/tinychar.q8.bin, 24 greedy tokens on the
     card equal to the same run on the CPU (which uses the plain versions).
  5. main path: Llama-2-7B at full width (INT8 group 256, bf16 scales,
     activations and cache, cache length 1024, random weights from a seed),
     Generator.generate_batch_ids on one 32-token prompt, 128 new tokens,
     greedy. Kernel launch counts are zeroed just before and read just after.
Then one {"kernels": [...]} line, the nvidia-smi line of the card, and the
last line {"ok": true, "device": {...}}.

Tolerances (max-abs error relative to max|plain|; the rounding is the same
on both sides, only the fp32 summation order differs): fast mode 1e-3 and
exact mode 1e-5 with fp32 outputs; a bf16 output is rounded once on each
side and may land one bf16 ulp apart, 2^-7 of max|plain|.
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

    cfg, params = load_bin(os.path.join(HERE, FIXTURE))
    prompt = [1, 20, 33, 45, 60, 7, 90]
    ids = {}
    for where in ("cpu", dev):
        gen = Generator(cfg, fuse_params(to_device(params, device=where)),
                        cache_len=128)
        ids[str(where)] = gen.generate_ids(prompt, max_new_tokens=24)[0]
    torch.cuda.synchronize()
    ok = ids["cpu"] == ids[str(dev)] and len(ids["cpu"]) == 24
    emit(dict(phase="fixture", checkpoint=FIXTURE,
              tokens_gpu=ids[str(dev)], tokens_cpu=ids["cpu"], ok=ok, card=CARD))
    if not ok:
        raise AssertionError("tinychar greedy tokens differ between GPU and CPU")


def phase_main_path(dev):
    import torch

    from kuiperllama_tpu_torch.config import preset_config
    from kuiperllama_tpu_torch.fuse import fuse_params
    from kuiperllama_tpu_torch.models import decoder
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
    rows, prefill_s, decode_s = gen.generate_batch_ids([prompt],
                                                       max_new_tokens=128)
    launches = {"quant_gemv": qm.quant_gemv.launches,
                "quant_gemm": qm.quant_gemm.launches}
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
          and all(launches[k] > 0 for k in launches) and launches == expect)
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


def profile_decode(cfg, params, gen, prompt, dev, steps=16):
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
                               steps, active_len=256, rope=gen.rope)
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
    emit(dict(phase="decode_profile", steps=steps,
              wall_ms_per_step_profiled=wall_ms / steps,
              device_busy_ms_per_step=busy_ms / steps if by_name else "not measured",
              device_idle_share=1 - busy_ms / wall_ms if by_name else "not measured",
              kernels_per_step=sum(n for _, n in by_name.values()) / steps,
              top_kernels=[dict(name=k[:80], ms_per_step=ms / steps,
                                launches_per_step=n / steps)
                           for k, (ms, n) in top],
              card=CARD))


def _sum(rows, key):
    return sum(r[key] * n for r, n in rows)


def kernels_line(gemv, gemm, launches):
    def entry(name, rows, replaces, per):
        by_bytes = _sum(rows, "bound_bytes_ms") >= _sum(rows, "bound_ops_ms")
        return dict(
            name=name, route="cuda",
            source=f"kuiperllama_tpu_torch/csrc/{name}.cu",
            replaces=replaces, launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r, _ in rows),
            ms=_sum(rows, "ms"), plain_ms=_sum(rows, "plain_ms"),
            bound_ms=_sum(rows, "bound_ms"),
            bound_by="bytes" if by_bytes else "operations",
            library_ms=_sum(rows, "library_ms"), per=per, card=CARD)

    return {"kernels": [
        entry("quant_gemv", gemv, "kuiperllama_tpu/ops/pallas/quant_matmul.py:202",
              "one Llama-2-7B decode token: 32 x (wqkv, wo, w13, w2) + lm_head, "
              "g 256, bf16"),
        entry("quant_gemm", gemm, "kuiperllama_tpu/ops/pallas/quant_matmul.py:132",
              "one Llama-2-7B prefill of 32 tokens: 32 x (wqkv, wo, w13, w2), "
              "fast, g 256, bf16"),
    ]}


def main() -> int:
    global CARD
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from kuiperllama_tpu_torch.ops.kernels import build
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
    built = build.build([qm.GEMV_SOURCE, qm.GEMM_SOURCE])
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              per_source_s=built, flags=" ".join(build.NVCC_FLAGS)))

    gemv, gemm = phase_kernels(dev)
    phase_fixture(dev)
    launches = phase_main_path(dev)
    emit(kernels_line(gemv, gemm, launches))
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
