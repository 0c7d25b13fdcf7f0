#!/usr/bin/env python
"""Probe: what the small-model decode megakernels' phases cost besides the
weights.

Builds variants of csrc/fused_decode.cu and csrc/fused_decode_chunk.cu (and
of their shared header csrc/fused_decode_common.cuh, written beside the
variant so that it comes first on the include path), each with one piece
of the source replaced, and times them at full width and depth on random
weights from seed 0: TinyLlama-1.1B INT8 g 256 with bf16 scales and
Qwen2.5-0.5B bf16, pos 100 in a 256-slot window, bf16 activations and
cache; the per-step kernel for one step, the chunk kernel for `--steps`
greedy steps (ms per step):
  kernel            the sources as they are
  no_weight_bytes   every weight and scale load replaced by a value made
                    from its address: no weight byte leaves HBM
  no_barrier_<p>    without the wait that follows phase p (qkv, attention,
                    wo, gate_up, w2): its consumers do not wait for it
  no_split_sum      every K split runs the epilogue on its own partial: no
                    fence, counter or re-read of the other splits
  no_norm_staging   without the rmsnorm staging of the activation
  no_attention      without attention's work (what it signals stays)
Each variant but `kernel` computes a wrong step on purpose; what it shows is
time: an upper bound on what removing that piece of fixed work could save.
The chunk variants clamp the token they read back into the vocabulary, so a
wrong step stays in bounds.

Times are the median of 25 launches (CUDA events,
`utils.profiling.device_time`); per-step rows add one traced launch's us per
phase per layer (`fused_decode.phase_times`). Every row names the grid,
the blocks per SM, each phase's plan and the build's registers and spill
bytes (`-Xptxas -v`). Prints one JSON line per (kernel, model, variant),
then the card's nvidia-smi line. Needs the card.

`--csrc DIR` times another directory's sources (an earlier commit's
csrc/, whose kernels take the same arguments) through this tree's wrappers.

    python -m kuiperllama_tpu_torch.tools.fused_phase_costs [--steps 16]
        [--models tinyllama-1.1b,qwen2.5-0.5b] [--variants kernel,...]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..ops.kernels import build
from ..ops.kernels import fused_decode as fd
from ..utils.profiling import device_time, nvidia_smi_line
from .big_phase_costs import build_variants

STEP_CU = f"{fd.SOURCE}.cu"
CHUNK_CU = f"{fd.CHUNK_SOURCE}.cu"
HEADER = "fused_decode_common.cuh"
FILES = (STEP_CU, CHUNK_CU, HEADER)
MODELS = {"tinyllama-1.1b": (True, 256), "qwen2.5-0.5b": (False, 0)}
POS, WINDOW, CACHE_LEN = 100, 256, 1024
PHASES = ("qkv", "attention", "wo", "gate_up", "w2")

# A value made from a load's address: every byte below 0x40, so that int8
# weights, bf16 weights and bf16 scales read from it stay finite.
FAKE16 = """
__device__ __forceinline__ int4 fake16(const void* p) {
  const unsigned v = static_cast<unsigned>(reinterpret_cast<size_t>(p) >> 4) * 0x9E3779B1u;
  const int w = static_cast<int>(v & 0x3f3f3f3fu);
  return make_int4(w, w ^ 0x01010101, w ^ 0x02020202, w ^ 0x03030303);
}
"""

# the chunk kernel's token clamped into [0, vocab), so that a wrong step
# reads an embedding row that exists
CLAMP_TOKEN = (CHUNK_CU, "    const int tok = reduce_token(c, sm);\n",
               "    const int tok = min(max(reduce_token(c, sm), 0), c.vocab - 1);\n", 1)


def _drop(file, text, indent):
    """A substitution that removes the line `grid_sync();` after `text`."""
    old = f"{indent}{text}\n{indent}grid_sync();\n"
    return (file, old, f"{indent}{text}\n", 1)


# What each variant replaces in the kernels: a grid barrier after every
# phase, the whole activation staged and normed by every block, the last
# split of a tile summing the others behind a counter.
_BARRIER_CALLS = {
    "qkv": "gemv_phase<KIND>(a, P_QKV, l, {}, sm);",
    "attention": "attention_phase(a, l, pos, {}, smem, sm);",
    "wo": "gemv_phase<KIND>(a, P_WO, l, {}, sm);",
    "gate_up": "gemv_phase<KIND>(a, P_W13, l, {}, sm);",
    "w2": "gemv_phase<KIND>(a, P_W2, l, {}, sm);",
}
_STEP_ARG = {"attention": "pos"}
_CHUNK_ARG = {"attention": "pos0"}
SUBSTITUTIONS = {
    "no_weight_bytes": [
        (HEADER, "constexpr int kThreads = 256;\n", "constexpr int kThreads = 256;\n" + FAKE16, 1),
        (HEADER, "r[i] = __ldg(reinterpret_cast<const int4*>(q + (size_t)(row + i) * N + col0));",
         "r[i] = fake16(q + (size_t)(row + i) * N + col0);", 1),
        (HEADER, "const int4 v = __ldg(reinterpret_cast<const int4*>(q + (size_t)(kb + k) * N + col0));",
         "const int4 v = fake16(q + (size_t)(kb + k) * N + col0);", 1),
        (HEADER, "const int4 v = __ldg(reinterpret_cast<const int4*>(wp + (size_t)row * N + col0));",
         "const int4 v = fake16(wp + (size_t)row * N + col0);", 1),
        (HEADER, "const int4 v = __ldg(p + h);", "const int4 v = fake16(p + h);", 1),
    ],
    **{f"no_barrier_{p}": [
        _drop(STEP_CU, call.format(_STEP_ARG.get(p, "l == 0")), "    "),
        _drop(CHUNK_CU, call.format(_CHUNK_ARG.get(p, "first")), "      "),
    ] for p, call in _BARRIER_CALLS.items()},
    "no_split_sum": [
        (HEADER, "  if (splits == 1) {\n    if (tid < W && col < ncols)\n",
         "  if (true) {\n    if (tid < W && col < ncols)\n", 1),
        (CHUNK_CU, "    bool finish = splits == 1;\n", "    bool finish = true;\n", 1),
    ],
    "no_norm_staging": [
        (HEADER, "                           float* hs, float* scratch) {\n  float ss;\n",
         "                           float* hs, float* scratch) {\n  return;\n  float ss;\n", 1),
    ],
    "no_attention": [
        (HEADER, "  for (int h = blockIdx.x; h < a.H; h += gridDim.x) {\n",
         "  for (int h = blockIdx.x; h < 0; h += gridDim.x) {\n", 1),
    ],
}

VARIANTS = ("kernel", *SUBSTITUTIONS)


def sources(csrc=None) -> dict:
    """{file name: text} of the two kernels' sources and their header, from
    csrc/ or another directory of sources (an earlier commit's)."""
    return {f: Path(csrc or build.CSRC, f).read_text() for f in FILES}


def substitutions(name: str, src: dict) -> list:
    """The substitutions of variant `name`; raises when a piece it replaces
    no longer occurs exactly as often as it says."""
    if name == "kernel":
        return []
    subs = SUBSTITUTIONS[name] + [CLAMP_TOKEN]
    for f, old, _, n in subs:
        if src[f].count(old) != n:
            raise ValueError(f"fused_phase_costs: variant {name} does not apply to "
                             f"csrc/{f}")
    return subs


def variant_files(name: str, src: dict) -> dict:
    """The variant's two sources and header (written beside each other, so
    that the sources include this header, not csrc/'s)."""
    out = dict(src)
    for f, old, new, _ in substitutions(name, src):
        out[f] = out[f].replace(old, new)
    return out


def _model(dev, preset, quantize, g):
    from ..config import preset_config
    from ..fuse import fuse_params
    from ..params import random_params_device
    from ..quant import cast_scales

    cfg = preset_config(preset, seq_len=CACHE_LEN)
    params = random_params_device(cfg, device=dev, seed=0, quantize=quantize,
                                  group_size=g or 64)
    if quantize:
        params = cast_scales(params, torch.bfloat16)
    return cfg, fuse_params(params)


def run(dev, models, variants, steps: int, csrc=None) -> list:
    from ..models import decoder

    src = sources(csrc)
    jobs = {}
    for name in variants:
        files = variant_files(name, src)
        for source in (fd.SOURCE, fd.CHUNK_SOURCE):
            other = CHUNK_CU if source == fd.SOURCE else STEP_CU
            jobs[f"fused_{name}_{source}"] = (source, {f: t for f, t in files.items()
                                                       if f != other})
    built = build_variants(jobs)
    saved = dict(build._libs)
    rows = []
    try:
        for preset in models:
            quantize, g = MODELS[preset]
            cfg, params = _model(dev, preset, quantize, g)
            gen = torch.Generator(device=dev).manual_seed(1)
            L, KV = cfg.n_layers, cfg.kv_dim
            kc = torch.randn((L, CACHE_LEN, KV), generator=gen, device=dev).to(torch.bfloat16)
            vc = torch.randn((L, CACHE_LEN, KV), generator=gen, device=dev).to(torch.bfloat16)
            kw, vw = kc[:, :WINDOW], vc[:, :WINDOW]
            p = torch.tensor([POS], dtype=torch.int32, device=dev)
            sin, cos = decoder.build_rope(cfg, dev)
            x0 = params["tok_emb"][torch.tensor([5], device=dev)]
            for name in variants:
                lib_step, ptx_step = built[f"fused_{name}_{fd.SOURCE}"]
                lib_chunk, ptx_chunk = built[f"fused_{name}_{fd.CHUNK_SOURCE}"]
                build._libs[fd.SOURCE], build._libs[fd.CHUNK_SOURCE] = lib_step, lib_chunk
                fd._occupancy.clear()
                common = dict(tool="fused_phase_costs", variant=name, model=preset,
                              layers=L, pos=POS, window=WINDOW, csrc=str(csrc or build.CSRC))

                ms = device_time(lambda v: fd.fused_decode_step(cfg, v, x0, kw, vw, p, sin, cos),
                                 params, device="cuda") * 1e3
                trace = torch.zeros(2 + 5 * L, dtype=torch.int64, device=dev)
                fd.fused_decode_step(cfg, params, x0, kw, vw, p, sin, cos, trace=trace)
                phases = fd.phase_times(trace, L)
                rows.append(dict(common, kernel="fused_decode", ms_per_step=ms,
                                 traced_us_per_layer={k: phases[k] / L for k in PHASES},
                                 **fd.fused_decode_step.plan, ptxas=ptx_step))
                ms = device_time(lambda v: fd.fused_decode_chunk(cfg, v, x0, kw, vw, p, sin,
                                                                 cos, steps),
                                 params, device="cuda") * 1e3 / steps
                rows.append(dict(common, kernel="fused_decode_chunk", steps=steps,
                                 ms_per_step=ms, **fd.fused_decode_chunk.plan,
                                 ptxas=ptx_chunk))
                print(json.dumps(rows[-2]), flush=True)
                print(json.dumps(rows[-1]), flush=True)
            del params, kc, vc
    finally:
        build._libs.clear()
        build._libs.update(saved)
        fd._occupancy.clear()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--models", default=",".join(MODELS))
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--csrc", default=None,
                    help="time the kernel sources of this directory (an earlier "
                         "commit's csrc/) through this tree's wrappers")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fused_phase_costs: needs a CUDA device (it times "
                         "variants of CUDA kernels)")
    dev = torch.device("cuda", torch.cuda.current_device())
    run(dev, args.models.split(","), args.variants.split(","), args.steps, args.csrc)
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
