#!/usr/bin/env python
"""Probe: what the big-model megakernel's phases cost besides the weights.

Builds variants of csrc/fused_decode_big.cu (and of its header
csrc/fused_decode_common.cuh, written beside the variant so that it comes
first on the include path), each with one piece of the source taken out,
and times them on one decode step at full depth, pos 100 in a 256-slot
window, on random weights from seed 0 (bf16 activations and cache), at the
two GEOMETRIES: Llama-2-7B INT8 g 64 with bf16 scales and g 256 with fp32
scales.
  kernel           the source as it is
  no_group_flush   a k-lane's int32 sums scaled into its accumulators once
                   per run instead of once per group the run touches
  no_norm_staging  qkv and gate/up without the rms norm's sum of squares
                   over the row
  no_quantize      without the activation's per-group int8 quantization
  no_tile_reduce   without the k-lane reduction of a tile (the lanes' sums
                   stay live, unsummed)
  no_split_sum     every K split runs the epilogue on its own partial: no
                   fence, counter or re-read of the other splits
  no_grid_sync     without the grid barriers of a layer and the flag waits
                   that replace the others
  no_qkv_barrier   attention without its wait for the qkv tiles
  no_attn_barrier  wo without its wait for the heads
  no_ffn_barrier   w2 without its wait for the gate/up tiles
  no_attention     without attention's work (its waits and flags stay)
  no_weight_bytes  every weight load replaced by a value made in registers
                   from its address: no weight byte leaves HBM
Each variant but `kernel` computes a wrong step on purpose; what it shows
is time: an upper bound on what removing that piece could save. Times are
the median of 25 launches (CUDA events, `utils.profiling.device_time`),
with one traced launch's us per phase per layer (`fused_decode.phase_times`),
the launch's plan and the build's registers and spill bytes (`-Xptxas -v`).
Prints one JSON line per (geometry, variant), then the card's nvidia-smi
line. Needs the card: there is no plain version of a broken kernel.

`--compare DIR` instead times the kernel of another checkout of the repo
(a `git archive` of the parent) and of this tree in turns, DIR, this,
this, DIR, each in a child process that imports its own tree's package:
one step at each `BIG_CASES` geometry at full depth and the big route's
ms/token (`COMPARE_CHILD`).

    python -m kuiperllama_tpu_torch.tools.big_phase_costs [--layers 32]
        [--geometries ...] [--variants kernel,...] [--compare DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

from ..ops.kernels import build
from ..ops.kernels import fused_decode as fd
from ..ops.kernels import fused_decode_big as fb
from ..ops.kernels import workspace
from ..utils.profiling import device_time, nvidia_smi_line

BIG_CU = f"{fb.SOURCE}.cu"
HEADER = "fused_decode_common.cuh"
FILES = (BIG_CU, HEADER)
# (preset, group size, bf16 scales)
GEOMETRIES = {"llama2-7b g64": ("llama2-7b", 64, True),
              "llama2-7b g256 fp32 scales": ("llama2-7b", 256, False)}
POS, WINDOW = 100, 256

QKV_WAIT = "          wait_flag(flag_at(a, kTileFlags + t), layer + 1);\n"
HEAD_WAIT = "            wait_flag(flag_at(a, kHeadFlags + h), layer + 1);\n"
FFN_WAIT = "            wait_flag(flag_at(a, kFfnFlags + t), layer + 1);\n"
NO_WAIT = "          ;  // no wait\n"  # the empty body of the loop over the flags


# What each variant replaces, as (file, old text, new text, occurrences).
SUBSTITUTIONS = {
    "no_group_flush": [
        (BIG_CU, "        if (c + b == edge) {\n          flush_group(ip, sc, dg[grp], acc);\n"
                 "          ++grp;\n          edge += qpg;\n"
                 "          load_scales16(s, s_bf16, (size_t)grp * N + col0, sc);\n        }\n",
         "", 1)],
    "no_norm_staging": [(BIG_CU, "  if (normed && rn < 0.f) {\n", "  if (false) {\n", 1)],
    "no_quantize": [(BIG_CU, "    if (shuffled) {\n", "    if (false) {\n", 1)],
    "no_tile_reduce": [
        (BIG_CU, "      tile_reduce<16>(acc, ct, sm, sm.out + h * W);\n",
         "      { float t = 0.f; for (int j = 0; j < 16; ++j) t += acc[j]; "
         "if (t == 1234.5f) sm.out[0] = t; }\n", 1)],
    # every split then raises its tile's flag: a wait never outlasts its producers
    "no_split_sum": [
        (BIG_CU, "  if (splits == 1) {\n    if (tid < W && col < ncols)\n      epilogue_big(",
         "  if (true) {\n    if (tid < W && col < ncols)\n      epilogue_big(", 1)],
    # the flag waits go too: without barriers the split counters of phases
    # mix, and a wait could outlast every producer
    "no_grid_sync": [(BIG_CU, "    grid_sync();\n", "", 2), (BIG_CU, QKV_WAIT, NO_WAIT, 1),
                     (BIG_CU, HEAD_WAIT, NO_WAIT, 1), (BIG_CU, FFN_WAIT, NO_WAIT, 1)],
    "no_qkv_barrier": [(BIG_CU, QKV_WAIT, NO_WAIT, 1)],
    "no_attn_barrier": [(BIG_CU, HEAD_WAIT, NO_WAIT, 1)],
    "no_ffn_barrier": [(BIG_CU, FFN_WAIT, NO_WAIT, 1)],
    # the heads still wait for their tiles and raise their flags
    "no_attention": [
        (BIG_CU, "    if (a.cache_bf16)\n      attention_head<__nv_bfloat16>(",
         "    if (false)\n      attention_head<__nv_bfloat16>(", 1),
        (BIG_CU, "    else\n      attention_head<float>(", "    else if (false)\n      attention_head<float>(", 1)],
    "no_weight_bytes": [
        (BIG_CU, "return __ldg(reinterpret_cast<const int4*>(p));",
         "return make_int4(static_cast<int>(reinterpret_cast<size_t>(p)), 0, 0, 0);", 1)],
}
VARIANTS = ("kernel", *SUBSTITUTIONS)


def sources() -> dict:
    """{file name: text} of the big kernel's source and its header."""
    return {f: Path(build.CSRC, f).read_text() for f in FILES}


def substitutions(name: str, src: dict) -> list:
    """The substitutions of variant `name`; raises when a piece it replaces
    no longer occurs exactly as often as it says."""
    if name == "kernel":
        return []
    subs = SUBSTITUTIONS[name]
    for f, old, _, n in subs:
        if src[f].count(old) != n:
            raise ValueError(f"big_phase_costs: variant {name} does not apply to "
                             f"csrc/{f}")
    return subs


def variant_files(name: str, src: dict) -> dict:
    """The variant's source and header (written beside each other, so that
    the source includes this header, not csrc/'s)."""
    out = dict(src)
    for f, old, new, _ in substitutions(name, src):
        out[f] = out[f].replace(old, new)
    return out


def build_variants(jobs: dict) -> dict:
    """nvcc every job at once, one process each, with the kernels' flags and
    `-Xptxas -v`. jobs: {tag: (source, files)}, where `files` maps file
    names to texts: `<source>.cu` and any header variant, written to a
    directory of the tag's own under the build directory. A quoted include
    finds a header there first, else in csrc/. Returns {tag: (the loaded
    library, ptxas's report: the most registers of any kernel and the spill
    bytes of all of them)}."""
    procs = {}
    for tag, (source, files) in jobs.items():
        d = build.BUILD_DIR / "variants" / tag
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in files.items():
            (d / fname).write_text(text)
        lib = d / f"lib{source}.so"
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(build.CSRC),
               "-o", str(lib), str(d / f"{source}.cu")]
        procs[tag] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), lib)
    out, errors = {}, []
    for tag, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            errors.append(f"nvcc failed for variant {tag}:\n{log}")
            continue
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", log))
        out[tag] = (ctypes.CDLL(str(lib)), dict(max_registers=max(regs, default=0),
                                                spill_bytes=spills))
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def _model(dev, preset, g, s_bf16, layers):
    from ..config import preset_config
    from ..fuse import fuse_params
    from ..params import random_params_device
    from ..quant import cast_scales

    over = dict(seq_len=1024)
    if layers:
        over["n_layers"] = layers
    cfg = preset_config(preset, **over)
    params = random_params_device(cfg, device=dev, seed=0, quantize=True, group_size=g)
    if s_bf16:
        params = cast_scales(params, torch.bfloat16)
    return cfg, fuse_params(params)


def run(dev, geometries, variants, layers=None) -> list:
    from ..models import decoder

    src = sources()
    jobs = {f"big_{n}": (fb.SOURCE, {f: t for f, t in variant_files(n, src).items()})
            for n in variants}
    built = build_variants(jobs)
    saved = dict(build._libs)
    rows = []
    try:
        for label in geometries:
            preset, g, s_bf16 = GEOMETRIES[label]
            cfg, params = _model(dev, preset, g, s_bf16, layers)
            L = cfg.n_layers
            gen = torch.Generator(device=dev).manual_seed(1)
            kc = torch.randn((L, WINDOW, cfg.kv_dim), generator=gen, device=dev).to(torch.bfloat16)
            vc = torch.randn((L, WINDOW, cfg.kv_dim), generator=gen, device=dev).to(torch.bfloat16)
            p = torch.tensor([POS], dtype=torch.int32, device=dev)
            sin, cos = decoder.build_rope(cfg, dev)
            x0 = params["tok_emb"][torch.tensor([5], device=dev)]
            for name in variants:
                lib, ptxas = built[f"big_{name}"]
                build._libs[fb.SOURCE] = lib
                fd._occupancy.clear()
                # a variant without barriers can leave split counters set
                workspace.invalidate()

                def step(v, trace=None):
                    return fb.fused_decode_step_big(cfg, v, x0, kc, vc, p, sin, cos,
                                                    int8_a=True, trace=trace)

                ms = device_time(step, params, device="cuda") * 1e3
                trace = torch.zeros(2 + 5 * L, dtype=torch.int64, device=dev)
                step(params, trace=trace)
                phases = fd.phase_times(trace, L)
                rows.append(dict(tool="big_phase_costs", variant=name, model=label,
                                 layers=L, pos=POS, window=WINDOW, ms_per_step=ms,
                                 traced_us_per_layer={k: phases[k] / L for k in fd.PHASES},
                                 plan=fb.fused_decode_step_big.plan, ptxas=ptxas))
                print(json.dumps(rows[-1]), flush=True)
            del params, kc, vc
            torch.cuda.empty_cache()
    finally:
        build._libs.clear()
        build._libs.update(saved)
        fd._occupancy.clear()
    return rows


# Run by `--compare` in a child process whose working directory and import
# path are one checkout of the repo: it imports that checkout's package,
# through names the package has long had, and prints one JSON line per
# BIG_CASES geometry (one step at full depth: CUDA-event median of 25
# launches on two copies of the weights, one traced launch's us per phase
# per layer) and one for the big route (Llama-2-7B g 64, a 32-token prompt,
# 128 greedy tokens with the big route switched on, ms per decode step).
COMPARE_CHILD = r'''
import json, sys, torch
from kuiperllama_tpu_torch.config import preset_config
from kuiperllama_tpu_torch.fuse import fuse_params
from kuiperllama_tpu_torch.models import decoder
from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd
from kuiperllama_tpu_torch.ops.kernels import fused_decode_big as fb
from kuiperllama_tpu_torch.params import random_params_device
from kuiperllama_tpu_torch.quant import QuantTensor, cast_scales
from kuiperllama_tpu_torch.utils.profiling import device_time
tree, dev = sys.argv[1], torch.device("cuda", 0)
def model(preset, g, s_bf16):
    cfg = preset_config(preset, seq_len=1024)
    prm = random_params_device(cfg, device=dev, seed=0, quantize=True, group_size=g)
    return cfg, fuse_params(cast_scales(prm, torch.bfloat16) if s_bf16 else prm)
def clone(prm):
    c = lambda x: QuantTensor(x.q.clone(), x.s.clone(), x.group_size) if isinstance(x, QuantTensor) else x.clone()
    return dict(prm, blocks={k: c(v) for k, v in prm["blocks"].items()})
for label, preset, g, s_bf16 in (("llama2-7b g64", "llama2-7b", 64, True),
                                 ("llama2-7b g256 fp32 scales", "llama2-7b", 256, False),
                                 ("llama3-8b g64", "llama3-8b", 64, True)):
    cfg, prm = model(preset, g, s_bf16)
    L = cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(1)
    kc = torch.randn((L, 256, cfg.kv_dim), generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn((L, 256, cfg.kv_dim), generator=gen, device=dev).to(torch.bfloat16)
    p = torch.tensor([100], dtype=torch.int32, device=dev)
    sin, cos = decoder.build_rope(cfg, dev)
    x0 = prm["tok_emb"][torch.tensor([5], device=dev)]
    step = lambda v, trace=None: fb.fused_decode_step_big(cfg, v, x0, kc, vc, p, sin, cos, int8_a=True, trace=trace)
    ms = device_time(step, variants=[(prm,), (clone(prm),)], device="cuda") * 1e3
    trace = torch.zeros(2 + 5 * L, dtype=torch.int64, device=dev)
    step(prm, trace=trace)
    ph = fd.phase_times(trace, L)
    print(json.dumps(dict(tool="big_phase_costs", compare=tree, model=label, layers=L,
                          ms_per_step=ms, traced_us_per_layer={k: ph[k] / L for k in fd.PHASES})), flush=True)
    if label == "llama2-7b g64":
        from kuiperllama_tpu_torch.ops import tuning
        from kuiperllama_tpu_torch.serving.generate import Generator
        route, tuning.fused_big_on = tuning.fused_big_on, lambda: True
        gen = Generator(cfg, prm, cache_len=1024, cache_dtype=torch.bfloat16, chunk=128)
        prompt = list(range(5, 37))
        gen.generate_batch_ids([prompt], 128)
        n0 = fb.fused_decode_step_big.launches
        rows, _, decode_s = gen.generate_batch_ids([prompt], 128)
        tuning.fused_big_on = route
        print(json.dumps(dict(tool="big_phase_costs", compare=tree, model=label + " big route",
                              decode_ms_per_token=decode_s / (len(rows[0]) - 1) * 1e3,
                              big_launches=fb.fused_decode_step_big.launches - n0,
                              tokens=rows[0][:8])), flush=True)
        del gen
    del prm, kc, vc
    torch.cuda.empty_cache()
'''


def compare(other: str) -> int:
    """COMPARE_CHILD in `other`, this tree, this tree, `other`."""
    here = str(Path(__file__).resolve().parents[2])
    for tree in (other, here, here, other):
        tree = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=tree)
        rc = subprocess.run([sys.executable, "-c", COMPARE_CHILD, tree], cwd=tree,
                            env=env).returncode
        if rc != 0:
            return rc
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=None,
                    help="layers of each model (default: full depth)")
    ap.add_argument("--geometries", default=",".join(GEOMETRIES))
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--compare", default=None,
                    help="time another checkout's kernel and this one's in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("big_phase_costs: needs a CUDA device (it times "
                         "variants of a CUDA kernel)")
    if args.compare:
        rc = compare(args.compare)
    else:
        dev = torch.device("cuda", torch.cuda.current_device())
        run(dev, args.geometries.split(","), args.variants.split(","), args.layers)
        rc = 0
    print(nvidia_smi_line(), flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
