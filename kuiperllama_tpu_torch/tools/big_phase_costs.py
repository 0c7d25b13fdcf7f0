#!/usr/bin/env python
"""Probe: what the big-model megakernel's phases cost besides the weights.

Builds variants of csrc/fused_decode_big.cu, each with one piece of its
source replaced, and times them on one decode step of random Llama-2-7B
INT8 g 64 weights (bf16 scales, activations and cache) at full depth, pos
100 in a 256-slot window:
  kernel           the source as it is
  no_qkv_barrier   without the grid barrier between qkv and attention
  no_attn_barrier  without the grid barrier between attention and wo
  no_weight_bytes  every weight load replaced by a value made in registers
                   from its address: no weight byte leaves HBM
Each variant but `kernel` computes a wrong step on purpose; what it shows
is time: a barrier's cost (an upper bound on what finer-grained waits
could save) and the time the phases take without their weight stream.
Times are the median of 25 launches (CUDA events,
`utils.profiling.device_time`), with one traced launch's us per phase per
layer (`fused_decode.phase_times`). Prints one JSON line per variant, then
the card's nvidia-smi line. Needs the card: there is no plain version of a
broken kernel.

    python -m kuiperllama_tpu_torch.tools.big_phase_costs [--layers 32]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess

import torch

from ..ops.kernels import build
from ..ops.kernels import fused_decode as fd
from ..ops.kernels import fused_decode_big as fb
from ..utils.profiling import device_time, nvidia_smi_line

QKV_BARRIER = """    gemv_phase_big<INT8A>(a, P_QKV, l, sm);
    grid_sync();"""
ATTN_BARRIER = """    attention_phase(a, l, pos, pos, smem, sm);
    grid_sync();"""
WEIGHT_LOAD = "return __ldg(reinterpret_cast<const int4*>(p));"

VARIANTS = {
    "kernel": None,
    "no_qkv_barrier": (QKV_BARRIER, QKV_BARRIER.split("\n")[0]),
    "no_attn_barrier": (ATTN_BARRIER, ATTN_BARRIER.split("\n")[0]),
    "no_weight_bytes": (WEIGHT_LOAD,
                        "return make_int4(static_cast<int>(reinterpret_cast<size_t>(p)), 0, 0, 0);"),
}


def variant_source(name: str) -> str:
    """The source of variant `name`; raises when the piece it replaces is
    no longer in csrc/fused_decode_big.cu exactly once."""
    src = (build.CSRC / f"{fb.SOURCE}.cu").read_text()
    if VARIANTS[name] is None:
        return src
    old, new = VARIANTS[name]
    if src.count(old) != 1:
        raise ValueError(f"big_phase_costs: variant {name} does not apply to "
                         f"csrc/{fb.SOURCE}.cu")
    return src.replace(old, new)


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


def build_variant(name: str) -> ctypes.CDLL:
    """nvcc the big kernel's variant `name` into the build directory."""
    files = {f"{fb.SOURCE}.cu": variant_source(name)}
    return build_variants({f"big_{name}": (fb.SOURCE, files)})[f"big_{name}"][0]


def run(dev, layers: int) -> list:
    from ..config import preset_config
    from ..fuse import fuse_params
    from ..models import decoder
    from ..params import random_params_device
    from ..quant import cast_scales

    cfg = preset_config("llama2-7b", n_layers=layers, seq_len=1024)
    params = cast_scales(fuse_params(random_params_device(
        cfg, device=dev, seed=0, quantize=True, group_size=64)), torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(1)
    A, pos = 256, 100
    kc = torch.randn((layers, A, cfg.kv_dim), generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn((layers, A, cfg.kv_dim), generator=gen, device=dev).to(torch.bfloat16)
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    sin, cos = decoder.build_rope(cfg, dev)
    x0 = params["tok_emb"][torch.tensor([5], device=dev)]
    rows = []
    for name in VARIANTS:
        lib = build_variant(name)
        launch = lib.fused_decode_big
        launch.argtypes = [ctypes.POINTER(fd._Args), ctypes.c_void_p]
        occ = lib.fused_decode_big_blocks_per_sm
        occ.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]

        def blocks(kind, smem, occ=occ):
            n = ctypes.c_int(0)
            if occ(1, smem, ctypes.byref(n)) != 0:
                raise RuntimeError("big_phase_costs: occupancy query failed")
            return n.value

        def step(v, trace=None, launch=launch, blocks=blocks):
            a, x_out, keep = fd.step_args("big_phase_costs", cfg, v, x0, kc, vc, p,
                                          sin, cos, (True,) * 4, blocks, trace=trace)
            rc = launch(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"big_phase_costs: launch failed, CUDA error {rc}")
            return x_out

        ms = device_time(step, variants=[(params,)], device="cuda") * 1e3
        trace = torch.zeros(2 + 5 * layers, dtype=torch.int64, device=dev)
        step(params, trace=trace)
        phases = fd.phase_times(trace, layers)
        rows.append(dict(tool="big_phase_costs", variant=name, layers=layers,
                         ms_per_step=ms, traced_us_per_layer={
                             k: phases[k] / layers for k in fd.PHASES}))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("big_phase_costs: needs a CUDA device (it times "
                         "variants of a CUDA kernel)")
    dev = torch.device("cuda", torch.cuda.current_device())
    for row in run(dev, args.layers):
        print(json.dumps(row), flush=True)
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
