#!/usr/bin/env python
"""The |delta ppl| <= 0.1 gate at a quant group size, a port of
tools/gate_group.py.

Takes a committed tinychar fp checkpoint and the held-out split of its
corpus (the last 15% of tests/data/tinycorpus.txt, byte-encoded: the
protocol of tools/train_tiny.py), quantizes the seven projections in memory
at --group (or loads a v3 file with --quant-model), and evaluates both
perplexities in windows of the model's seq_len through the port's forward.
On the card every INT8 projection of a window (seq_len rows, below 256)
runs the GEMM kernel (csrc/quant_gemm.cu) in fast mode; on the CPU its plain
version. The report names that route in `kernel_mode`.

    python -m kuiperllama_tpu_torch.tools.gate_group \
        --ckpt checkpoints/tinychar_g256/tinychar.bin --group 256 \
        [--out report.json] [--device cuda|cpu]

The JSON goes to stdout, and to --out only when given. Exits 1 when the
gate fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from . import add_device_arg, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CORPUS = os.path.join(REPO, "tests", "data", "tinycorpus.txt")
HELDOUT_FRACTION = 0.15
PROJECTIONS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def encode_bytes(text: str) -> np.ndarray:
    """Byte ids of `text` capped at 127 (a copy of tools/train_tiny.py's)."""
    ids = np.frombuffer(text.encode("ascii", errors="replace"), np.uint8)
    return np.minimum(ids, 127).astype(np.int32)


def heldout_ids(corpus: str = CORPUS) -> np.ndarray:
    with open(corpus) as f:
        ids = encode_bytes(f.read())
    return ids[int(len(ids) * (1.0 - HELDOUT_FRACTION)):]


def requantize(params_fp, group: int):
    """The fp params with the seven projections of every layer quantized
    at `group` (on the params' device); (params, max |dequant - fp|)."""
    from ..quant import dequantize, quantize_q80

    blocks = dict(params_fp["blocks"])
    max_err = 0.0
    for name in PROJECTIONS:
        w = params_fp["blocks"][name]
        qt = quantize_q80(w, group_size=group)
        max_err = max(max_err, float((dequantize(qt) - w.float()).abs().max()))
        blocks[name] = qt
    return dict(params_fp, blocks=blocks), max_err


def _dequant_err(params_fp, params_q) -> float:
    from ..quant import QuantTensor, dequantize

    pairs = [(params_fp["blocks"][n], params_q["blocks"][n]) for n in PROJECTIONS]
    pairs.append((params_fp["lm_head"], params_q["lm_head"]))
    return max(float((dequantize(q) - w.float()).abs().max())
               for w, q in pairs if isinstance(q, QuantTensor))


def kernel_mode(dev: torch.device) -> str:
    from ..ops.linear import kernels_on

    return "cuda-gemm-fast" if dev.type == "cuda" and kernels_on() else "torch-plain-fast"


def gate(ckpt: str, group=None, quant_model=None, family: str = "llama2",
         device="cuda", corpus: str = CORPUS) -> dict:
    """The gate's report for the fp checkpoint `ckpt` against its INT8
    counterpart: requantized in memory at `group`, or the v3 file
    `quant_model`."""
    from ..checkpoint.binfmt import load_bin
    from ..evaluate import quantization_ppl_delta
    from ..params import to_device

    dev = torch.device(device)
    ids = heldout_ids(corpus)
    cfg, pf = load_bin(ckpt, family=family)
    pf = to_device(pf, device=dev, dtype=torch.float32)
    if quant_model:
        cfg_q, pq = load_bin(quant_model, family=family, quantized=True)
        pq = to_device(pq, device=dev, dtype=torch.float32)
        max_err = _dequant_err(pf, pq)
        quant = (f"v3 group={cfg_q.group_size} int8 "
                 f"({os.path.basename(quant_model)})")
    else:
        if cfg.dim % group or cfg.hidden_dim % group:
            raise ValueError(f"group {group} does not divide the gate model "
                             f"(dim {cfg.dim}, hidden {cfg.hidden_dim})")
        cfg_q = cfg
        pq, max_err = requantize(pf, group)
        quant = f"group={group} int8 (in-memory requant of the committed fp checkpoint)"
    report = quantization_ppl_delta(cfg, pf, cfg_q, pq, ids, window=cfg.seq_len)
    report.update(
        family=family,
        corpus="tests/data/tinycorpus.txt (held-out 15%)",
        heldout_tokens=int(len(ids)),
        window=cfg.seq_len,
        quant=quant,
        kernel_mode=kernel_mode(dev),
        max_abs_dequant_err=round(max_err, 6),
    )
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--group", type=int, default=128)
    ap.add_argument("--ckpt", default="checkpoints/tinychar/tinychar.bin")
    ap.add_argument("--quant-model", help="a v3 file to gate instead of the "
                                          "in-memory requant at --group")
    ap.add_argument("--family", default="llama2")
    ap.add_argument("--corpus", default=CORPUS)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    report = gate(args.ckpt, group=args.group, quant_model=args.quant_model,
                  family=args.family, device=dev, corpus=args.corpus)
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return 0 if report["passes_gate"] else 1


if __name__ == "__main__":
    sys.exit(main())
