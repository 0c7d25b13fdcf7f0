#!/usr/bin/env python
"""Perplexity / quantization-quality gate, a port of tools/ppl.py.

    python -m kuiperllama_tpu_torch.tools.ppl --model m.bin \
        [--quant-model m.q8.bin] [--tokenizer tok] [--text file.txt] \
        [--window 256] [--device cuda|cpu]

With both --model (v0 fp32) and --quant-model (v3), prints the delta-ppl
report as JSON and exits 1 when the |delta ppl| <= 0.1 gate fails. Both
models are evaluated in fp32 on `--device` (default cuda: the INT8
projections of a window below 256 tokens run the GEMM kernel; cpu runs its
plain version).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import add_device_arg, resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", required=True)
    ap.add_argument("--quant-model")
    ap.add_argument("--family", default="llama2")
    ap.add_argument("--tokenizer")
    ap.add_argument("--text", help="text file to evaluate (default: a seeded "
                                   "random token stream)")
    ap.add_argument("--window", type=int, default=256)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from ..checkpoint.binfmt import load_bin
    from ..evaluate import perplexity, quantization_ppl_delta
    from ..params import to_device
    from ..tokenizer import load_tokenizer

    cfg, params = load_bin(args.model, family=args.family)
    params = to_device(params, device=dev, dtype=torch.float32)

    if args.tokenizer and args.text:
        tok = load_tokenizer(args.tokenizer, family=cfg.family,
                             vocab_size=cfg.vocab_size)
        with open(args.text) as f:
            stream = tok.encode(f.read())
    else:
        # meaningful for the delta only: a real gate needs real text and
        # trained weights (the committed checkpoints/tinychar* fixtures and
        # tools/gate_group.py)
        print("[ppl] WARNING: no --tokenizer/--text given: evaluating a "
              "RANDOM token stream. Absolute ppl is meaningless and the "
              "delta gate is a weak discriminator.", file=sys.stderr)
        rng = np.random.default_rng(0)
        stream = rng.integers(0, cfg.vocab_size,
                              size=8 * args.window).astype(np.int32)

    if args.quant_model:
        cfg_q, params_q = load_bin(args.quant_model, family=args.family,
                                   quantized=True)
        params_q = to_device(params_q, device=dev, dtype=torch.float32)
        report = quantization_ppl_delta(cfg, params, cfg_q, params_q, stream,
                                        window=args.window)
        print(json.dumps(report, indent=2))
        return 0 if report["passes_gate"] else 1
    print(json.dumps({"ppl": perplexity(cfg, params, stream, window=args.window)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
