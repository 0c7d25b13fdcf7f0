#!/usr/bin/env python
"""Checkpoint exporter, a port of tools/export.py.

Converts an HF model directory (config.json + safetensors, read by the
port's own parser in checkpoint/hf.py) into the llama2.c-style `.bin`
formats:
  --version 0  v0 fp32
  --version 3  v3 group-wise INT8 (Q8_0, default group 64)

    python -m kuiperllama_tpu_torch.tools.export out.bin --hf DIR [--version 3] [--group 64]
    python -m kuiperllama_tpu_torch.tools.export out.bin --random llama2 [--version 0]

`--random FAMILY` writes a tiny fixture (`tiny_config(FAMILY)`, seed 0).
Runs on the host only: no device is touched.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("filepath")
    ap.add_argument("--hf", help="HF model directory")
    ap.add_argument("--random", help="emit a random tiny fixture for FAMILY")
    ap.add_argument("--version", type=int, default=0, choices=[0, 3])
    ap.add_argument("--group", type=int, default=64)
    args = ap.parse_args(argv)

    from ..checkpoint.binfmt import write_v0, write_v3
    from ..checkpoint.hf import load_hf
    from ..config import tiny_config
    from ..params import random_params

    if args.hf:
        cfg, params = load_hf(args.hf)
    elif args.random:
        cfg = tiny_config(args.random)
        params = random_params(cfg)
    else:
        ap.error("one of --hf / --random is required")

    if args.version == 0:
        write_v0(args.filepath, cfg, params)
    else:
        err = write_v3(args.filepath, cfg, params, group_size=args.group)
        print(f"max quantization group error: {err:.5f}")
    print(f"wrote {args.filepath} ({os.path.getsize(args.filepath)} bytes) "
          f"family={cfg.family} dim={cfg.dim} L={cfg.n_layers}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
