#!/usr/bin/env python
"""HF parity oracle, a port of tools/hf_parity.py.

Runs one prompt through transformers (fp32, on the CPU) and through the
port from the same HF checkpoint directory, reports the largest logit
difference over the prompt and the first divergence of the greedy token
streams, and exits 0 only when both agree:

    python -m kuiperllama_tpu_torch.tools.hf_parity --hf DIR --prompt "hi" \
        --steps 32 [--atol 2e-4] [--device cuda|cpu]

The port runs in fp32 on `--device`. Needs `transformers`, imported here
only, and the directory's tokenizer files.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import add_device_arg, resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--hf", required=True)
    ap.add_argument("--prompt", default="hi")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--atol", type=float, default=2e-4)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from transformers import AutoModelForCausalLM, AutoTokenizer

    from ..checkpoint.hf import load_hf
    from ..models import decoder
    from ..params import to_device
    from ..serving.generate import Generator

    hf_tok = AutoTokenizer.from_pretrained(args.hf)
    hf = AutoModelForCausalLM.from_pretrained(args.hf, torch_dtype=torch.float32).eval()

    cfg, params = load_hf(args.hf)
    params = to_device(params, device=dev, dtype=torch.float32)

    ids = hf_tok(args.prompt, return_tensors="pt").input_ids
    prompt_ids = ids[0].tolist()

    # prompt logits parity
    with torch.no_grad():
        ref_logits = hf(ids).logits.numpy()
        cache = decoder.init_kv_cache(cfg, 1, max_len=len(prompt_ids) + args.steps + 8,
                                      device=dev)
        positions = torch.arange(len(prompt_ids), dtype=torch.int32, device=dev)[None]
        logits, _ = decoder.forward(cfg, params, ids.to(device=dev, dtype=torch.int32),
                                    positions, cache)
    delta = float(np.abs(logits.cpu().numpy() - ref_logits).max())
    print(f"prompt logits max |delta|: {delta:.2e}  (atol {args.atol})")

    # greedy decode parity
    with torch.no_grad():
        ref_out = hf.generate(ids, max_new_tokens=args.steps, do_sample=False)
    ref_ids = ref_out[0][len(prompt_ids):].tolist()

    gen = Generator(cfg, params, cache_len=len(prompt_ids) + args.steps + 8)
    got_ids, _, _ = gen.generate_ids(prompt_ids, max_new_tokens=args.steps)

    n = min(len(ref_ids), len(got_ids))
    div = next((i for i in range(n) if ref_ids[i] != got_ids[i]), None)
    if div is None and delta <= args.atol:
        print(f"PARITY OK: {n} greedy tokens identical")
        print("text:", hf_tok.decode(got_ids))
        return 0
    print(f"PARITY FAIL: first divergence at step {div}")
    print("hf :", ref_ids[:16])
    print("us :", got_ids[:16])
    return 1


if __name__ == "__main__":
    sys.exit(main())
