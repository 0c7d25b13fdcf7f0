#!/usr/bin/env python
"""Decode-step component ablation with bench-grade timing. Port of
tools/exp_step.py.

Times the bench's decode (`Generator.generate_batch_ids`: a 32-token prompt,
--steps greedy tokens in one chunk; the host fetches each chunk) with one
component at a time replaced by a near no-op; its delta against the
baseline is that component's serialized cost per decode step:
  * no_attention: `attention_dense` passes q through (cache writes stay);
  * no_rmsnorm:   `rmsnorm` is the identity;
  * no_rope:      `apply_rope` is the identity;
  * no_argmax:    `sample_token` returns token 7 (a one-element op);
  * matmuls_plus_cache_only: all four at once.
The names are patched where the port looks them up at call time:
`models/decoder.py` for the three ops, `ops/sampling.py` (which
`DecodeState.emit` calls) and `serving/generate.py` (the prefill's) for the
sampler. Each variant runs on a Generator of its own, so on its own graph
cache (the counterpart of `jax.clear_caches()`), warmed up under its
patches. Then 3 rounds run each variant once in turn, its patches on
around its run and undone after it, by an exception too, and each keeps
its best (the JAX tool runs a variant's best of 3 in a row; the card's
clock drifted 10% between two such rows). A new Generator after the
rounds must give the baseline's tokens.

A megakernel route calls none of these functions, so its ablations would
read zero: the tool refuses any route but the layered one (exit non-zero),
before the runs when the Generator would pick a megakernel, and after them
when the rounds' launch counters show one (`route` in the JSON is that
measured route). The default, Llama-2-7B INT8 g 256 with bf16 scales (the
bench's default weights), decodes layered.

    python -m kuiperllama_tpu_torch.tools.exp_step [--model llama2-7b]
        [--steps 128] [--batch 1] [--cache-len 1024] [--fp] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..config import preset_config
from ..fuse import fuse_params
from ..models import decoder
from ..ops import sampling
from ..params import random_params_device
from ..quant import cast_scales
from ..serving import generate
from . import (add_device_arg, counted_launches, patched, report, resolve_device,
               route_of)

PROMPT = list(range(5, 37))
ROUNDS = 3


def _no_attention(q, k, v, pos, mask=None):
    return q


def _identity_norm(x, w, eps):
    return x


def _identity_rope(x, s, c, style):
    return x


def _token_7(logits, generator=None, temperature=0.0, top_k=0, top_p=1.0):
    return logits[..., :1].abs().argmin(dim=-1).to(torch.int32) + 7


ATTENTION = [(decoder, "attention_dense", _no_attention)]
NORM = [(decoder, "rmsnorm", _identity_norm)]
ROPE = [(decoder, "apply_rope", _identity_rope)]
SAMPLER = [(sampling, "sample_token", _token_7), (generate, "sample_token", _token_7)]
VARIANTS = (("baseline", []), ("no_attention", ATTENTION), ("no_rmsnorm", NORM),
            ("no_rope", ROPE), ("no_argmax", SAMPLER),
            ("matmuls_plus_cache_only", ATTENTION + NORM + ROPE + SAMPLER))


def generator(cfg, params, steps: int, batch: int, cache_len: int):
    """A new Generator (so a new graph cache), warmed up: its graphs are
    captured under the patches in force. Refuses one whose decode takes a
    megakernel."""
    gen = generate.Generator(cfg, params, cache_len=cache_len,
                             cache_dtype=torch.bfloat16, chunk=steps)
    if gen._fused_ok(batch):
        raise SystemExit("exp_step: the decode takes a megakernel route, which "
                         "calls none of the ablated functions; run a model that "
                         "decodes layered (or set KT_FUSED_STEP=0)")
    gen.generate_batch_ids([PROMPT] * batch, max_new_tokens=8)
    return gen


def decode_once(gen, steps: int, batch: int):
    """(seconds per decode step, the tokens) of one bench-grade run."""
    rows, _, decode_s = gen.generate_batch_ids([PROMPT] * batch, max_new_tokens=steps)
    return decode_s / sum(len(r) for r in rows) * batch, rows


def run(dev, cfg=None, model: str = "llama2-7b", steps: int = 128, batch: int = 1,
        cache_len: int = 1024, group: int = 256, fp: bool = False) -> dict:
    before = counted_launches()
    cfg = cfg or preset_config(model, seq_len=max(cache_len, 256))
    params = fuse_params(random_params_device(cfg, device=dev, quantize=not fp,
                                              dtype=torch.bfloat16, group_size=group))
    if not fp:
        params = cast_scales(params, torch.bfloat16)

    gens, times, tokens = {}, {t: [] for t, _ in VARIANTS}, {}
    for tag, patches in VARIANTS:
        with patched(patches):
            gens[tag] = generator(cfg, params, steps, batch, cache_len)
    n0 = counted_launches()
    for _ in range(ROUNDS):
        for tag, patches in VARIANTS:
            with patched(patches):
                dt, tokens[tag] = decode_once(gens[tag], steps, batch)
            times[tag].append(dt)
    n1 = counted_launches()
    route = route_of({k: n1[k] - n0[k] for k in n1})
    if route != "layered":
        raise SystemExit(f"exp_step: the decode launched the {route} megakernel "
                         "route, which calls none of the ablated functions")
    results = {tag: min(t) for tag, t in times.items()}
    for tag, dt in results.items():
        print(f"{tag:28s} {dt * 1e3:7.3f} ms/step  {batch / dt:6.1f} tok/s",
              file=sys.stderr)
    # a new Generator with nothing patched: the patches left nothing behind
    again, tokens_again = decode_once(generator(cfg, params, steps, batch, cache_len),
                                      steps, batch)

    base = results["baseline"]
    out = dict(tool="exp_step", model=model, batch=batch, steps=steps,
               group_size=None if fp else group, route=route, rounds=ROUNDS,
               ms_per_step={t: round(results[t] * 1e3, 3) for t, _ in VARIANTS},
               component_cost_ms={t.replace("no_", ""): round((base - results[t]) * 1e3, 3)
                                  for t, _ in VARIANTS if t != "baseline"},
               ms_per_step_rounds={t: [round(x * 1e3, 3) for x in v] for t, v in times.items()},
               baseline_again_ms=round(again * 1e3, 3),
               baseline_tokens_equal=tokens["baseline"] == tokens_again)
    print(f"route {route}; component cost ms {out['component_cost_ms']}")
    return report(dev, out, before)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(ap)
    ap.add_argument("--model", default="llama2-7b")
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--cache-len", type=int, default=1024)
    ap.add_argument("--fp", action="store_true",
                    help="bf16 dense weights (no quant), the qwen/fp bench configuration")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    return run(dev, model=args.model, steps=args.steps, batch=args.batch,
               cache_len=args.cache_len, fp=args.fp)


if __name__ == "__main__":
    main()
