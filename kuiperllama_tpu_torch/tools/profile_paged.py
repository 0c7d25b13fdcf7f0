#!/usr/bin/env python
"""Paged decode-step breakdown at serving geometry. Port of
tools/profile_paged.py.

Times the PagedEngine's decode chunk (`models/paged.py` `run_chunk_paged`,
the in-place form of `decode_chunk_paged`, on a CUDA graph of the step as
the engine runs it) in three variants:
  * the full step;
  * no page writes (`paged._DEBUG_SKIP_WRITES = True`);
  * no page writes and the paged attention kernel replaced by a stub that
    returns the flash identity's (acc, m, l) = (0, 0, 1) in the kernel's
    shapes (`paged.paged_attention_flat`, looked up at call time);
so that the step splits into attention, page writes ("scatter", the JAX
tool's name) and the rest (matmuls and sampling). Each variant runs on a new
graph cache (the counterpart of JAX's `decode_chunk_paged.clear_cache()`):
a captured graph replays what it captured. The flag and the stub are set
around each of a variant's chunks and undone after it, by an exception
too. The full step's chunk
also runs on the eager route, and its tokens must equal the graph route's.
Two checks show that the variants removed what they say, which their times
alone (a few per cent of a step apart) cannot: one chunk of each variant
from zeroed pools, after which only the full step's pools are nonzero
(`writes_pools`), and each variant's launches over its timed rounds, where
the stubbed one has no paged attention (`launches_by_variant`).

Each row's pages cover prompt-len + steps + 1 tokens; the pools start at
zero (no prefill, as in the JAX tool). A chunk is timed between CUDA
events, host gaps included. After each variant's capture, 5 rounds run one
chunk of each variant in turn, and each variant keeps its best round (the
JAX tool takes the mean of 3 in a row; a drift of the card's clock then
falls on one variant).

    python -m kuiperllama_tpu_torch.tools.profile_paged [--model llama2-7b]
        [--batch 8] [--max-len 1024] [--page-size 128] [--steps 16]
        [--prompt-len 32] [--fp] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..config import preset_config
from ..fuse import fuse_params
from ..kvcache import PageAllocator, init_paged_cache
from ..models import decoder, paged
from ..ops.kernels.paged_attention import build_work_list
from ..params import param_bytes, random_params_device
from ..utils.profiling import event_times
from . import (add_device_arg, counted_launches, decode_state, graph_cache, patched,
               report, resolve_device)

ROUNDS = 5
TOKEN = 7


def attention_stub(q, *args, **kwargs):
    """The paged kernel's outputs for no keys: acc 0, m 0, l 1."""
    B, H, hd = q.shape
    return (torch.zeros((B, H, hd), dtype=torch.float32, device=q.device),
            torch.zeros((B, H), dtype=torch.float32, device=q.device),
            torch.ones((B, H), dtype=torch.float32, device=q.device))


VARIANTS = (
    ("full step", []),
    ("no KV scatter", [(paged, "_DEBUG_SKIP_WRITES", True)]),
    ("no scatter, attention stubbed", [(paged, "_DEBUG_SKIP_WRITES", True),
                                       (paged, "paged_attention_flat", attention_stub)]),
)


def run(dev, cfg=None, model: str = "llama2-7b", batch: int = 8,
        max_len: int = 1024, page_size: int = 128, steps: int = 16,
        prompt_len: int = 32, fp: bool = False) -> dict:
    before = counted_launches()
    cfg = cfg or preset_config(model, seq_len=max_len)
    B, ps = batch, page_size
    params = fuse_params(random_params_device(
        cfg, device=dev, quantize=not fp, dtype=torch.bfloat16))
    print(f"[prof] params {param_bytes(params) / 1e9:.2f} GB", file=sys.stderr)
    n_pages = B * (-(-max_len // ps)) + 1
    pool = init_paged_cache(cfg, n_pages=n_pages, page_size=ps,
                            dtype=torch.bfloat16, device=dev)
    kp, vp = pool.k_pages, pool.v_pages
    print(f"[prof] pool {2 * kp.numel() * kp.element_size() / 1e9:.2f} GB "
          f"({n_pages} pages)", file=sys.stderr)
    alloc = PageAllocator(n_pages=n_pages, page_size=ps, max_seqs=B, max_len=max_len)
    for s in range(B):
        if not alloc.alloc_seq(s, prompt_len + steps + 1):
            raise ValueError(f"{n_pages} pages do not hold {B} rows of "
                             f"{prompt_len + steps + 1} tokens")
    work = build_work_list(alloc.page_table, alloc.seq_lens, ps)
    meta = tuple(torch.from_numpy(a).to(dev) for a in (alloc.page_table, *work))
    rope = decoder.build_rope(cfg, dev)
    state = decode_state(B, dev, steps)

    def chunk(graphs):
        state.token.fill_(TOKEN)
        state.pos.fill_(prompt_len)
        state.done.zero_()
        return paged.run_chunk_paged(cfg, params, state, kp, vp, None, meta, steps,
                                     ps, rope=rope, graphs=graphs)

    # each variant's graphs captured under its patches, then ROUNDS rounds
    # of one chunk per variant in turn (the patches on again, in case a
    # graph is captured anew), so that a drift of the card's clock reaches
    # every variant alike; each keeps its best round
    caches = {tag: graph_cache(dev) for tag, _ in VARIANTS}
    times = {tag: [] for tag, _ in VARIANTS}
    launches = {tag: dict.fromkeys(counted_launches(), 0) for tag, _ in VARIANTS}
    for rnd in range(ROUNDS + 1):
        for tag, patches in VARIANTS:
            with patched(patches):
                if rnd == 0:
                    chunk(caches[tag])  # on the card: each step's eager call and capture
                else:
                    n0 = counted_launches()
                    times[tag] += event_times(lambda: chunk(caches[tag]), 1, dev)
                    n1 = counted_launches()
                    for k in n1:
                        launches[tag][k] += n1[k] - n0[k]
            if rnd == 1 and tag == VARIANTS[0][0]:  # a chunk of replays
                tokens = state.toks[:, :steps].tolist()
    times = {tag: min(t) / steps for tag, t in times.items()}

    def writes_pools(tag, patches):
        kp.zero_()
        vp.zero_()
        with patched(patches):
            chunk(caches[tag])
        return bool(kp.any() or vp.any())

    writes = {tag: writes_pools(tag, patches) for tag, patches in VARIANTS}
    for tag, dt in times.items():
        print(f"[prof] {tag}: {dt * 1e3:.2f} ms/step  ({B / dt:.1f} tok/s aggregate)")
    eager_tokens = chunk(None).tolist()
    full, no_writes, no_attn = (times[t] for t, _ in VARIANTS)
    print(f"[prof] attribution: attention {1e3 * (no_writes - no_attn):.2f} ms, "
          f"scatter {1e3 * (full - no_writes):.2f} ms, "
          f"rest (matmuls+sampling) {1e3 * no_attn:.2f} ms")
    return report(dev, dict(
        tool="profile_paged", model=model, batch=B, max_len=max_len,
        page_size=ps, steps=steps, prompt_len=prompt_len, fp=fp, n_pages=n_pages,
        ms_per_step={t: times[t] * 1e3 for t, _ in VARIANTS},
        tok_s_aggregate={t: B / times[t] for t, _ in VARIANTS},
        attribution_ms=dict(attention=1e3 * (no_writes - no_attn),
                            scatter=1e3 * (full - no_writes),
                            rest=1e3 * no_attn),
        writes_pools=writes, launches_by_variant=launches,
        graphs=dev.type == "cuda", tokens=tokens,
        tokens_equal_eager=tokens == eager_tokens), before)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(ap)
    ap.add_argument("--model", default="llama2-7b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--page-size", type=int, default=128)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--fp", action="store_true", help="bf16 weights, no quant")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    return run(dev, model=args.model, batch=args.batch, max_len=args.max_len,
               page_size=args.page_size, steps=args.steps,
               prompt_len=args.prompt_len, fp=args.fp)


if __name__ == "__main__":
    main()
