#!/usr/bin/env python
"""Three ways to write the dense KV cache in a decode step. Port of
tools/exp_cache.py.

The JAX experiment compares how its nested decode scan carries the cache.
Each form here has a torch spelling with its own cost on the card:
  A) write the new K/V row into one layer's view in place, as the port's
     decoder does (`k_all[li][b, pos] = k`);
  B) one write into the full [L, B, S, KH, hd] tensor at (li, :, pos)
     (`k_all.index_put_((li, b, pos), k)`), then read the layer;
  C) functional, JAX's xs/ys form: each layer returns its new cache
     (an out-of-place write into a copy of its slice) and the full cache is
     rebuilt with `torch.stack`: a whole-cache copy per step.
The layer body is the tool's own, built from the port's decoder pieces
(`decoder._qkv`, `attention_dense`, `decoder._mlp_residual`), so all three
forms compute what the layered decode step computes. Each runs a greedy
64-step chunk of a B = 1 model (TinyLlama-1.1B INT8, fused, random
weights; bf16 activations and cache of 1024 slots) from token 0 at pos 17,
every step a replay of a CUDA graph of that form's step (a graph cache per
form), timed between CUDA events: after the captures, 5 rounds run one
chunk of each form in turn and each form keeps its best (the JAX tool
takes the mean of 3 in a row). The three token streams must be equal.

    python -m kuiperllama_tpu_torch.tools.exp_cache [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import torch

from ..config import preset_config
from ..fuse import fuse_params
from ..models import decoder
from ..ops.attention import attention_dense
from ..ops.linear import linear
from ..ops.rmsnorm import rmsnorm
from ..ops.rope import gather_rope
from ..params import random_params_device
from ..serving.graphs import run_steps
from ..utils.profiling import event_times
from . import (add_device_arg, counted_launches, decode_state, graph_cache, report,
               resolve_device)

FORMS = ("A", "B", "C")
POS = 17
ROUNDS = 5


def step_logits(cfg, params, token, pos, k_all, v_all, rope, form: str):
    """fp32 logits [B, vocab] of one decode step at `pos` [B], writing the
    new K/V rows into k_all, v_all [L, B, S, KH, hd] in `form`'s way."""
    B = token.shape[0]
    hd = cfg.head_dim
    blocks = params["blocks"]
    x = params["tok_emb"][token.long()][:, None]  # [B, 1, dim]
    positions = pos[:, None]
    s, c = gather_rope(*rope, positions)
    b_idx = torch.arange(B, device=x.device)[:, None]
    slots = positions.long()
    new_k, new_v = [], []
    for li in range(cfg.n_layers):
        q, k, v, H, KH = decoder._qkv(cfg, blocks, li, x, s, c, B, 1)
        k, v = k.to(k_all.dtype), v.to(v_all.dtype)
        if form == "A":
            kc, vc = k_all[li], v_all[li]
            kc[b_idx, slots] = k
            vc[b_idx, slots] = v
        elif form == "B":
            at = (torch.full_like(slots, li), b_idx, slots)
            k_all.index_put_(at, k)
            v_all.index_put_(at, v)
            kc, vc = k_all[li], v_all[li]
        else:
            kc = k_all[li].index_put((b_idx, slots), k)
            vc = v_all[li].index_put((b_idx, slots), v)
            new_k.append(kc)
            new_v.append(vc)
        attn = attention_dense(q, kc, vc, positions, None)
        x = decoder._mlp_residual(cfg, blocks, li, x, attn, B, 1, H, hd)
    if form == "C":
        torch.stack(new_k, out=k_all)
        torch.stack(new_v, out=v_all)
    x = rmsnorm(x[:, 0], params["final_norm"], cfg.norm_eps)
    return linear(x, params["lm_head"]).float()


def form_chunk(cfg, params, form: str, steps: int, cache_len: int, dev, rope):
    """(a function that runs one greedy `steps`-step chunk of `form` from
    token 0 at pos 17 on the form's own cache and graph cache, the
    DecodeState it writes)."""
    cache = decoder.init_kv_cache(cfg, batch=1, max_len=cache_len,
                                  dtype=torch.bfloat16, device=dev)
    state = decode_state(1, dev, steps)
    graphs = graph_cache(dev)

    def step():
        state.emit(step_logits(cfg, params, state.token, state.pos, cache["k"],
                               cache["v"], rope, form))

    def chunk():
        state.token.zero_()
        state.pos.fill_(POS)
        state.done.zero_()
        run_steps(state, step, steps, graphs, ("exp_cache", form),
                  (cache["k"], cache["v"], *rope))

    return chunk, state


def run(dev, cfg=None, params=None, model: str = "tinyllama-1.1b", steps: int = 64,
        cache_len: int = 1024) -> dict:
    before = counted_launches()
    cfg = cfg or preset_config(model, seq_len=cache_len)
    if params is None:
        params = fuse_params(random_params_device(cfg, device=dev, quantize=True,
                                                  dtype=torch.bfloat16))
    rope = decoder.build_rope(cfg, dev)
    forms = {f: form_chunk(cfg, params, f, steps, cache_len, dev, rope) for f in FORMS}
    times = {f: [] for f in FORMS}
    for chunk, _ in forms.values():
        chunk()  # on the card: the step's eager call and capture
    for _ in range(ROUNDS):
        for f, (chunk, _) in forms.items():
            times[f] += event_times(chunk, 1, dev)
    ms = {f: min(times[f]) / steps * 1e3 for f in FORMS}
    tokens = {f: state.toks[:, :steps].tolist() for f, (_, state) in forms.items()}
    for f in FORMS:
        print(f"mode {f}: {ms[f]:.3f} ms/token  ({1e3 / ms[f]:.0f} tok/s)")
    return report(dev, dict(
        tool="exp_cache", model=model, steps=steps, cache_len=cache_len,
        ms_per_token=ms, tok_s={f: 1e3 / ms[f] for f in FORMS},
        graphs=dev.type == "cuda", tokens=tokens["A"],
        tokens_equal=tokens["A"] == tokens["B"] == tokens["C"]), before)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(ap)
    args = ap.parse_args(argv)
    return run(resolve_device(args.device))


if __name__ == "__main__":
    main()
