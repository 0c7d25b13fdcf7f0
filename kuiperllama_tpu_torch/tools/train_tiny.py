#!/usr/bin/env python
"""Train a tiny char-level Llama-family model on the checked-in corpus and
run the INT8 perplexity gate on its real weights and real text. Port of
tools/train_tiny.py.

A torch training loop over the port's `models/decoder.py` `forward` (fp32
params take the plain matmul, and autograd passes through the forward's
in-place cache writes): random windows of `tests/data/tinycorpus.txt`
(byte ids capped at 127; the first 85% trains, the last 15% is held out),
drawn by a torch.Generator seeded by --seed on the device; torch AdamW with
optax `adamw`'s defaults (betas 0.9 / 0.999, eps 1e-8, weight decay 1e-4
on every leaf). --scan-chunk is the number of steps between host reads of
the loss (the JAX tool's steps per device call), so no step syncs. The
model is then exported to v0 (fp32) and v3 (INT8, group 64) `.bin` files
(`checkpoint/binfmt.py`), loaded back through the loaders, and gated:
|ppl(int8) - ppl(fp32)| <= 0.1 on the held-out text (`evaluate.py`); on
the card every INT8 projection of a 128-token window runs the GEMM kernel.
The report goes to --out/GATE_PPL.json and, with the device and the
kernels' launches, to the last line of the output; the exit code is 1
when the gate fails.

--out is required and may not be an existing directory under checkpoints/,
so no committed fixture is written over.

    python -m kuiperllama_tpu_torch.tools.train_tiny --out DIR [--steps 800]
        [--batch 16] [--lr 3e-3] [--seed 0] [--dim 128] [--hidden-dim 384]
        [--family llama2|llama3|qwen2] [--scan-chunk 25] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..checkpoint.binfmt import load_bin, write_v0, write_v3
from ..config import ModelConfig
from ..evaluate import quantization_ppl_delta
from ..models import decoder
from ..params import random_params, to_device
from . import add_device_arg, counted_launches, report, resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CORPUS = os.path.join(ROOT, "tests", "data", "tinycorpus.txt")
# optax.adamw's defaults (torch's AdamW decays by 1e-2)
BETAS, EPS, WEIGHT_DECAY = (0.9, 0.999), 1e-8, 1e-4
EXPORT_GROUP = 64


def build_cfg(seq_len=128, family="llama2", dim=128, hidden_dim=384) -> ModelConfig:
    """The JAX tool's model: 4 layers, 4 heads, 2 kv heads, 128 byte ids."""
    return ModelConfig.from_header(
        family=family, dim=dim, hidden_dim=hidden_dim, n_layers=4, n_heads=4,
        n_kv_heads=2, vocab_size=128, seq_len=seq_len, tied_embedding=False)


def encode_bytes(text: str) -> np.ndarray:
    ids = np.frombuffer(text.encode("ascii", errors="replace"), np.uint8)
    return np.minimum(ids, 127).astype(np.int32)


def leaves(params) -> list:
    """Every tensor of a params dict, in a fixed order."""
    out = []
    for v in params.values():
        out += leaves(v) if isinstance(v, dict) else [v]
    return out


def trainable(np_params, dev) -> dict:
    """fp32 leaf tensors on `dev` that require grad, from a numpy dict."""
    return {k: trainable(v, dev) if isinstance(v, dict)
            else torch.tensor(np.asarray(v, np.float32), device=dev, requires_grad=True)
            for k, v in np_params.items()}


def to_numpy(params) -> dict:
    return {k: to_numpy(v) if isinstance(v, dict)
            else v.detach().cpu().numpy().astype(np.float32)
            for k, v in params.items()}


def make_optimizer(params, lr: float) -> torch.optim.AdamW:
    return torch.optim.AdamW(leaves(params), lr=lr, betas=BETAS, eps=EPS,
                             weight_decay=WEIGHT_DECAY)


def loss_fn(cfg, params, tokens: torch.Tensor, rope) -> torch.Tensor:
    """Mean next-token negative log-likelihood of tokens [B, T + 1]: the
    forward over all T + 1 positions (fp32 cache of T + 1 slots), fp32
    log_softmax of the first T positions' logits."""
    B, T1 = tokens.shape
    cache = decoder.init_kv_cache(cfg, batch=B, max_len=T1, dtype=torch.float32,
                                  device=tokens.device)
    positions = torch.arange(T1, dtype=torch.int32, device=tokens.device).expand(B, T1)
    logits, _ = decoder.forward(cfg, params, tokens, positions, cache, rope=rope,
                                drop_past_end=False)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    return -torch.gather(logp, -1, tokens[:, 1:].long()[..., None]).mean()


def train_step(cfg, params, opt, tokens, rope) -> torch.Tensor:
    """One AdamW step on `tokens`; returns the loss before it (on the device)."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(cfg, params, tokens, rope)
    loss.backward()
    opt.step()
    return loss.detach()


def export(out_dir: str, cfg, host_params) -> tuple:
    """(v0 path, v3 path, largest group-quantization error) of `host_params`
    (numpy, fp32) written to `out_dir`."""
    os.makedirs(out_dir, exist_ok=True)
    p0 = os.path.join(out_dir, "tinychar.bin")
    p3 = os.path.join(out_dir, "tinychar.q8.bin")
    write_v0(p0, cfg, host_params)
    max_err = write_v3(p3, cfg, host_params, group_size=EXPORT_GROUP)
    return p0, p3, max_err


def check_out(out: str):
    """Refuse an existing directory under checkpoints/ (the fixtures)."""
    ckpt = os.path.realpath(os.path.join(ROOT, "checkpoints"))
    path = os.path.realpath(out)
    if os.path.isdir(path) and os.path.commonpath([ckpt, path]) == ckpt:
        raise SystemExit(f"train_tiny: {out} is an existing directory under "
                         "checkpoints/; write to a new one")


def run(dev, out: str, cfg=None, steps: int = 800, batch: int = 16,
        lr: float = 3e-3, seed: int = 0, family: str = "llama2",
        scan_chunk: int = 25, dim: int = 128, hidden_dim: int = 384) -> dict:
    check_out(out)
    before = counted_launches()
    cfg = cfg or build_cfg(family=family, dim=dim, hidden_dim=hidden_dim)
    with open(CORPUS) as f:
        ids = encode_bytes(f.read())
    split = int(len(ids) * 0.85)
    train_ids, heldout_ids = ids[:split], ids[split:]
    print(f"[train] corpus {len(ids)} chars, train {split}, "
          f"held-out {len(ids) - split}", file=sys.stderr)

    T = cfg.seq_len
    params = trainable(random_params(cfg, seed=seed), dev)
    opt = make_optimizer(params, lr)
    rope = decoder.build_rope(cfg, dev)
    data = torch.from_numpy(train_ids).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    offsets = torch.arange(T + 1, device=dev)
    losses = []
    t0 = time.time()
    for c in range(-(-steps // scan_chunk)):
        for _ in range(scan_chunk):
            starts = torch.randint(0, len(train_ids) - T - 1, (batch,),
                                   generator=gen, device=dev)
            losses.append(train_step(cfg, params, opt,
                                     data[starts[:, None] + offsets], rope))
        print(f"[train] step {(c + 1) * scan_chunk:4d}  loss {float(losses[-1]):.4f}  "
              f"({time.time() - t0:.0f}s)", file=sys.stderr)

    p0, p3, max_err = export(out, cfg, to_numpy(params))
    print(f"[export] {p0} + {p3} (max group quant err {max_err:.5f})", file=sys.stderr)
    cfg0, pf = load_bin(p0, family=family)
    cfg3, pq = load_bin(p3, family=family, quantized=True)
    gate = quantization_ppl_delta(cfg0, to_device(pf, dev, torch.float32),
                                  cfg3, to_device(pq, dev, torch.float32),
                                  heldout_ids, window=cfg.seq_len)
    gate.update(
        family=family, qkv_bias=bool(cfg.qkv_bias),
        corpus="tests/data/tinycorpus.txt (held-out 15%)",
        heldout_tokens=int(len(heldout_ids)), train_steps=steps,
        initial_train_loss=round(float(losses[0]), 4),
        final_train_loss=round(float(losses[-1]), 4),
        quant=f"v3 group={EXPORT_GROUP} int8",
        kernel_mode="cuda-gemm" if dev.type == "cuda" else "cpu-plain",
        max_group_quant_err=round(float(max_err), 6), train_s=time.time() - t0)
    with open(os.path.join(out, "GATE_PPL.json"), "w") as f:
        json.dump(gate, f, indent=2)
    return report(dev, dict(tool="train_tiny", out=out, **gate), before)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(ap)
    ap.add_argument("--out", required=True,
                    help="a new directory (not an existing one under checkpoints/)")
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--hidden-dim", type=int, default=384,
                    help="dim and hidden must divide the quant group under test")
    ap.add_argument("--family", default="llama2", choices=["llama2", "llama3", "qwen2"])
    ap.add_argument("--scan-chunk", type=int, default=25,
                    help="train steps between host reads of the loss")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = run(dev, args.out, steps=args.steps, batch=args.batch, lr=args.lr,
              seed=args.seed, family=args.family, scan_chunk=args.scan_chunk,
              dim=args.dim, hidden_dim=args.hidden_dim)
    if not out["passes_gate"]:
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
