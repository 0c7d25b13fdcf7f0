"""CLI inference demo of the PyTorch/CUDA port (counterpart of demo/infer.py).

Usage:
  python -m kuiperllama_tpu_torch.demo --model model.bin --tokenizer tok.model \
      [--family llama2|llama3|qwen2] [--prompt "a"] [--steps 128] \
      [--temperature 0.0] [--dtype bf16|f32] [--device cuda|cpu] [--no-kernels]

Accepts .bin (v0 fp32 / v3 int8) checkpoints or an HF model directory
(config.json + *.safetensors). Prints the generated text and steps/s. On a
CUDA device the INT8 projections run the port's kernels; on the CPU they
run the kernels' plain PyTorch versions. `--no-kernels` (the counterpart of
demo/infer.py's `--no-pallas`) sends the INT8 projections to
`ops.linear.quant_matmul_plain` and keeps the decode megakernels off, on
any device.
"""

import argparse
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--tokenizer", required=True)
    ap.add_argument("--family", default="llama2",
                    choices=["llama2", "llama3", "qwen2"])
    ap.add_argument("--prompt", default="a")
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    ap.add_argument("--cache-len", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-kernels", action="store_true",
                    help="INT8 projections through the plain PyTorch "
                         "matmul, no megakernel")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as decode chunks land instead of "
                         "at the end")
    args = ap.parse_args(argv)

    from .ops.linear import set_use_kernels

    set_use_kernels(not args.no_kernels)
    try:
        _run(args)
    finally:
        set_use_kernels(True)


def _run(args):
    import torch

    from .checkpoint.binfmt import load_bin
    from .checkpoint.hf import load_hf
    from .fuse import fuse_params
    from .params import to_device
    from .serving.generate import Generator
    from .tokenizer import load_tokenizer

    t0 = time.perf_counter()
    if os.path.isdir(args.model):
        cfg, params = load_hf(args.model)
    else:
        cfg, params = load_bin(args.model, family=args.family)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    params = fuse_params(to_device(params, device=args.device, dtype=dtype))
    tok = load_tokenizer(args.tokenizer, family=cfg.family,
                         vocab_size=cfg.vocab_size)
    print(f"[load] {cfg.family} dim={cfg.dim} L={cfg.n_layers} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} vocab={cfg.vocab_size} "
          f"quant={'int8 g' + str(cfg.group_size) if cfg.group_size else 'fp'} "
          f"device={args.device} ({time.perf_counter() - t0:.1f}s)",
          file=sys.stderr)

    gen = Generator(cfg, params, tok, cache_len=args.cache_len)
    if args.stream:
        state = {"prev": -1, "stopped": False}
        sys.stdout.write(args.prompt)
        sys.stdout.flush()

        def on_chunk(block):
            if state["stopped"]:
                return
            for t in block[0]:
                t = int(t)
                if tok.is_stop(t):
                    state["stopped"] = True
                    break
                sys.stdout.write(tok.decode_token(t, state["prev"]))
                state["prev"] = t
            sys.stdout.flush()

        ids, prefill_s, decode_s = gen.generate_batch_ids(
            [tok.encode(args.prompt)], max_new_tokens=args.steps,
            temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
            stop_ids=tok.stop_ids, on_chunk=on_chunk,
        )
        print()
        n = len(ids[0])
        print(f"\nsteps: {n}  prefill: {prefill_s * 1e3:.0f} ms  "
              f"decode: {decode_s:.2f} s  steps/s: {n / decode_s:.2f}",
              file=sys.stderr)
        return
    res = gen.generate(
        args.prompt, max_new_tokens=args.steps,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
    )
    print(args.prompt + res.text)
    n = len(res.tokens)
    print(f"\nsteps: {n}  prefill: {res.prefill_s * 1e3:.0f} ms  "
          f"decode: {res.decode_s:.2f} s  steps/s: {res.tokens_per_s:.2f}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
