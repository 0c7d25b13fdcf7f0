"""The port's tools, counterparts of the repo-root JAX tools of the same
names. Kernel measurement:

    python -m kuiperllama_tpu_torch.tools.roofline       # HBM, GEMV and tensor-core probes
    python -m kuiperllama_tpu_torch.tools.exp_kernel     # int8 stream / GEMM / outscale at M = 8
    python -m kuiperllama_tpu_torch.tools.exp_int8       # GEMV formulations over an int8 stack
    python -m kuiperllama_tpu_torch.tools.bench_kernels  # INT8 matmul GB/s at a preset's shapes

Parallelism:

    python -m kuiperllama_tpu_torch.tools.scaling        # tp scaling on a pool of ranks, projected on NVLink
    python -m kuiperllama_tpu_torch.tools.seqpar_bytes   # seqpar page-read bytes per rank (host only)

Checkpoints and quality:

    python -m kuiperllama_tpu_torch.tools.export         # HF dir / --random -> .bin v0/v3
    python -m kuiperllama_tpu_torch.tools.ppl            # the |delta ppl| <= 0.1 gate
    python -m kuiperllama_tpu_torch.tools.gate_group     # the gate on the tinychar fixtures
    python -m kuiperllama_tpu_torch.tools.hf_parity      # logits and tokens against transformers

`export` and `seqpar_bytes` run on the host only.

Each takes `--device` (default cuda). Without a card a cuda run exits
non-zero; it never falls back to the CPU. `--device cpu` runs the kernels'
plain versions and says "device": "cpu" in its JSON.
"""

from __future__ import annotations

import argparse

import torch

ITERS = 25  # timed calls per variant, after one warm-up call


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) launches the kernels; cpu runs their "
                         "plain versions")


def resolve_device(name: str) -> torch.device:
    """The torch device of `--device`; exits with a message when cuda is
    asked for and there is no card."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run on a machine with the card, or "
                         "pass --device cpu for the plain versions")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
