"""The port's tools, counterparts of the repo-root JAX tools of the same
names. Kernel measurement:

    python -m kuiperllama_tpu_torch.tools.roofline       # HBM, GEMV and tensor-core probes
    python -m kuiperllama_tpu_torch.tools.exp_kernel     # int8 stream / GEMM / outscale at M = 8
    python -m kuiperllama_tpu_torch.tools.exp_int8       # GEMV formulations over an int8 stack
    python -m kuiperllama_tpu_torch.tools.bench_kernels  # INT8 matmul GB/s at a preset's shapes
    python -m kuiperllama_tpu_torch.tools.exp_diag       # the GEMV's group cap: GEMV against GEMM at one row

Where a decode step's time goes:

    python -m kuiperllama_tpu_torch.tools.profile_decode # each projection alone against the whole step
    python -m kuiperllama_tpu_torch.tools.profile2       # graph-chained matmuls, the step per token, --trace
    python -m kuiperllama_tpu_torch.tools.profile_paged  # the paged step: attention / page writes / rest
    python -m kuiperllama_tpu_torch.tools.exp_step       # one component at a time made a near no-op
    python -m kuiperllama_tpu_torch.tools.exp_ablate     # cache lengths, bf16 weights, a small vocabulary
    python -m kuiperllama_tpu_torch.tools.exp_big        # the big megakernel at a changed 7B geometry
    python -m kuiperllama_tpu_torch.tools.exp_cache      # three ways to write the dense cache
    python -m kuiperllama_tpu_torch.tools.bench_matrix --out F   # bench_torch.py over 13 configurations

Parallelism:

    python -m kuiperllama_tpu_torch.tools.scaling        # tp scaling on a pool of ranks, projected on NVLink
    python -m kuiperllama_tpu_torch.tools.seqpar_bytes   # seqpar page-read bytes per rank (host only)

Checkpoints and quality:

    python -m kuiperllama_tpu_torch.tools.export         # HF dir / --random -> .bin v0/v3
    python -m kuiperllama_tpu_torch.tools.ppl            # the |delta ppl| <= 0.1 gate
    python -m kuiperllama_tpu_torch.tools.gate_group     # the gate on the tinychar fixtures
    python -m kuiperllama_tpu_torch.tools.hf_parity      # logits and tokens against transformers
    python -m kuiperllama_tpu_torch.tools.train_tiny --out DIR   # train on tinycorpus, export, gate

`export` and `seqpar_bytes` run on the host only.

Each takes `--device` (default cuda). Without a card a cuda run exits
non-zero; it never falls back to the CPU. `--device cpu` runs the kernels'
plain versions and says "device": "cpu" in its JSON. The step tools print
the JAX tool's quantities under its names, then one JSON dict as the last
line of their output, with the card's name and each kernel's launches in
the run (`report`). A share of bandwidth is a share of the data sheet's
rate (HBM_SHEET_GBPS) and says so; `roofline.probe_read` measures the
card's.
"""

from __future__ import annotations

import argparse
import contextlib
import json
from unittest import mock

import torch

ITERS = 25  # timed calls per variant, after one warm-up call
# the H100 SXM data sheet's HBM3 rate, which every share the tools print is
# taken against
HBM_SHEET_GBPS = 3350.0
HBM_SHEET_SOURCE = "H100 SXM data sheet, 3.35 TB/s"


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


def projection_shapes(cfg) -> dict:
    """(K, N) of each decode projection of `cfg`, fused as `fuse.py` fuses
    them: wqkv, wo, w13, w2 and the lm_head."""
    d, h, kv, V = cfg.dim, cfg.hidden_dim, cfg.kv_dim, cfg.vocab_size
    return {"wqkv": (d, d + 2 * kv), "wo": (d, d), "w13": (d, 2 * h),
            "w2": (h, d), "lm_head": (d, V)}


def counted_launches() -> dict:
    """Each counted kernel wrapper's launches so far, by its name
    (serving/graphs.py `counted_kernels`)."""
    from ..serving.graphs import counted_kernels

    return {w.__name__: w.launches for w in counted_kernels()}


def route_of(launches: dict) -> str:
    """The decode route that a run's launches (a difference of two
    `counted_launches()`) show: "big", "small" (the B = 1 megakernel or its
    chunk) or "layered"."""
    if launches["fused_decode_step_big"]:
        return "big"
    if launches["fused_decode_step"] or launches["fused_decode_chunk"]:
        return "small"
    return "layered"


def graph_cache(dev: torch.device):
    """A new CUDA-graph cache on the card, None (eager) on the CPU."""
    from ..serving.graphs import GraphCache

    return GraphCache(dev) if dev.type == "cuda" else None


def decode_state(B: int, dev, width: int):
    """A zeroed ops.sampling.DecodeState of B rows with no stop id and a
    token block `width` columns wide."""
    from ..ops.sampling import DecodeState
    from ..serving.generate import _stop_array

    return DecodeState(torch.zeros((B,), dtype=torch.int32, device=dev),
                       torch.zeros((B,), dtype=torch.int32, device=dev),
                       torch.zeros((B,), dtype=torch.bool, device=dev),
                       _stop_array((), dev), width)


@contextlib.contextmanager
def patched(patches):
    """`patches` [(object, name, value)] set for the block and undone on
    leaving it, after an exception too."""
    with contextlib.ExitStack() as undo:
        for obj, name, value in patches:
            undo.enter_context(mock.patch.object(obj, name, value))
        yield


def chain_time(step, x0: torch.Tensor, iters: int = 64, reps: int = 3,
               graphs=None):
    """Seconds per call of `iters` serially dependent calls x = step(x, i),
    the counterpart of the JAX tools' lax.scan of dependent calls inside one
    jit. With `graphs` (a serving/graphs.py GraphCache) the whole chain is
    one CUDA graph: the first call runs it eagerly and captures it, then
    `reps` replays, each from x0, are timed by CUDA events. Without, the
    chain runs eagerly `reps` times (the host clock on the CPU). Returns
    (the best seconds per call, x after one chain from x0)."""
    from ..serving.graphs import run_once
    from ..utils.profiling import event_times

    x = x0.clone()

    def chain():
        for i in range(iters):
            x.copy_(step(x, i))

    def once():
        run_once(graphs, ("chain", iters), chain, (x,))

    once()
    times = []
    for _ in range(reps):
        x.copy_(x0)
        times += event_times(once, 1, x.device)
    return min(times) / iters, x.clone()


def report(dev: torch.device, out: dict, before: dict) -> dict:
    """`out` with the device's name, its nvidia-smi line on the card, and
    each kernel's launches since `before` (a `counted_launches()`), printed
    as the one-line JSON dict that ends a tool's output."""
    from ..utils.profiling import nvidia_smi_line

    now = counted_launches()
    out = dict(out, device=device_name(dev),
               card=nvidia_smi_line() if dev.type == "cuda" else None,
               launches={k: now[k] - before[k] for k in now})
    print(json.dumps(out), flush=True)
    return out
