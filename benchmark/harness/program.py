"""The program under test, `kuiperllama_tpu_torch`, as the drivers take it:
its model configuration and weights built from the benchmark's own, by the
family's adapter (`adapters/<family>.py`, found by name beside the
harness), and the counters and span records it keeps (kernel launches,
graph captures, `kt.*` spans)."""

from __future__ import annotations

import torch

from benchmark.harness import spec
from kuiperllama_tpu_torch.serving import graphs
from kuiperllama_tpu_torch.serving.generate import _bucket, _bucket_len
from kuiperllama_tpu_torch.utils import profiling


def adapter(family: str):
    """adapters/<family>.py."""
    return spec.family_module("adapters", family)


def model_config(config: dict, seq_len: int):
    """The port's ModelConfig of a benchmark configuration; `seq_len` is the
    cell's context (the rope table's length)."""
    return adapter(config["benchmark"]["family"]).model_config(config, seq_len)


def params(raw: dict) -> dict:
    """The port's params from the benchmark's raw weights (harness/weights.py
    `make`), which take the raw tensors over."""
    return adapter(raw["family"]).params(raw)


def prompt_bucket(n: int, limit: int) -> int:
    """The rows a prefill of an n-token prompt pads to, as the Generator and
    the engine pad them (for planning the warm-up)."""
    return min(_bucket(n), limit)


def attention_window(n: int, limit: int) -> int:
    """The Generator's attention window over n cached positions."""
    return min(_bucket_len(n), limit)


def counters() -> dict:
    """Every counted kernel's launches so far, by wrapper name."""
    return {w.__name__: w.launches for w in graphs.counted_kernels()}


def span_records() -> list:
    """The program's span records so far ([] where it keeps none)."""
    get = getattr(profiling, "spans", None)
    return [] if get is None else get()


def graph_captures(cache) -> int:
    """Decode and prefill captures of a GraphCache so far (0 without one)."""
    if cache is None:
        return 0
    st = cache.stats()
    return st["n_captures"] + st["n_prefill_captures"]


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
