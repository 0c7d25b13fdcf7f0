"""Every collective the port issues, counted: the counterpart of
kuiperllama_tpu/parallel/hlo.py.

The JAX package reads its collective bill out of the compiled HLO. Torch has
no HLO, so the port's models call these two functions and nothing else:

  all_reduce(x, group)          sum over the model group (after the
                                row-parallel wo and w2)
  all_gather(x, group, dim=-1)  concatenate the group's pieces along `dim`,
                                in group-rank order (the vocab-sharded
                                logits; seqpar's flash statistics, stacked
                                on a new leading dim)

Each counts its calls (`.launches`) and payload bytes (`.bytes`, the
result's size, as the JAX bill counts a collective's result) and the host
seconds spent inside it (`.seconds`). A replayed CUDA graph adds the calls
and bytes it captured (serving/graphs.py), so the counts hold on both
routes. There is no combiner: a decode step issues exactly 2 L all-reduces
and 1 all-gather, where the JAX bill allows XLA to merge the two per layer.
The all-reduced partials cross in models/decoder.py `partial_dtype`: fp32
where the INT8 kernels run across two or more ranks, else the activation
dtype.

Routes, by the group's backend: NCCL takes the CUDA tensor on the current
stream, so a CUDA graph can capture it. Gloo takes the CUDA tensor too
(PyTorch 2.11's ProcessGroupGloo copies it through the host itself) and
blocks the host; the wrapper synchronises the device first, so `.seconds`
holds the copies and the exchange, not the wait for queued kernels. A group
of None issues nothing and counts nothing. A failed collective raises;
nothing retries or changes backend.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist


def _start(x: torch.Tensor, group) -> float:
    """The wrapper's clock start; a gloo collective on a CUDA tensor first
    waits for the kernels queued before it."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        torch.cuda.current_stream(x.device).synchronize()
    return time.perf_counter()


def _count(fn, out: torch.Tensor, t0: float):
    fn.launches += 1
    fn.bytes += out.numel() * out.element_size()
    fn.seconds += time.perf_counter() - t0


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over `group`, in x's dtype, IN PLACE: x (a fresh,
    contiguous product) is overwritten and returned."""
    if group is None:
        return x
    t0 = _start(x, group)
    dist.all_reduce(x, group=group)
    _count(all_reduce, x, t0)
    return x


def all_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The group's pieces of `x` concatenated along `dim` in group-rank
    order (every rank's piece has x's shape)."""
    if group is None:
        return x
    t0 = _start(x, group)
    src = x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    _count(all_gather, out, t0)
    return out


def counted():
    """The counted collectives (each with `.launches`, `.bytes`, `.seconds`)."""
    return (all_reduce, all_gather)


def reset():
    for fn in counted():
        fn.launches, fn.bytes, fn.seconds = 0, 0, 0.0


reset()


def bill() -> dict:
    """Calls, payload bytes and host seconds per collective since `reset`,
    under the JAX bill's op names."""
    return {"all-reduce": dict(count=all_reduce.launches, bytes=all_reduce.bytes,
                               seconds=all_reduce.seconds),
            "all-gather": dict(count=all_gather.launches, bytes=all_gather.bytes,
                               seconds=all_gather.seconds)}


def analytic_decode_bill(cfg, batch: int, act_itemsize: int,
                         seqpar_shards: int = 0) -> dict:
    """The collectives one decode step must issue on each rank of the model
    group, for `batch` rows on this rank. Tensor parallelism: 2 L
    all-reduces of [B, 1, dim] (after wo and w2; `act_itemsize` is the
    exchanged partials' element size, models/decoder.py `partial_dtype`'s)
    and one all-gather of the [B, 1, vocab] fp32 logits. Seqpar over
    `seqpar_shards` ranks: wo is replicated, so L all-reduces (after w2),
    and each layer gathers its flash statistics (acc, m, l packed as
    [B, H, hd + 2] fp32, stacked to [sp, B, H, hd + 2]): 1 + L all-gathers."""
    L, B, d = cfg.n_layers, batch, cfg.dim
    logits = B * cfg.vocab_size * 4
    if not seqpar_shards:
        return {"all-reduce": dict(count=2 * L, bytes=2 * L * B * d * act_itemsize),
                "all-gather": dict(count=1, bytes=logits)}
    stats = L * seqpar_shards * B * cfg.n_heads * (cfg.head_dim + 2) * 4
    return {"all-reduce": dict(count=L, bytes=L * B * d * act_itemsize),
            "all-gather": dict(count=1 + L, bytes=logits + stats)}


def decode_step_bill(cfg, mesh, params, batch: int = 2, cache_len: int = 32,
                     dtype=torch.float32) -> dict:
    """Run one sharded decode step of `batch` rows on this rank (every rank
    of the mesh must call it) and return its counted collectives beside the
    analytic bill, in the shape of the JAX `decode_step_bill`:
    {"emitted": {op: {count, bytes, seconds}}, "analytic": {...}}. params:
    the full, unfused weights, on the device the step runs on."""
    from ..models import decoder
    from .sharded import ShardedForward
    from .shardings import shard_params

    dev = params["tok_emb"].device
    fwd = ShardedForward(cfg, mesh, params)
    sp = shard_params(params, mesh, cfg)
    cache = fwd.init_cache(batch=batch, max_len=cache_len, dtype=dtype, device=dev)
    tok = torch.zeros((batch,), dtype=torch.int32, device=dev)
    pos = torch.full((batch,), 3, dtype=torch.int32, device=dev)
    reset()
    decoder.decode_step(cfg, sp, tok, pos, cache, forward_fn=fwd)
    emitted = {op: e for op, e in bill().items() if e["count"]}
    local = batch // mesh.dp
    itemsize = decoder.partial_dtype(sp["blocks"]["w2"], local, sp["tok_emb"].dtype,
                                     mesh.model_group).itemsize
    analytic = analytic_decode_bill(cfg, local, itemsize)
    analytic.update(
        all_reduce_bytes_per_body=2 * local * cfg.dim * itemsize,
        all_reduce_bytes_per_step=analytic["all-reduce"]["bytes"],
        all_gather_bytes=analytic["all-gather"]["bytes"],
        bodies_per_step=cfg.n_layers)
    return {"emitted": emitted, "analytic": analytic}
