"""Which axis each weight splits on, and this rank's slice of it: a port of
kuiperllama_tpu/parallel/shardings.py.

Megatron tensor parallelism over the model axis:

  column-parallel (split out, axis -1): wq wk wv w1 w3 (and fused wqkv
                                        w13), the qkv biases, lm_head
  row-parallel    (split in, axis -2):  wo w2 (all-reduce after)
  replicated:                           norms, tok_emb
  KV cache:                             split over kv heads

Sequence parallelism (seqpar, page-sharded KV pool): the attention weights
replicate (each rank computes full q/k/v, writes whole lanes into its own
pages and merges full-head flash statistics); the MLP stays Megatron-split
and lm_head vocab-split.

`shard_params` returns this rank's slice of every leaf as its own
contiguous tensor: the kernels refuse strided operands. A row-parallel
QuantTensor [.., in, out] with scales [.., in // g, out] gives rank r the
q rows [r in/tp, (r+1) in/tp) and the scale rows of exactly those groups,
[r G/tp, (r+1) G/tp) of G = in // g. The JAX package shards the scale rows
it padded to a multiple of 16 (params.py with shardings.py `_ROW`), so its
rank 1 of a padded wo/w2 reads padding scales; the port keeps exactly
G rows and splits them with q.
"""

from __future__ import annotations

import warnings

from ..config import ModelConfig
from ..quant import QuantTensor
from .mesh import MODEL_AXIS

COL, ROW, REP = -1, -2, None

# leaf name -> split axis (None: replicated). Fused leaves come from
# fuse.fuse_params on a rank's slices, after the split.
_RULES = {
    "tok_emb": REP, "final_norm": REP, "lm_head": COL,
    "attn_norm": REP, "ffn_norm": REP,
    "wqkv": COL, "w13": COL, "bqkv": COL,
    "wq": COL, "wk": COL, "wv": COL, "w1": COL, "w3": COL,
    "wo": ROW, "w2": ROW,
    "bq": COL, "bk": COL, "bv": COL,
}

_RULES_SEQPAR = dict(
    _RULES, wqkv=REP, bqkv=REP, wq=REP, wk=REP, wv=REP, wo=REP,
    bq=REP, bk=REP, bv=REP)


def _group_size(params) -> int:
    """The group size of the first quantized projection (0 without one)."""
    for leaf in params["blocks"].values():
        if isinstance(leaf, QuantTensor):
            return leaf.group_size
    return 0


def validate_tp(cfg: ModelConfig, tp: int, group_size: int = 0):
    """Setup-time checks for tensor parallelism of degree tp; raises
    ValueError. group_size (of the INT8 weights, 0 for dense ones): the
    row-parallel wo and w2 must split into whole groups, (in / tp) % g == 0.
    A kv lane block that is not a multiple of 128 warns, as the JAX package
    warns off the TPU; the port's kernels run it."""
    if cfg.n_kv_heads % tp:
        raise ValueError(f"tensor-parallel degree {tp} must divide "
                         f"n_kv_heads={cfg.n_kv_heads}")
    for name in ("n_heads", "hidden_dim", "vocab_size"):
        if getattr(cfg, name) % tp:
            raise ValueError(f"tensor-parallel degree {tp} must divide "
                             f"{name}={getattr(cfg, name)}")
    if group_size:
        for name, n_in in (("wo", cfg.dim), ("w2", cfg.hidden_dim)):
            if (n_in // tp) % group_size:
                raise ValueError(
                    f"tp={tp} splits {name}'s {n_in} input rows into {n_in // tp} "
                    f"per rank, not a whole number of {group_size}-row scale "
                    f"groups ({n_in // group_size} groups over {tp} ranks); "
                    f"quantize with a group size that divides {n_in // tp}")
    local_lane = (cfg.n_kv_heads // tp) * cfg.head_dim
    if local_lane % 128:
        warnings.warn(
            f"tp={tp} leaves a per-rank KV lane dim of {local_lane} (= "
            f"n_kv_heads/tp * head_dim = {cfg.n_kv_heads}/{tp} * {cfg.head_dim}), "
            f"not a multiple of 128: the JAX package's compiled kernels need "
            f"128-aligned lanes (max tp there: "
            f"{max(1, cfg.n_kv_heads * cfg.head_dim // 128)}); the port's "
            f"kernels run it", UserWarning, stacklevel=2)


def validate_seqpar(cfg: ModelConfig, sp: int, group_size: int = 0):
    """Setup-time checks for sequence parallelism over sp ranks: the
    Megatron-split MLP and vocab dims must divide, w2 must split into whole
    scale groups. n_heads need not divide sp (attention is replicated).
    Column blocks that are not a multiple of 128 warn, as in validate_tp."""
    for name in ("hidden_dim", "vocab_size"):
        if getattr(cfg, name) % sp:
            raise ValueError(f"seqpar degree {sp} must divide "
                             f"{name}={getattr(cfg, name)}")
    if group_size and (cfg.hidden_dim // sp) % group_size:
        raise ValueError(f"sp={sp} splits w2's {cfg.hidden_dim} input rows "
                         f"into {cfg.hidden_dim // sp} per rank, not a whole "
                         f"number of {group_size}-row scale groups")
    for name, local in (("hidden_dim", cfg.hidden_dim // sp),
                        ("vocab_size", cfg.vocab_size // sp)):
        if local % 128:
            warnings.warn(
                f"seqpar sp={sp} leaves a per-rank {name} column dim of {local}, "
                f"not a multiple of 128: the JAX package's compiled kernels "
                f"need 128-lane column blocks; the port's kernels run it",
                UserWarning, stacklevel=2)


def _slice(x, axis, rank: int, n: int):
    """Rank `rank`'s contiguous 1/n of x along `axis` (-1 or -2)."""
    if axis is None or n == 1:
        return x
    if isinstance(x, QuantTensor):
        if axis == COL:
            return QuantTensor(q=_slice(x.q, COL, rank, n), s=_slice(x.s, COL, rank, n),
                               group_size=x.group_size)
        ng = x.q.shape[-2] // x.group_size  # exactly in // g scale rows
        return QuantTensor(q=_slice(x.q, ROW, rank, n),
                           s=_slice(x.s[..., :ng, :], ROW, rank, n),
                           group_size=x.group_size)
    size = x.shape[axis] // n
    return x.narrow(axis, rank * size, size).contiguous()


def leaf_axis(name: str, seqpar: bool = False):
    """The axis leaf `name` splits on (None: replicated)."""
    rules = _RULES_SEQPAR if seqpar else _RULES
    if name not in rules:
        raise ValueError(f"no sharding rule for param {name!r}")
    return rules[name]


def shard_params(params, mesh, cfg: ModelConfig, seqpar: bool = False):
    """This rank's slices of an UNFUSED params dict: contiguous tensors on
    the params' device (the full tensors are not kept). A host-fused wqkv
    would hand each rank a block of GLOBAL q|k|v columns, so fusion comes
    after, on the rank's slices: fuse.fuse_params. seqpar=True takes the sequence-parallel
    layout. Data ranks all hold the same weights."""
    if "wqkv" in params["blocks"]:
        raise ValueError("shard_params takes unfused params; fuse after sharding "
                         "with fuse.fuse_params on the rank's slices")
    n, rank = mesh.shape[MODEL_AXIS], mesh.tp_rank
    g = _group_size(params)
    if seqpar:
        validate_seqpar(cfg, n, g)
    else:
        validate_tp(cfg, n, g)
    out = {k: _slice(v, leaf_axis(k, seqpar), rank, n)
           for k, v in params.items() if k != "blocks"}
    out["blocks"] = {k: _slice(v, leaf_axis(k, seqpar), rank, n)
                     for k, v in params["blocks"].items()}
    return out
