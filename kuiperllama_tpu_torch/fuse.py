"""Weight fusion: wq|wk|wv -> wqkv and w1|w3 -> w13 (plus bq|bk|bv -> bqkv).

Concatenating along the output dim turns five projections per layer into
two with identical math; the decoder slices the outputs back apart. Groups
run along `in`, so concatenating QuantTensors along `out` keeps every group
intact.

Under tensor parallelism a rank fuses its OWN slices
(parallel/shardings.shard_params first, then `fuse_params`), the port of
the JAX `fuse_params_sharded`: column-splitting a global q|k|v would hand
each rank columns of the wrong heads, while fusing the local slices gives
the global view [q_0|k_0|v_0 | q_1|k_1|v_1 | ...] that the decoder's
local-shape splits expect. Under seqpar the attention weights are whole on
every rank and fuse whole.
"""

from __future__ import annotations

import torch

from .quant import QuantTensor


def _concat_out(ws):
    """Concat weights along the last (out) axis; handles QuantTensor."""
    if isinstance(ws[0], QuantTensor):
        g = ws[0].group_size
        assert all(w.group_size == g for w in ws)
        return QuantTensor(q=torch.cat([w.q for w in ws], dim=-1),
                           s=torch.cat([w.s for w in ws], dim=-1),
                           group_size=g)
    return torch.cat(ws, dim=-1)


def fuse_params(params):
    """Return a params dict with fused qkv and gate/up projections. The
    unfused tensors are dropped from the returned dict."""
    blocks = dict(params["blocks"])
    blocks["wqkv"] = _concat_out([blocks.pop("wq"), blocks.pop("wk"),
                                  blocks.pop("wv")])
    blocks["w13"] = _concat_out([blocks.pop("w1"), blocks.pop("w3")])
    if "bq" in blocks:
        blocks["bqkv"] = torch.cat(
            [blocks.pop("bq"), blocks.pop("bk"), blocks.pop("bv")], dim=-1)
    out = dict(params)
    out["blocks"] = blocks
    return out

