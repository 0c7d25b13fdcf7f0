"""Carry weights across from the JAX package's params to the port's.

The JAX package keeps the same dict layout (stacked [L, in, out] weights,
fused or not) but stores quantized weights as QuantArray with scale rows
padded to a multiple of 16. `from_jax_params` takes that tree as numpy
arrays (or anything `np.asarray` reads, such as device arrays), with each
quantized leaf either a dict {q, s, group_size} or an object with those
attributes, and returns the port's params: QuantTensor leaves with exactly
in // g scale rows, in the scales' own dtype (fp32 or bf16).
"""

from __future__ import annotations

import numpy as np
import torch

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float64": torch.float32}


def _tensor(a, device, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    name = str(a.dtype)
    if name in _TORCH_DTYPES:
        # bf16 numpy arrays (ml_dtypes) have no torch.from_numpy; fp32 holds
        # every bf16 value exactly, so the trip through fp32 is lossless
        t = torch.from_numpy(np.array(a, np.float32))
        return t.to(device=device, dtype=dtype or _TORCH_DTYPES[name])
    return torch.from_numpy(np.array(a)).to(device)


def _quant_parts(x):
    if isinstance(x, dict) and {"q", "s", "group_size"} <= set(x):
        return x["q"], x["s"], x["group_size"]
    if all(hasattr(x, k) for k in ("q", "s", "group_size")):
        return x.q, x.s, x.group_size
    return None


def from_jax_params(tree, device="cuda", dtype=torch.float32):
    """JAX-package params -> port params on `device`.

    Dense float weights are cast to `dtype` except norm weights, which stay
    fp32 (the rule of `params.to_device`)."""
    from .quant import QuantTensor

    def convert(name, x):
        parts = _quant_parts(x)
        if parts is not None:
            q, s, g = parts
            q = _tensor(q, device)
            ng = q.shape[-2] // int(g)
            s = _tensor(np.asarray(s)[..., :ng, :], device)
            return QuantTensor(q=q, s=s, group_size=int(g))
        if str(np.asarray(x).dtype) in _TORCH_DTYPES:
            return _tensor(x, device, torch.float32 if "norm" in name else dtype)
        return _tensor(x, device)

    out = {}
    for key, val in tree.items():
        if key == "blocks":
            out[key] = {k: convert(k, v) for k, v in val.items()}
        else:
            out[key] = convert(key, val)
    return out
