"""Group-wise symmetric INT8 weight quantization (Q8_0).

Per-group scale = absmax / 127, groups of `group_size` consecutive elements
along the reduction dimension. Weights are stored `[in, out]` (the hot op is
`x @ W`) with groups along `in` (axis -2), so a weight `[in, out]` has scales
`[in // g, out]` — exactly `in // g` rows: no padding rows, unlike the JAX
package, whose TPU kernels needed the scale rows padded to a multiple of 16.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class QuantTensor:
    """int8 values + group scales. Groups run along axis -2 (the `in` dim).

    q: int8          [..., in, out]
    s: fp32 or bf16  [..., in // group_size, out]
    """

    q: torch.Tensor
    s: torch.Tensor
    group_size: int = 64

    @property
    def shape(self):
        return self.q.shape

    def __getitem__(self, layer) -> "QuantTensor":
        """Layer `layer` of a stacked [L, in, out] weight: zero-copy views."""
        return QuantTensor(q=self.q[layer], s=self.s[layer],
                           group_size=self.group_size)


def quantize_q80(w, group_size: int = 64, axis: int = -2) -> QuantTensor:
    """Quantize `w` into (int8, fp32 scales) with groups along `axis`.

    Rounds half to even (`torch.round`), as `jnp.round` does, so int8 values
    and scales are bit-equal to the JAX package's `quantize_q80`."""
    w = torch.as_tensor(w, dtype=torch.float32)
    axis = axis % w.ndim
    assert w.shape[axis] % group_size == 0, (tuple(w.shape), axis, group_size)
    ng = w.shape[axis] // group_size
    new_shape = w.shape[:axis] + (ng, group_size) + w.shape[axis + 1:]
    wg = w.reshape(new_shape)
    absmax = wg.abs().amax(dim=axis + 1, keepdim=True)
    scale = absmax / 127.0
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(wg / safe), -127, 127).to(torch.int8)
    return QuantTensor(q=q.reshape(w.shape), s=scale.squeeze(axis + 1),
                       group_size=group_size)


def dequantize(qt: QuantTensor) -> torch.Tensor:
    """float = int8 * group_scale, in fp32."""
    g = qt.group_size
    q = qt.q
    ng = q.shape[-2] // g
    qg = q.reshape(q.shape[:-2] + (ng, g) + q.shape[-1:]).float()
    s = qt.s[..., :ng, :].float()[..., :, None, :]
    return (qg * s).reshape(q.shape)


def cast_scales(params, dtype=torch.bfloat16):
    """Cast every QuantTensor's scales in a params dict to `dtype`.

    bf16 scales cost nothing in fast mode (the kernels round the scales to
    bf16 before the multiply anyway) and halve the scale stream."""
    def f(x):
        if isinstance(x, QuantTensor):
            return QuantTensor(q=x.q, s=x.s.to(dtype), group_size=x.group_size)
        if isinstance(x, dict):
            return {k: f(v) for k, v in x.items()}
        return x

    return f(params)


# ---- numpy-side helper used by the checkpoint writer


def quantize_q80_np(w: np.ndarray, group_size: int = 64):
    """Row-major Q8_0 as the llama2.c exporter lays it out on disk: `w` is the
    file-orientation [out, in] matrix; groups are consecutive elements of the
    flattened row-major array. Returns (int8 flat, fp32 scales, max error).

    Requires in % group_size == 0 so that groups align to the reduction dim.
    """
    assert w.ndim == 1 or w.shape[-1] % group_size == 0, (w.shape, group_size)
    flat = np.asarray(w, np.float32).reshape(-1, group_size)
    absmax = np.abs(flat).max(axis=1)
    scale = absmax / 127.0
    safe = np.where(scale == 0.0, 1.0, scale)
    q = np.clip(np.round(flat / safe[:, None]), -127, 127).astype(np.int8)
    err = np.abs(q.astype(np.float32) * safe[:, None] - flat).max() if flat.size else 0.0
    return q.reshape(-1), scale.astype(np.float32), float(err)
