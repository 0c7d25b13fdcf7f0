"""Linear projection with optional group-wise INT8 weights.

INT8 routing mirrors the JAX package's `ops/linear.py` exactly, because the
route decides the rounding:
  * rows >= PREFILL_DEQUANT_ROWS: dequantize the weight to bf16 once and take
    one plain matmul (the JAX package does this in XLA, outside any kernel);
  * rows == 1, fast mode, K // g <= GEMV_MAX_GROUPS: the GEMV kernel;
  * every other INT8 case: the GEMM kernel.
"""

from __future__ import annotations

import torch

from ..quant import QuantTensor
from .kernels.quant_matmul import dequantize_bf16, quant_gemm, quant_gemv

# kuiperllama_tpu/ops/linear.py `_XLA_PREFILL_M`
PREFILL_DEQUANT_ROWS = 256
# kuiperllama_tpu/ops/pallas/quant_matmul.py `_DIAG_MAX_GROUPS`
GEMV_MAX_GROUPS = 64


def _dequant_dot(x2: torch.Tensor, w: QuantTensor) -> torch.Tensor:
    """Large-M path: bf16(x) @ bf16-dequantized w with fp32 accumulation,
    rounded once to x's dtype. A bf16 x takes one bf16 matmul (fp32
    accumulation inside); an fp32 x multiplies the bf16-rounded operands
    in fp32."""
    wd = dequantize_bf16(w.q, w.s, w.group_size)
    if x2.dtype == torch.bfloat16:
        return x2 @ wd
    return (x2.to(torch.bfloat16).float() @ wd.float()).to(x2.dtype)


def _quant_linear(x: torch.Tensor, w: QuantTensor, mode: str) -> torch.Tensor:
    K, N = w.q.shape
    g = w.group_size
    x2 = x.reshape(-1, K).contiguous()
    rows = x2.shape[0]
    if rows >= PREFILL_DEQUANT_ROWS:
        out = _dequant_dot(x2, w)
    elif (rows == 1 and mode == "fast" and K % g == 0
          and K // g <= GEMV_MAX_GROUPS):
        out = quant_gemv(x2, w.q, w.s, g)
    else:
        out = quant_gemm(x2, w.q, w.s, g, mode)
    return out.reshape(*x.shape[:-1], N)


def linear(x: torch.Tensor, w, bias=None, mode: str = "fast") -> torch.Tensor:
    """x: [..., in]; w: [in, out] tensor or QuantTensor; bias: [out] or None.
    mode ("fast" | "exact") selects the INT8 kernels' rounding."""
    if isinstance(w, QuantTensor):
        out = _quant_linear(x, w, mode)
    else:
        out = torch.matmul(x, w.to(x.dtype))
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def linear_layered(x: torch.Tensor, w, layer: int, bias=None,
                   mode: str = "fast") -> torch.Tensor:
    """linear() against layer `layer` of a stacked weight [L, in, out]. The
    layer of a contiguous stack is a zero-copy view, so no weight is copied."""
    return linear(x, w[layer], None if bias is None else bias[layer], mode)
