"""Group-dequant INT8 matmul: the W8A16 GEMV and GEMM kernels and their
plain PyTorch versions.

Port of kuiperllama_tpu/ops/pallas/quant_matmul.py. Layout as in the JAX
package: q int8 [K, N] (a layer of a stacked [L, K, N] weight is a
zero-copy view), s [K // g, N] fp32 or bf16, groups along K. The CUDA
sources are csrc/quant_gemv.cu and csrc/quant_gemm.cu; each source's header
says what bounds it on the card and how its design deals with that.

Each wrapper takes its plain version for a tensor that lies on the CPU, and
for a CUDA tensor it launches its kernel or raises: there is no fallback.
`quant_gemv.launches` and `quant_gemm.launches` count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, workspace

GEMV_SOURCE = "quant_gemv"
GEMM_SOURCE = "quant_gemm"
MODES = ("fast", "exact")

# The GEMV stages bf16(x) for its K range in shared memory as fp32; this cap
# keeps that stage plus the 2 KB warp reduction under the 48 KB of static
# shared memory a launch gets without opting in to more.
_GEMV_MAX_STAGED_K = 8192
# The GEMV: 4 or 8 column threads of 16 columns a warp (`gemv_col_threads`)
# and up to 8 warps (one group each at a time) per block; the plan splits K
# until the grid gives every SM about this many blocks, by layout
# (chip_smoke.py's phase 3 sweeps 2, 4 and 8 for both: PERF.md).
_GEMV_BLOCKS_PER_SM = {4: 4, 8: 8}
_GEMV_WARPS = 8
_GEMV_MIN_WARPS_PER_SM = 8
# The GEMM's fast kernel: 128 weight columns and 8, 16, 32 or 64 x rows per
# block, 64 K rows per ring stage (a K split is a multiple of it); the plan
# splits K until the grid gives every SM about _GEMM_BLOCKS_PER_SM blocks,
# with at least _GEMM_MIN_SPLIT_K rows in each split.
_GEMM_BN = 128
_GEMM_BK = 64
_GEMM_BLOCKS_PER_SM = 3
_GEMM_MIN_SPLIT_K = 256

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int
_sm_count: dict = {}


def dequantize_bf16(q: torch.Tensor, s: torch.Tensor, g: int) -> torch.Tensor:
    """bf16(bf16(q) * bf16(s)) over [K, N]: the fast mode's weight rounding."""
    K, N = q.shape
    ng = K // g
    w = q.to(torch.bfloat16).reshape(ng, g, N) * s[:ng].to(torch.bfloat16)[:, None, :]
    return w.reshape(K, N)


# ---------------------------------------------------------------------------
# Plain versions (same rounding as the kernels; only fp32 summation order
# differs)


def quant_gemv_ref(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                   g: int) -> torch.Tensor:
    """x [1, K] -> [1, N]: per-group fp32 partials of bf16(x) against q, then
    the group scales in fp32 — the block-diagonal formulation of
    `_kernel_diag` / `_diag_gemv_xla`."""
    K, N = q.shape
    ng = K // g
    xb = x.reshape(ng, g).to(torch.bfloat16).float()
    P = torch.einsum("ig,ign->in", xb, q.reshape(ng, g, N).float())
    y = (P * s[:ng].float()).sum(dim=0, keepdim=True)
    return y.to(x.dtype)


def quant_gemm_ref(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, g: int,
                   mode: str = "fast") -> torch.Tensor:
    """x [M, K] -> [M, N] in the rounding of `_kernel`: fast = bf16 x against
    bf16(bf16(q) * bf16(s)) with fp32 accumulation; exact = all fp32."""
    K, N = q.shape
    if mode == "fast":
        w = dequantize_bf16(q, s, g).float()
        out = x.to(torch.bfloat16).float() @ w
    else:
        ng = K // g
        w = (q.float().reshape(ng, g, N) * s[:ng].float()[:, None, :]).reshape(K, N)
        out = x.float() @ w
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers


def _check(x, q, s, g, name):
    if not (x.is_cuda and q.device == x.device and s.device == x.device):
        raise ValueError(f"{name}: x, q and s must share one CUDA device "
                         f"(got {x.device}, {q.device}, {s.device})")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: x is on {x.device}, the current device "
                         f"is cuda:{torch.cuda.current_device()}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x must be fp32 or bf16, got {x.dtype}")
    if s.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: s must be fp32 or bf16, got {s.dtype}")
    if q.dtype != torch.int8:
        raise TypeError(f"{name}: q must be int8, got {q.dtype}")
    if x.dim() != 2 or q.dim() != 2 or s.dim() != 2:
        raise ValueError(f"{name}: x, q, s must be 2-D")
    K, N = q.shape
    if x.shape[1] != K or K % g or s.shape[0] < K // g or s.shape[1] != N:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, q {tuple(q.shape)}, "
                         f"s {tuple(s.shape)} do not fit group size {g}")
    if not (x.is_contiguous() and q.is_contiguous() and s.is_contiguous()):
        raise ValueError(f"{name}: x, q and s must be contiguous")


_GEMV_ARGS = [_c_void_p, _c_int, _c_void_p, _c_void_p, _c_int, _c_void_p,
              _c_void_p, _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int,
              _c_int, _c_void_p]
_GEMM_ARGS = [_c_void_p, _c_int, _c_void_p, _c_void_p, _c_int, _c_void_p,
              _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
              _c_int, _c_void_p]


def gemv_col_threads(K: int, N: int, g: int, sm_count: int, vec: bool = True) -> int:
    """Column threads per warp of the GEMV (16 contiguous bytes of a row
    each): 8, or 4 when 8 would leave fewer than _GEMV_MIN_WARPS_PER_SM
    one-group warps per SM (Llama-2-7B's wo). The ragged path takes 8."""
    if vec and -(-N // 128) * (K // g) < _GEMV_MIN_WARPS_PER_SM * sm_count:
        return 4
    return 8


def gemv_plan(K: int, N: int, g: int, sm_count: int,
              blocks_per_sm: int | None = None, col_threads: int = 8) -> int:
    """Groups per K split of the GEMV: enough splits that the grid of
    16 x col_threads-column tiles gives every SM `blocks_per_sm` blocks,
    whole groups per split, a multiple of the block's 8 warps once a split
    holds more than 8 groups (so that every warp walks as many groups), and
    a staged K range that fits the kernel's shared memory. blocks_per_sm
    None takes the layout's measured target."""
    ng = K // g
    blocks_per_sm = blocks_per_sm or _GEMV_BLOCKS_PER_SM[col_threads]
    tiles = -(-N // (16 * col_threads))
    splits = min(ng, max(1, -(-blocks_per_sm * sm_count // tiles)))
    gps = -(-ng // splits)
    if gps > _GEMV_WARPS:
        gps = -(-gps // _GEMV_WARPS) * _GEMV_WARPS
    return max(1, min(gps, ng, _GEMV_MAX_STAGED_K // g))


def gemm_block_rows(M: int) -> int:
    """x rows per block of the fast kernel: the smallest of 8, 16, 32 and
    64 that covers M (more rows take more blocks)."""
    return next((r for r in (8, 16, 32) if M <= r), 64)


def gemm_k_per_split(M: int, K: int, N: int, sm_count: int) -> int:
    """K rows per split: enough splits that the grid gives every SM
    _GEMM_BLOCKS_PER_SM blocks, at least _GEMM_MIN_SPLIT_K rows each, in
    whole ring stages of _GEMM_BK rows."""
    tiles = -(-N // _GEMM_BN) * -(-M // gemm_block_rows(M))
    splits = max(1, min(-(-_GEMM_BLOCKS_PER_SM * sm_count // tiles),
                        K // _GEMM_MIN_SPLIT_K))
    return -(-K // (splits * _GEMM_BK)) * _GEMM_BK


def _sms(device) -> int:
    n = _sm_count.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_count[device.index] = n
    return n


def _counters(device, n: int) -> torch.Tensor:
    """The GEMV's per-column-tile split counters: zero between launches (the
    kernel leaves them at zero), kept per device (ops/kernels/workspace.py)."""
    return workspace.scratch(device, "gemv_counters", n, torch.int32, zero=True)


def gemv_launch(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, g: int,
                gps: int | None = None, col_threads: int | None = None) -> torch.Tensor:
    """One launch of csrc/quant_gemv.cu on checked CUDA operands, uncounted:
    `quant_gemv` calls it with the plan's layout and split, and
    chip_smoke.py times other layouts and plans through it."""
    K, N = q.shape
    vec = N % 16 == 0 and q.data_ptr() % 16 == 0
    sms = _sms(x.device)
    ct = col_threads or gemv_col_threads(K, N, g, sms, vec)
    gps = gps or gemv_plan(K, N, g, sms, col_threads=ct)
    splits = -(-(K // g) // gps)
    y = torch.empty((1, N), dtype=x.dtype, device=x.device)
    partial = (torch.empty((splits, N), dtype=torch.float32, device=x.device)
               if splits > 1 else y)
    counters = _counters(x.device, -(-N // (16 * ct)))
    rc = build.entry(GEMV_SOURCE, GEMV_SOURCE, _GEMV_ARGS)(
        x.data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(),
        s.data_ptr(), int(s.dtype == torch.bfloat16), y.data_ptr(),
        partial.data_ptr(), counters.data_ptr(), K, N, g, gps, ct, int(vec),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quant_gemv: kernel launch failed, CUDA error {rc}")
    return y


def quant_gemv(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
               g: int) -> torch.Tensor:
    """x [1, K] @ dequant(q [K, N], s [K/g, N]) -> [1, N] in x's dtype."""
    if x.device.type == "cpu":
        return quant_gemv_ref(x, q, s, g)
    _check(x, q, s, g, "quant_gemv")
    if x.shape[0] != 1:
        raise ValueError(f"quant_gemv: x must have one row, got {tuple(x.shape)}")
    y = gemv_launch(x, q, s, g)
    quant_gemv.launches += 1
    return y


def quant_gemm(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, g: int,
               mode: str = "fast") -> torch.Tensor:
    """x [M, K] @ dequant(q [K, N], s [K/g, N]) -> [M, N] in x's dtype."""
    if mode not in MODES:
        raise ValueError(f"quant_gemm: mode must be one of {MODES}, got {mode!r}")
    if x.device.type == "cpu":
        return quant_gemm_ref(x, q, s, g, mode)
    _check(x, q, s, g, "quant_gemm")
    M = x.shape[0]
    K, N = q.shape
    kps = gemm_k_per_split(M, K, N, _sms(x.device))
    splits = -(-K // kps)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    partial = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
               if splits > 1 else y)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, q, s))
    rc = build.entry(GEMM_SOURCE, GEMM_SOURCE, _GEMM_ARGS)(
        x.data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(),
        s.data_ptr(), int(s.dtype == torch.bfloat16), y.data_ptr(),
        partial.data_ptr(), M, K, N, g, int(mode == "exact"), kps,
        int(aligned), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quant_gemm: kernel launch failed, CUDA error {rc}")
    quant_gemm.launches += 1
    return y


quant_gemv.launches = 0
quant_gemm.launches = 0
