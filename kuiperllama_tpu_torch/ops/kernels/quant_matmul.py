"""Group-dequant INT8 matmul: the W8A16 GEMV and GEMM kernels and their
plain PyTorch versions.

Port of kuiperllama_tpu/ops/pallas/quant_matmul.py. Layout as in the JAX
package: q int8 [K, N] (a layer of a stacked [L, K, N] weight is a
zero-copy view), s [K // g, N] fp32 or bf16, groups along K. The CUDA
sources are csrc/quant_gemv.cu and csrc/quant_gemm.cu; each source's header
says what bounds it on the card and how its design deals with that.

Each wrapper takes its plain version for a tensor that lies on the CPU, and
for a CUDA tensor it launches its kernel or raises: there is no fallback.
`quant_gemv.launches` and `quant_gemm.launches` count kernel launches. The
GEMM's fast mode has two kernels, chosen by shape before the launch
(`gemm_route`): the wgmma route (TMA, an mbarrier ring and wgmma, every
weight byte read and dequantized once per call) for every aligned shape of
the supported models, counted again in `quant_gemm.wgmma_launches`, and
the mma.sync route for the rest. The wgmma kernel takes bf16 x: an fp32 x
is rounded to bf16 first, one more launch, counted in
`quant_gemm.x_roundings`.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, workspace

GEMV_SOURCE = "quant_gemv"
GEMM_SOURCE = "quant_gemm"
MODES = ("fast", "exact")
GEMM_ROUTES = ("wgmma", "mma_sync")

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
# The wgmma route: 128 weight columns of every row (at most 256) per block,
# 64 K rows per ring stage; rows round up to 8 (wgmma's N). Its plan weighs
# whole waves of blocks (two an SM up to 64 rows, else one) against the
# fp32 partials a split writes and the split sum re-reads, by the card's
# data-sheet rates, a fixed ring fill per wave and the sum's launch.
_WGMMA_MAX_ROWS = 256
_WGMMA_SMALL_ROWS = 64
_WGMMA_BN = 128
_WGMMA_BK = 64
_WGMMA_MIN_SPLIT_K = 256
_HBM_BYTES_PER_S = 3.35e12
_BF16_OPS_PER_S = 989e12
_WAVE_FILL_S = 1e-6
_SUM_LAUNCH_S = 2e-6

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
_WGMMA_ARGS = [_c_void_p, _c_void_p, _c_void_p, _c_int, _c_void_p, _c_int,
               _c_void_p, _c_int, _c_int, _c_int, _c_int, _c_int, _c_void_p]
_INT_P = ctypes.POINTER(ctypes.c_int)


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


def takes_wgmma(M: int, K: int, N: int, g: int, mode: str = "fast",
                aligned: bool = True) -> bool:
    """Whether a GEMM call takes the wgmma route: fast mode, at most 256
    rows, x, q and s 16-byte aligned (`aligned`), rows of 16-byte multiples
    for TMA (N % 16 == 0, K % 8 == 0) and a group size that is a multiple of
    16 and divides 64 or is divided by it (a ring stage of 64 K rows then
    holds whole groups or lies in one)."""
    g_ok = g % 16 == 0 and (_WGMMA_BK % g == 0 or g % _WGMMA_BK == 0)
    return (mode == "fast" and 1 <= M <= _WGMMA_MAX_ROWS and aligned
            and N % 16 == 0 and K % 8 == 0 and K % g == 0 and g_ok)


def gemm_route(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, g: int,
               mode: str = "fast") -> str:
    """The GEMM kernel a call takes, from its shapes and pointers alone."""
    K, N = q.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, q, s))
    return "wgmma" if takes_wgmma(x.shape[0], K, N, g, mode, aligned) else "mma_sync"


def wgmma_plan_cost(M: int, K: int, N: int, sm_count: int, k_per_split: int) -> float:
    """The plan's model of a call's seconds at a split of k_per_split rows:
    whole waves of blocks, each block's time the larger of its weight bytes
    and its operations at its share of the card, plus a ring fill a wave;
    then, with more than one split, the fp32 partials written and read
    again and the split sum's launch."""
    nw = -(-M // 8) * 8
    # blocks an SM holds: two up to 64 rows, else one (csrc/quant_gemm.cu
    # kTmaMinBlocks)
    slots = sm_count * (2 if M <= _WGMMA_SMALL_ROWS else 1)
    splits = -(-K // k_per_split)
    waves = -(-(-(-N // _WGMMA_BN) * splits) // slots)
    block = max(k_per_split * _WGMMA_BN / (_HBM_BYTES_PER_S / slots),
                2.0 * nw * k_per_split * _WGMMA_BN / (_BF16_OPS_PER_S / slots))
    cost = waves * (block + _WAVE_FILL_S)
    if splits > 1:
        cost += 2 * 4 * splits * M * N / _HBM_BYTES_PER_S + _SUM_LAUNCH_S
    return cost


def gemm_wgmma_plan(M: int, K: int, N: int, sm_count: int) -> int:
    """K rows per split of the wgmma route: whole ring stages, at least
    _WGMMA_MIN_SPLIT_K rows a split (unless K is shorter), fp32 partials
    (4 * splits * M * N bytes) no more than the weight's K * N bytes, and of
    those the split with the least `wgmma_plan_cost` (the fewest splits on
    a tie)."""
    most = max(1, min(K // _WGMMA_MIN_SPLIT_K, K // (4 * M)))
    best = None
    for splits in range(1, most + 1):
        kps = -(-K // (splits * _WGMMA_BK)) * _WGMMA_BK
        cost = wgmma_plan_cost(M, K, N, sm_count, kps)
        if best is None or cost < best[0]:
            best = (cost, kps)
    return best[1]


def wgmma_geometry(M: int, K: int, g: int, s_bf16: bool, k_per_split: int) -> dict:
    """The wgmma kernel's geometry for a call, from its C entry: rows
    (wgmma's N), ring stages, bytes a stage, blocks an SM and dynamic shared
    bytes."""
    out = (ctypes.c_int * 5)()
    build.entry(GEMM_SOURCE, "quant_gemm_tma_plan",
                [_c_int, _c_int, _c_int, _c_int, _c_int, _INT_P])(
        M, K, g, int(s_bf16), k_per_split, out)
    return dict(zip(("rows", "stages", "stage_bytes", "blocks_per_sm", "smem_bytes"),
                    list(out)))


def wgmma_attributes(rows: int) -> dict:
    """Registers a thread and local (spilled) bytes of the wgmma kernel for
    `rows` x rows (wgmma's N: a multiple of 8 up to 256; one kernel each),
    from cudaFuncGetAttributes."""
    regs, local = ctypes.c_int(), ctypes.c_int()
    rc = build.entry(GEMM_SOURCE, "quant_gemm_tma_attributes", [_c_int, _INT_P, _INT_P])(
        rows, ctypes.byref(regs), ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"quant_gemm_tma_attributes: CUDA error {rc}")
    return dict(registers=regs.value, local_bytes=local.value)


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


def gemm_launch(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, g: int,
                route: str | None = None, mode: str = "fast",
                k_per_split: int | None = None) -> torch.Tensor:
    """One call of csrc/quant_gemm.cu on checked CUDA operands, uncounted:
    `quant_gemm` calls it with the route and plan that the shapes pick, and
    chip_smoke.py and the tools time either route or another split
    (`k_per_split`) through it. A route the shapes do not allow raises."""
    M = x.shape[0]
    K, N = q.shape
    route = route or gemm_route(x, q, s, g, mode)
    if route not in GEMM_ROUTES:
        raise ValueError(f"quant_gemm: route must be one of {GEMM_ROUTES}, got {route!r}")
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, q, s))
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if route == "wgmma":
        if not takes_wgmma(M, K, N, g, mode, aligned):
            raise ValueError(f"quant_gemm: the wgmma route does not take M {M}, K {K}, "
                             f"N {N}, g {g}, mode {mode}, aligned {aligned}")
        kps = k_per_split or gemm_wgmma_plan(M, K, N, _sms(x.device))
    else:
        kps = k_per_split or gemm_k_per_split(M, K, N, _sms(x.device))
    splits = -(-K // kps)
    partial = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
               if splits > 1 else y)
    if route == "wgmma":
        xb = x if x.dtype == torch.bfloat16 else x.to(torch.bfloat16)
        rc = build.entry(GEMM_SOURCE, "quant_gemm_tma", _WGMMA_ARGS)(
            xb.data_ptr(), q.data_ptr(), s.data_ptr(), int(s.dtype == torch.bfloat16),
            y.data_ptr(), int(y.dtype == torch.bfloat16), partial.data_ptr(), M, K, N,
            g, kps, stream)
    else:
        rc = build.entry(GEMM_SOURCE, GEMM_SOURCE, _GEMM_ARGS)(
            x.data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(),
            s.data_ptr(), int(s.dtype == torch.bfloat16), y.data_ptr(),
            partial.data_ptr(), M, K, N, g, int(mode == "exact"), kps,
            int(aligned), stream)
    if rc != 0:
        raise RuntimeError(f"quant_gemm: {route} kernel launch failed, CUDA error {rc}")
    return y


def quant_gemm(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, g: int,
               mode: str = "fast") -> torch.Tensor:
    """x [M, K] @ dequant(q [K, N], s [K/g, N]) -> [M, N] in x's dtype."""
    if mode not in MODES:
        raise ValueError(f"quant_gemm: mode must be one of {MODES}, got {mode!r}")
    if x.device.type == "cpu":
        return quant_gemm_ref(x, q, s, g, mode)
    _check(x, q, s, g, "quant_gemm")
    route = gemm_route(x, q, s, g, mode)
    y = gemm_launch(x, q, s, g, route, mode)
    quant_gemm.launches += 1
    if route == "wgmma":
        quant_gemm.wgmma_launches += 1
        quant_gemm.x_roundings += int(x.dtype != torch.bfloat16)
    return y


quant_gemv.launches = 0
quant_gemm.launches = quant_gemm.wgmma_launches = quant_gemm.x_roundings = 0
