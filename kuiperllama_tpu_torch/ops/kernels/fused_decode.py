"""The B = 1 decode megakernel: one launch per decode step for the whole
layer stack, its routing plan and its plain PyTorch version.

Port of kuiperllama_tpu/ops/pallas/fused_decode.py (`_kernel`, entry
`fused_decode_step`). The CUDA source is csrc/fused_decode.cu; its header
says what bounds it on the card and how its design deals with that.

Contract (as `fused_decode_step` in the JAX package): x0 [1, d] embedding
row, caches [L, A, KH*hd] (a view of a longer cache is fine: the layer
stride is free, rows must be contiguous), pos a one-element int32 tensor
with pos < A. Returns (x_final [1, d] in x0's dtype, final-normed and
before the lm_head, k_cache, v_cache). The new K/V rows are written at slot
`pos` IN PLACE; attention reads only slots < pos and merges the new token's
score analytically, as the JAX kernel does.

Traps this module keeps:
  * Rounding follows the route. The megakernel rounds activations to bf16
    even when the params are fp32 (the JAX `_rmsnorm` and the projection
    casts), so it does not agree bit for bit with the layered decoder; each
    route is held against its own JAX counterpart.
  * Group rows follow the JAX package's padded scales. The port keeps
    exactly K/g scale rows, but the JAX megakernel reads its row count from
    padded arrays: 16-row padding for wqkv, wo, w13 (`params.to_device`)
    and ceil((hidden/NT)/g / 8) * 8 rows for a w2 tile. The int8-activation
    rule and the plan's byte count use those padded counts, or the port
    could pick another activation type (K/g from 17 to 31) or another NT.
  * The attention window A is the Generator's bucketed length; the kernel
    reads pos from device memory, so no step syncs with the host.

On the CPU `fused_decode_step` runs the plain version; on a CUDA tensor it
launches the kernel or raises. `fused_decode_step.launches` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from ...quant import QuantTensor
from ..rope import apply_rope
from ..tuning import gemv_int8_auto
from . import build
from .quant_matmul import _sms

SOURCE = "fused_decode"

# The JAX plan's numbers (fused_decode.py `_VMEM_LIMIT`, `plan_tiles`). On
# the TPU they budget VMEM; here they are the routing rule that decides
# which models take the megakernel and the FFN tile count NT, which sets the
# w2 tile's group rows and with them the activation type of that GEMV.
_VMEM_LIMIT = 116 * 1024 * 1024
_SCALE_ROW_QUANTUM = 16  # kuiperllama_tpu/params.py `_round_up_srows`
_W2_TILE_ROW_QUANTUM = 8  # fused_decode.py `ngt_p`

# Kernel geometry; csrc/fused_decode.cu has the same constants.
_THREADS = 256
_MAX_BLOCKS_PER_SM = 2
_DENSE_UNIT_ROWS = 64  # K split quantum for dense weights
_RED_FLOATS = 4096  # k-lane reduction buffer (256 threads x 16 columns)

_c_void_p, _c_int, _c_float, _c_ll = (ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_float, ctypes.c_longlong)


# ---------------------------------------------------------------------------
# Rope and the plan (shared by the kernel and the plain version)


def rope_matrix(sin_row: torch.Tensor, cos_row: torch.Tensor, style: str,
                hd: int) -> torch.Tensor:
    """[hd, hd] fp32 rotation R with y = x @ R == ops.rope.apply_rope(x) for
    one position (sin_row/cos_row: [hd // 2] fp32). Every output element is
    a sum of exactly two products, the two that apply_rope forms; the kernel
    and the plain version apply those products directly."""
    h2 = hd // 2
    R = torch.zeros((hd, hd), dtype=torch.float32, device=sin_row.device)
    j = torch.arange(h2, device=sin_row.device)
    sin_row, cos_row = sin_row.float(), cos_row.float()
    if style == "half":
        R[j, j] = cos_row
        R[j + h2, j + h2] = cos_row
        R[j + h2, j] = -sin_row
        R[j, j + h2] = sin_row
    else:  # interleaved (llama2.c adjacent pairs)
        R[2 * j, 2 * j] = cos_row
        R[2 * j + 1, 2 * j + 1] = cos_row
        R[2 * j + 1, 2 * j] = -sin_row
        R[2 * j, 2 * j + 1] = sin_row
    return R


def padded_groups(rows: int, multiple: int = _SCALE_ROW_QUANTUM) -> int:
    """A scale-row count rounded up as the JAX package pads it."""
    return -(-rows // multiple) * multiple


def _kn(w):
    """(K, N) of one layer of a stacked [L, K, N] weight."""
    return tuple(w.shape[-2:])


def _layer_bytes(w) -> int:
    """Bytes of one layer of a stacked weight, as the JAX plan counts them:
    int8 payload plus scale rows padded to 16."""
    K, N = _kn(w)
    if isinstance(w, QuantTensor):
        rows = padded_groups(K // w.group_size)
        return K * N + rows * N * w.s.element_size()
    return K * N * w.element_size()


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype, device="meta").element_size()


def plan_tiles(blocks, cache_dtype=torch.bfloat16, active_len: int = 1024):
    """The FFN tile count NT of the JAX megakernel's plan, or None when the
    model does not take the megakernel. The rule of the JAX `plan_tiles`
    without its Mosaic-only 128-lane rule for NT = 1 (the JAX interpreter on
    the CPU drops it too, and every real model passes it) and without the
    KT_MIN_NT knob. Reads only shapes and dtypes, so shape-only stand-ins
    (tensors on the "meta" device) do."""
    if "wqkv" not in blocks or "w13" not in blocks:
        return None
    w2 = blocks["w2"]
    quant = isinstance(w2, QuantTensor)
    hidden = _kn(w2)[0]
    if quant and hidden % w2.group_size:
        return None
    attn = _layer_bytes(blocks["wqkv"]) + _layer_bytes(blocks["wo"])
    ffn = _layer_bytes(blocks["w13"]) + _layer_bytes(w2)
    kv_lane = _kn(blocks["wo"])[0]  # = d; slab lanes = KH*hd <= d
    slab = active_len * kv_lane * _itemsize(cache_dtype)
    budget = int(_VMEM_LIMIT * 0.78)
    fallback = None
    for nt in (1, 2, 4, 8):
        if hidden % nt:
            continue
        if nt > 1 and (hidden // nt) % 128:
            continue
        if quant and (hidden // nt) % w2.group_size:
            continue
        est = 2 * (attn + ffn // nt + 2 * slab)
        if est > budget:
            continue
        if est <= budget * 63 // 100:
            return nt
        if fallback is None:
            fallback = nt
    return fallback


def fits_vmem(blocks, cache_dtype=torch.bfloat16, active_len: int = 1024) -> bool:
    """Whether the model takes the megakernel (the JAX package's name; on
    the card it is the routing rule, not a memory budget)."""
    return plan_tiles(blocks, cache_dtype, active_len) is not None


def gemv_int8_flags(blocks, n_tiles: int):
    """Activation type of each megakernel GEMV (qkv, wo, gate/up, w2): True
    for the int8 activation. Keyed on the JAX package's padded group rows."""
    if not isinstance(blocks["w2"], QuantTensor):
        return (False, False, False, False)
    rows = [padded_groups(_kn(blocks[n])[0] // blocks[n].group_size)
            for n in ("wqkv", "wo", "w13")]
    w2 = blocks["w2"]
    ht = _kn(w2)[0] // n_tiles
    rows.append(padded_groups(ht // w2.group_size, _W2_TILE_ROW_QUANTUM))
    return tuple(gemv_int8_auto(r) for r in rows)


# ---------------------------------------------------------------------------
# Plain version: the JAX kernel's rounding points, step by step in torch ops


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _rmsnorm_bf16(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 rmsnorm of [d], rounded to bf16 (the JAX kernel's `_rmsnorm`)."""
    ms = (x * x).mean()
    return _bf16(x * torch.rsqrt(ms + eps) * w.float())


def _gemv_ref(h: torch.Tensor, w, int8_a: bool) -> torch.Tensor:
    """[K] fp32 holding bf16 values @ one layer's weight -> [N] fp32.

    Dense: one fp32 product (bf16 x bf16 products are exact in fp32).
    bf16 activation: per-group fp32 partials of h x q, times the fp32
    scales, summed over groups. int8 activation (`_quant_act` and
    `_gemv_from_act`): d = amax/127 per group (1 where amax is 0),
    Aq = round_half_even(h / d), exact integer partials, then
    sum(float(Pi) * d * s)."""
    if not isinstance(w, QuantTensor):
        return h @ w.float()
    K, N = w.q.shape
    g = w.group_size
    ng = K // g
    hg = h.reshape(ng, g)
    qg = w.q.reshape(ng, g, N).float()
    s = w.s[:ng].float()
    if int8_a:
        amax = hg.abs().amax(dim=1, keepdim=True)
        d = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        aq = torch.round(hg / d)
        pi = torch.einsum("ig,ign->in", aq, qg)  # integers < 2^24: exact
        terms = pi * d * s
    else:
        terms = torch.einsum("ig,ign->in", hg, qg) * s
    # groups summed one after another, in the order of the JAX kernel's
    # reduction on the CPU (torch's own sum and cumsum take other orders)
    y = terms[0]
    for i in range(1, ng):
        y = y + terms[i]
    return y


def _cols(w, lo: int, hi: int, layer: int):
    """Columns [lo, hi) of layer `layer` of a stacked weight."""
    if isinstance(w, QuantTensor):
        return QuantTensor(q=w.q[layer][:, lo:hi], s=w.s[layer][:, lo:hi],
                           group_size=w.group_size)
    return w[layer][:, lo:hi]


def _rows(w, lo: int, hi: int, layer: int):
    """Rows [lo, hi) of layer `layer` of a stacked weight (whole groups)."""
    if isinstance(w, QuantTensor):
        g = w.group_size
        return QuantTensor(q=w.q[layer][lo:hi], s=w.s[layer][lo // g:hi // g],
                           group_size=g)
    return w[layer][lo:hi]


def _geometry(cfg, blocks):
    hd = cfg.head_dim
    d = _kn(blocks["wo"])[1]
    H = _kn(blocks["wo"])[0] // hd
    KH = (_kn(blocks["wqkv"])[1] - H * hd) // (2 * hd)
    hidden = _kn(blocks["w2"])[0]
    return d, H, KH, hd, hidden


def _attend_ref(q, k_new, v_new, k_hist, v_hist, scale, cache_dtype):
    """One layer's attention of H query heads against the history slots
    [T, KH*hd] and the new token, merged analytically as the JAX kernel does.
    q [H, hd], k_new/v_new [KH, hd]: fp32 holding bf16 values."""
    H, hd = q.shape
    KH = k_new.shape[0]
    qg = q.reshape(KH, H // KH, hd)
    kh = k_hist.float().reshape(-1, KH, hd)
    vh = v_hist.float().reshape(-1, KH, hd)
    scores = torch.einsum("kmd,tkd->kmt", qg, kh) * scale
    s_new = (qg * k_new[:, None, :]).sum(dim=-1) * scale
    m = torch.cat([scores, s_new[..., None]], dim=-1).amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    p_new = torch.exp(s_new - m)
    denom = p.sum(dim=-1) + p_new
    # p is rounded to the cache dtype before the pv product (`_kernel` :330)
    pv = torch.einsum("kmt,tkd->kmd", p.to(cache_dtype).float(), vh)
    pv = pv + p_new[..., None] * v_new[:, None, :]
    return _bf16(pv / denom[..., None]).reshape(H * hd)


def attention_scale(hd: int) -> float:
    """1/sqrt(hd) rounded to fp32 once, for the kernel and the plain version."""
    return float(torch.rsqrt(torch.tensor(float(hd), dtype=torch.float32)))


def fused_decode_step_ref(cfg, params, x0, k_cache, v_cache, pos, sin, cos,
                          n_tiles=None):
    """The plain version of the megakernel: the JAX `_kernel`'s arithmetic
    and rounding points in torch ops. bf16 activations whatever the params
    dtype; fp32 accumulation. n_tiles overrides the plan's NT (tests)."""
    blocks = params["blocks"]
    d, H, KH, hd, hidden = _geometry(cfg, blocks)
    A = k_cache.shape[1]
    nt = n_tiles or plan_tiles(blocks, k_cache.dtype, A)
    if nt is None:
        raise ValueError("fused_decode_step_ref: the model does not fit the "
                         "megakernel's plan")
    f_qkv, f_wo, f_w13, f_w2 = gemv_int8_flags(blocks, nt)
    p_i = int(pos.reshape(()).item()) if torch.is_tensor(pos) else int(pos)
    if not 0 <= p_i < A:
        raise ValueError(f"fused_decode_step_ref: pos {p_i} outside [0, {A})")
    pr = min(p_i, cfg.seq_len - 1)
    s_row, c_row = sin[pr].float(), cos[pr].float()
    scale = attention_scale(hd)
    cdt = k_cache.dtype
    ht = hidden // nt
    x = x0.reshape(d).float()
    for li in range(k_cache.shape[0]):
        h1 = _rmsnorm_bf16(x, blocks["attn_norm"][li], cfg.norm_eps)
        y = _gemv_ref(h1, _cols(blocks["wqkv"], 0, _kn(blocks["wqkv"])[1], li),
                      f_qkv)
        if "bqkv" in blocks:
            y = y + blocks["bqkv"][li].float()
        y = _bf16(y)
        q = y[:H * hd].reshape(1, H, hd)
        k = y[H * hd:(H + KH) * hd].reshape(1, KH, hd)
        v = y[(H + KH) * hd:].reshape(KH, hd)
        q = _bf16(apply_rope(q, s_row, c_row, cfg.rope_style))[0]
        k = _bf16(apply_rope(k, s_row, c_row, cfg.rope_style))[0]
        attn = _attend_ref(q, k, v, k_cache[li, :p_i], v_cache[li, :p_i],
                           scale, cdt)
        k_cache[li, p_i] = k.reshape(-1).to(cdt)
        v_cache[li, p_i] = v.reshape(-1).to(cdt)
        wo = _gemv_ref(attn, _cols(blocks["wo"], 0, d, li), f_wo)
        x = _bf16(x + wo)
        h2 = _rmsnorm_bf16(x, blocks["ffn_norm"][li], cfg.norm_eps)
        ffn = torch.zeros_like(x)
        for t in range(nt):
            lo, hi = t * ht, (t + 1) * ht
            gate = _bf16(_gemv_ref(h2, _cols(blocks["w13"], lo, hi, li), f_w13))
            up = _bf16(_gemv_ref(h2, _cols(blocks["w13"], hidden + lo,
                                           hidden + hi, li), f_w13))
            act = _bf16(_bf16(gate * torch.sigmoid(gate)) * up)
            ffn = ffn + _gemv_ref(act, _rows(blocks["w2"], lo, hi, li), f_w2)
        x = _bf16(x + ffn)
    xo = _rmsnorm_bf16(x, params["final_norm"], cfg.norm_eps)
    return xo.reshape(1, d).to(x0.dtype), k_cache, v_cache


# ---------------------------------------------------------------------------
# Kernel wrapper


class _Args(ctypes.Structure):
    """Mirror of `FusedArgs` in csrc/fused_decode.cu (field for field)."""
    _fields_ = [
        ("wqkv", _c_void_p), ("wqkv_s", _c_void_p), ("wo", _c_void_p),
        ("wo_s", _c_void_p), ("w13", _c_void_p), ("w13_s", _c_void_p),
        ("w2", _c_void_p), ("w2_s", _c_void_p), ("bqkv", _c_void_p),
        ("attn_norm", _c_void_p), ("ffn_norm", _c_void_p),
        ("final_norm", _c_void_p), ("x0", _c_void_p), ("x_out", _c_void_p),
        ("k_cache", _c_void_p), ("v_cache", _c_void_p), ("pos", _c_void_p),
        ("sin", _c_void_p), ("cos", _c_void_p),
        ("x", _c_void_p), ("qkv", _c_void_p), ("attn", _c_void_p),
        ("act", _c_void_p), ("partial", _c_void_p), ("counters", _c_void_p),
        ("trace", _c_void_p),
        ("cache_layer_stride", _c_ll),
        ("L", _c_int), ("d", _c_int), ("H", _c_int), ("KH", _c_int),
        ("hd", _c_int), ("hidden", _c_int), ("A", _c_int), ("seq_len", _c_int),
        ("g", _c_int), ("s_rows_qkv", _c_int), ("s_rows_wo", _c_int),
        ("s_rows_w13", _c_int), ("s_rows_w2", _c_int),
        ("w_kind", _c_int), ("s_bf16", _c_int), ("x_bf16", _c_int),
        ("cache_bf16", _c_int), ("bias_bf16", _c_int), ("has_bias", _c_int),
        ("rope_half", _c_int),
        ("int8_act", _c_int * 4), ("col_threads", _c_int * 4),
        ("units_per_split", _c_int * 4),
        ("grid", _c_int), ("smem_bytes", _c_int),
        ("eps", _c_float), ("scale", _c_float),
    ]


W_INT8, W_BF16, W_FP32 = 0, 1, 2
_COLS_PER_THREAD = {W_INT8: 16, W_BF16: 8, W_FP32: 4}
_fns: dict = {}
_occupancy: dict = {}
_workspace: dict = {}


def _kernel_fns():
    fns = _fns.get(SOURCE)
    if fns is None:
        lib = build.load(SOURCE)
        launch = lib.fused_decode
        launch.argtypes = [ctypes.POINTER(_Args), _c_void_p]
        launch.restype = _c_int
        occ = lib.fused_decode_blocks_per_sm
        occ.argtypes = [_c_int, _c_int, ctypes.POINTER(_c_int)]
        occ.restype = _c_int
        fns = _fns[SOURCE] = (launch, occ)
    return fns


def _blocks_per_sm(device, w_kind: int, smem: int) -> int:
    key = (device.index, w_kind, smem)
    n = _occupancy.get(key)
    if n is None:
        out = _c_int(0)
        rc = _kernel_fns()[1](w_kind, smem, ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"fused_decode: occupancy query failed, CUDA error {rc}")
        if out.value < 1:
            raise RuntimeError(f"fused_decode: no block of {_THREADS} threads "
                               f"with {smem} B of shared memory fits an SM")
        n = _occupancy[key] = out.value
    return n


def smem_bytes(K_max: int, A: int, hd: int) -> int:
    """Dynamic shared memory of one block; csrc/fused_decode.cu lays it out
    the same way. GEMV phases: the staged activation as fp32 [Kp], its int8
    copy [Kp] and group scales [Kp / 4] (Kp = K_max rounded up to 16), the
    k-lane reduction buffer, its second stage and the item's two output
    tiles. Attention: q, k, v rows, the threads' pv partials (8 lanes each)
    and the scores of A slots. The phases share the space; 64 floats of block-reduction
    scratch follow it."""
    kp = -(-K_max // 16) * 16
    gemv = 6 * kp + 4 * (_RED_FLOATS + _THREADS + 2 * _THREADS)
    attn = 4 * (3 * hd + 8 * _THREADS + A)
    return max(gemv, attn) + 4 * 64


def gemv_tiling(ncols: int, units: int, cols_per_thread: int, grid: int):
    """(column threads, units per split) for one GEMV phase: the column tile
    (16, 8 or 4 threads of `cols_per_thread` columns) and K split (whole
    units: groups, or 64-row chunks of a dense weight) that give the most
    work items without exceeding the grid, so that no block takes a second
    round; ties go to the wider tile, then to the longer split."""
    best, best_key = None, None
    for ct in (16, 8, 4):
        tiles = -(-ncols // (ct * cols_per_thread))
        for ups in range(1, units + 1):
            items = tiles * -(-units // ups)
            key = (items <= grid, items if items <= grid else -items)
            if best_key is None or key > best_key:
                best, best_key = (ct, ups), key
    return best


def _units(K: int, w) -> tuple:
    """(rows per K-split unit, unit count) of one weight."""
    if isinstance(w, QuantTensor):
        return w.group_size, K // w.group_size
    if K % _DENSE_UNIT_ROWS == 0:
        return _DENSE_UNIT_ROWS, K // _DENSE_UNIT_ROWS
    return K, 1


def _check_tensor(t, name, dtypes, device):
    if t.device != device:
        raise ValueError(f"fused_decode_step: {name} is on {t.device}, "
                         f"expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"fused_decode_step: {name} has dtype {t.dtype}, "
                        f"expected one of {dtypes}")


def _weight_kind(blocks, device):
    names = ("wqkv", "wo", "w13", "w2")
    ws = [blocks[n] for n in names]
    if all(isinstance(w, QuantTensor) for w in ws):
        g = ws[0].group_size
        s_dt = ws[0].s.dtype
        for n, w in zip(names, ws):
            if w.group_size != g:
                raise ValueError("fused_decode_step: mixed group sizes")
            _check_tensor(w.q, n, (torch.int8,), device)
            _check_tensor(w.s, f"{n}.s", (s_dt,), device)
            if s_dt not in (torch.float32, torch.bfloat16):
                raise TypeError(f"fused_decode_step: scales must be fp32 or bf16")
            if not (w.q.is_contiguous() and w.s.is_contiguous()) or (
                    w.q.data_ptr() % 16 or w.s.data_ptr() % 16):
                raise ValueError(f"fused_decode_step: {n} must be contiguous "
                                 "and 16-byte aligned")
        return W_INT8, g, s_dt == torch.bfloat16
    if any(isinstance(w, QuantTensor) for w in ws):
        raise ValueError("fused_decode_step: mixed quantized and dense weights")
    dt = ws[0].dtype
    for n, w in zip(names, ws):
        _check_tensor(w, n, (dt,), device)
        if not w.is_contiguous() or w.data_ptr() % 16:
            raise ValueError(f"fused_decode_step: {n} must be contiguous and "
                             "16-byte aligned")
    if dt == torch.bfloat16:
        return W_BF16, 0, False
    if dt == torch.float32:
        return W_FP32, 0, False
    raise TypeError(f"fused_decode_step: dense weights must be bf16 or fp32, got {dt}")


def _ws(device, name, numel, dtype, zero=False):
    """A scratch tensor of at least `numel` elements, kept per device and
    reused by every launch. The split counters start at zero and the kernel
    leaves them at zero."""
    key = (device.index, name)
    t = _workspace.get(key)
    if t is None or t.numel() < numel or t.dtype != dtype:
        t = (torch.zeros if zero else torch.empty)(max(numel, 1), dtype=dtype,
                                                   device=device)
        _workspace[key] = t
    return t


PHASES = ("qkv", "attention", "wo", "gate_up", "w2")


def fused_decode_step(cfg, params, x0, k_cache, v_cache, pos, sin, cos,
                      trace=None):
    """One decode step of the whole layer stack for B = 1 (see the module
    docstring for the contract). CPU tensors take the plain version; CUDA
    tensors launch csrc/fused_decode.cu once, or raise.

    trace: optional int64 CUDA tensor of 2 + 5 L elements; the kernel writes
    the card's global timer (ns) at its start, after each phase of each
    layer (PHASES order) and at its end. `phase_times` reads it."""
    if x0.device.type == "cpu":
        return fused_decode_step_ref(cfg, params, x0, k_cache, v_cache, pos,
                                     sin, cos)
    dev = x0.device
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"fused_decode_step: x0 is on {dev}, the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    blocks = params["blocks"]
    L, A, KV = k_cache.shape
    nt = plan_tiles(blocks, k_cache.dtype, A)
    if nt is None:
        raise ValueError("fused_decode_step: the model does not fit the "
                         "megakernel's plan")
    d, H, KH, hd, hidden = _geometry(cfg, blocks)
    w_kind, g, s_bf16 = _weight_kind(blocks, dev)
    flags = gemv_int8_flags(blocks, nt)
    cpt = _COLS_PER_THREAD[w_kind]
    n_qkv = (H + 2 * KH) * hd
    if KV != KH * hd or tuple(v_cache.shape) != (L, A, KV) or L != cfg.n_layers:
        raise ValueError(f"fused_decode_step: caches {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} do not fit the model")
    if (k_cache.stride()[1:] != (KV, 1) or v_cache.stride() != k_cache.stride()
            or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16):
        raise ValueError("fused_decode_step: cache rows must be contiguous, "
                         "16-byte aligned and both caches laid out alike")
    if hd % 8 or hd > 256:
        raise ValueError(f"fused_decode_step: head_dim {hd} must be a multiple "
                         "of 8 and <= 256")
    if d % 8 or hidden % 8:
        raise ValueError(f"fused_decode_step: dim {d} and hidden {hidden} must "
                         "be multiples of 8, the kernel's staging load")
    for n in (n_qkv, d, hidden):
        if n % cpt:
            raise ValueError(f"fused_decode_step: width {n} is not a multiple "
                             f"of {cpt}, the kernel's column run")
    if w_kind == W_INT8 and any(flags) and g % 4:
        raise ValueError(f"fused_decode_step: int8 activations need a group "
                         f"size divisible by 4, got {g}")
    _check_tensor(x0, "x0", (torch.bfloat16, torch.float32), dev)
    _check_tensor(k_cache, "k_cache", (torch.bfloat16, torch.float32), dev)
    _check_tensor(v_cache, "v_cache", (k_cache.dtype,), dev)
    _check_tensor(pos, "pos", (torch.int32,), dev)
    _check_tensor(sin, "sin", (torch.float32,), dev)
    _check_tensor(cos, "cos", (torch.float32,), dev)
    if pos.numel() != 1 or x0.shape != (1, d) or not x0.is_contiguous():
        raise ValueError("fused_decode_step: pos must hold one value and x0 "
                         "be a contiguous [1, d] row")
    if tuple(sin.shape) != (cfg.seq_len, hd // 2) or not (
            sin.is_contiguous() and cos.is_contiguous()):
        raise ValueError("fused_decode_step: sin/cos must be contiguous "
                         "[seq_len, head_dim // 2] tables")
    bias = blocks.get("bqkv")
    if bias is not None:
        _check_tensor(bias, "bqkv", (torch.bfloat16, torch.float32), dev)
        bias = bias.contiguous()
    norms = [blocks["attn_norm"].float().contiguous(),
             blocks["ffn_norm"].float().contiguous(),
             params["final_norm"].float().contiguous()]

    K_max = max(d, hidden)
    smem = smem_bytes(K_max, A, hd)
    grid = _blocks_per_sm(dev, w_kind, smem)
    grid = min(grid, _MAX_BLOCKS_PER_SM) * _sms(dev)
    plans, parts, tiles = [], 0, 0
    for name, ncols, halves in (("wqkv", n_qkv, 1), ("wo", d, 1),
                                ("w13", hidden, 2), ("w2", d, 1)):
        K = _kn(blocks[name])[0]
        _, units = _units(K, blocks[name])
        ct, ups = gemv_tiling(ncols, units, cpt, grid)
        n_tiles = -(-ncols // (ct * cpt))
        splits = -(-units // ups)
        plans.append((ct, ups))
        tiles = max(tiles, n_tiles)
        if splits > 1:
            parts = max(parts, splits * halves * ncols)

    x_out = torch.empty((1, d), dtype=x0.dtype, device=dev)
    a = _Args()

    def ptr(t):
        return None if t is None else t.data_ptr()

    def srows(name):
        w = blocks[name]
        return w.s.shape[-2] if isinstance(w, QuantTensor) else 0

    for name in ("wqkv", "wo", "w13", "w2"):
        w = blocks[name]
        if isinstance(w, QuantTensor):
            setattr(a, name, w.q.data_ptr())
            setattr(a, f"{name}_s", w.s.data_ptr())
        else:
            setattr(a, name, w.data_ptr())
    a.bqkv = ptr(bias)
    a.attn_norm, a.ffn_norm, a.final_norm = (n.data_ptr() for n in norms)
    a.x0, a.x_out = x0.data_ptr(), x_out.data_ptr()
    a.k_cache, a.v_cache = k_cache.data_ptr(), v_cache.data_ptr()
    a.pos, a.sin, a.cos = pos.data_ptr(), sin.data_ptr(), cos.data_ptr()
    a.x = _ws(dev, "x", d, torch.float32).data_ptr()
    a.qkv = _ws(dev, "qkv", n_qkv, torch.bfloat16).data_ptr()
    a.attn = _ws(dev, "attn", H * hd, torch.bfloat16).data_ptr()
    a.act = _ws(dev, "act", hidden, torch.bfloat16).data_ptr()
    a.partial = _ws(dev, "partial", parts, torch.float32).data_ptr()
    a.counters = _ws(dev, "counters", tiles, torch.int32, zero=True).data_ptr()
    if trace is not None:
        if (trace.device != dev or trace.dtype != torch.int64
                or trace.numel() < 2 + 5 * L or not trace.is_contiguous()):
            raise ValueError("fused_decode_step: trace must be a contiguous "
                             f"int64 tensor of {2 + 5 * L} elements on {dev}")
        a.trace = trace.data_ptr()
    a.cache_layer_stride = k_cache.stride(0)
    a.L, a.d, a.H, a.KH, a.hd, a.hidden, a.A = L, d, H, KH, hd, hidden, A
    a.seq_len, a.g = cfg.seq_len, g
    a.s_rows_qkv, a.s_rows_wo = srows("wqkv"), srows("wo")
    a.s_rows_w13, a.s_rows_w2 = srows("w13"), srows("w2")
    a.w_kind, a.s_bf16 = w_kind, int(s_bf16)
    a.x_bf16 = int(x0.dtype == torch.bfloat16)
    a.cache_bf16 = int(k_cache.dtype == torch.bfloat16)
    a.bias_bf16 = int(bias is not None and bias.dtype == torch.bfloat16)
    a.has_bias = int(bias is not None)
    a.rope_half = int(cfg.rope_style == "half")
    for i, (f, (ct, ups)) in enumerate(zip(flags, plans)):
        a.int8_act[i], a.col_threads[i], a.units_per_split[i] = int(f), ct, ups
    a.grid, a.smem_bytes = grid, smem
    a.eps, a.scale = cfg.norm_eps, attention_scale(hd)
    rc = _kernel_fns()[0](ctypes.byref(a),
                          torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_decode_step: cooperative launch failed, "
                           f"CUDA error {rc}")
    fused_decode_step.launches += 1
    return x_out, k_cache, v_cache


def phase_times(trace: torch.Tensor, n_layers: int) -> dict:
    """Microseconds per phase, summed over the layers, from a `trace`
    filled by one launch; "final" is the last rmsnorm."""
    t = trace[: 2 + 5 * n_layers].cpu().tolist()
    out = {name: 0.0 for name in PHASES}
    for li in range(n_layers):
        for j, name in enumerate(PHASES):
            i = 1 + 5 * li + j
            out[name] += (t[i] - t[i - 1]) / 1e3
    out["final"] = (t[1 + 5 * n_layers] - t[5 * n_layers]) / 1e3
    out["total"] = (t[1 + 5 * n_layers] - t[0]) / 1e3
    return out


fused_decode_step.launches = 0
