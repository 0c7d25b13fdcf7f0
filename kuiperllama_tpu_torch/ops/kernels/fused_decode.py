"""The B = 1 decode megakernels of the small plan: one launch per decode
step for the whole layer stack, and the greedy chunk kernel that runs a
whole decode chunk in one launch; their routing plan, plain PyTorch
versions, and the argument building the big-model kernel shares.

Port of kuiperllama_tpu/ops/pallas/fused_decode.py (`_kernel`, entry
`fused_decode_step`; `_chunk_kernel`, entry `fused_decode_chunk`). The CUDA
sources are csrc/fused_decode.cu and csrc/fused_decode_chunk.cu, on the
device code of csrc/fused_decode_common.cuh; their headers say what bounds
them on the card and how their design deals with that.

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

The chunk kernel (`fused_decode_chunk`) runs `steps` of these steps, each
followed by the lm_head, the first-max argmax and the next token's
embedding row rounded to bf16; its own earlier rows round p to bf16 in
attention (see `_attend_ref`).

On the CPU each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. `fused_decode_step.launches` and
`fused_decode_chunk.launches` count launches.
"""

from __future__ import annotations

import ctypes

import torch

from ...quant import QuantTensor
from ..rope import apply_rope
from ..tuning import gemv_int8_auto
from . import build, workspace
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


def _attend_ref(q, k_new, v_new, k_hist, v_hist, scale, cache_dtype,
                k_rec=None, v_rec=None):
    """One layer's attention of H query heads against the history slots
    [T, KH*hd] and the new token, merged analytically as the JAX kernel does.
    q [H, hd], k_new/v_new [KH, hd]: fp32 holding bf16 values.

    k_rec/v_rec: the greedy chunk kernel's own earlier rows [S, KH*hd]
    (bf16 values). Their p is rounded to bf16, whatever the cache dtype, and
    the max and the sums run over history, then those rows, then the new
    token (`_chunk_kernel` :735-761)."""
    H, hd = q.shape
    KH = k_new.shape[0]
    qg = q.reshape(KH, H // KH, hd)
    kh = k_hist.float().reshape(-1, KH, hd)
    vh = v_hist.float().reshape(-1, KH, hd)
    scores = torch.einsum("kmd,tkd->kmt", qg, kh) * scale
    s_new = (qg * k_new[:, None, :]).sum(dim=-1) * scale
    if k_rec is None:
        m = torch.cat([scores, s_new[..., None]], dim=-1).amax(dim=-1)
        p = torch.exp(scores - m[..., None])
        p_new = torch.exp(s_new - m)
        denom = p.sum(dim=-1) + p_new
        # p is rounded to the cache dtype before the pv product (`_kernel` :330)
        pv = torch.einsum("kmt,tkd->kmd", p.to(cache_dtype).float(), vh)
    else:
        kr = k_rec.float().reshape(-1, KH, hd)
        vr = v_rec.float().reshape(-1, KH, hd)
        rec = torch.einsum("kmd,tkd->kmt", qg, kr) * scale
        m = torch.cat([scores, rec, s_new[..., None]], dim=-1).amax(dim=-1)
        p = torch.exp(scores - m[..., None])
        prc = torch.exp(rec - m[..., None])
        p_new = torch.exp(s_new - m)
        denom = p.sum(dim=-1) + prc.sum(dim=-1) + p_new
        pv = torch.einsum("kmt,tkd->kmd", p.to(cache_dtype).float(), vh)
        pv = pv + torch.einsum("kmt,tkd->kmd", _bf16(prc), vr)
    pv = pv + p_new[..., None] * v_new[:, None, :]
    return _bf16(pv / denom[..., None]).reshape(H * hd)


def attention_scale(hd: int) -> float:
    """1/sqrt(hd) rounded to fp32 once, for the kernel and the plain version."""
    return float(torch.rsqrt(torch.tensor(float(hd), dtype=torch.float32)))


def _pos_value(pos) -> int:
    return int(pos.reshape(()).item()) if torch.is_tensor(pos) else int(pos)


def _layers_ref(cfg, blocks, x, k_cache, v_cache, pos, hist, sin, cos, flags,
                nt, n_wo=1):
    """The layer stack of one B = 1 step on the fp32 residual x [d] (bf16
    values after every residual add), as the JAX megakernels compute it.
    The new K/V rows go into the caches at slot `pos` in place; attention
    reads slots < pos, the slots in [hist, pos) as the chunk kernel's own
    rows. flags: the activation type of the (qkv, wo, gate/up, w2) GEMVs;
    nt FFN column tiles and n_wo wo row tiles, whose partial sums are added
    in tile order. Returns the residual after the last layer."""
    d, H, KH, hd, hidden = _geometry(cfg, blocks)
    pr = min(pos, cfg.seq_len - 1)
    s_row, c_row = sin[pr].float(), cos[pr].float()
    scale = attention_scale(hd)
    cdt = k_cache.dtype
    f_qkv, f_wo, f_w13, f_w2 = flags
    ht, tr = hidden // nt, d // n_wo
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
        rec = {}
        if hist < pos:
            rec = dict(k_rec=k_cache[li, hist:pos], v_rec=v_cache[li, hist:pos])
        attn = _attend_ref(q, k, v, k_cache[li, :hist], v_cache[li, :hist],
                           scale, cdt, **rec)
        k_cache[li, pos] = k.reshape(-1).to(cdt)
        v_cache[li, pos] = v.reshape(-1).to(cdt)
        wo = None
        for j in range(n_wo):
            part = _gemv_ref(attn[j * tr:(j + 1) * tr],
                             _rows(blocks["wo"], j * tr, (j + 1) * tr, li), f_wo)
            wo = part if wo is None else wo + part
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
    return x


def fused_decode_step_ref(cfg, params, x0, k_cache, v_cache, pos, sin, cos,
                          n_tiles=None):
    """The plain version of the megakernel: the JAX `_kernel`'s arithmetic
    and rounding points in torch ops. bf16 activations whatever the params
    dtype; fp32 accumulation. n_tiles overrides the plan's NT (tests)."""
    blocks = params["blocks"]
    A = k_cache.shape[1]
    nt = n_tiles or plan_tiles(blocks, k_cache.dtype, A)
    if nt is None:
        raise ValueError("fused_decode_step_ref: the model does not fit the "
                         "megakernel's plan")
    p_i = _pos_value(pos)
    if not 0 <= p_i < A:
        raise ValueError(f"fused_decode_step_ref: pos {p_i} outside [0, {A})")
    x = _layers_ref(cfg, blocks, x0.reshape(-1).float(), k_cache, v_cache, p_i,
                    p_i, sin, cos, gemv_int8_flags(blocks, nt), nt)
    xo = _rmsnorm_bf16(x, params["final_norm"], cfg.norm_eps)
    return xo.reshape(1, -1).to(x0.dtype), k_cache, v_cache


# ---------------------------------------------------------------------------
# Kernel wrappers (this kernel's, and the argument building that the
# big-model and chunk kernels share)


class _Args(ctypes.Structure):
    """Mirror of `FusedArgs` in csrc/fused_decode_common.cuh (field for field)."""
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
_occupancy: dict = {}


def kernel_fns(source: str, launch_name: str, args_type=_Args):
    """(launch, occupancy query) of a megakernel library: `launch_name`
    takes (args*, stream), `<launch_name>_blocks_per_sm` (variant, smem,
    int*); both return a cudaError_t."""
    return (build.entry(source, launch_name, [ctypes.POINTER(args_type), _c_void_p]),
            build.entry(source, f"{launch_name}_blocks_per_sm",
                        [_c_int, _c_int, ctypes.POINTER(_c_int)]))


def blocks_per_sm(source, occ, device, variant: int, smem: int) -> int:
    """Resident blocks per SM of one kernel variant with `smem` bytes of
    dynamic shared memory (cached per device)."""
    key = (source, device.index, variant, smem)
    n = _occupancy.get(key)
    if n is None:
        out = _c_int(0)
        rc = occ(variant, smem, ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"{source}: occupancy query failed, CUDA error {rc}")
        if out.value < 1:
            raise RuntimeError(f"{source}: no block of {_THREADS} threads "
                               f"with {smem} B of shared memory fits an SM")
        n = _occupancy[key] = out.value
    return n


def smem_bytes(K_max: int, A: int, hd: int) -> int:
    """Dynamic shared memory of one block; csrc/fused_decode_common.cuh
    `smem_layout` lays it out the same way. GEMV phases: the staged
    activation as fp32 [Kp], its int8 copy [Kp] and group scales [Kp / 4]
    (Kp = K_max rounded up to 16), the k-lane reduction buffer, its second
    stage and the item's two output tiles. Attention: q, k, v rows, the
    threads' pv partials (8 lanes each) and the scores of A slots. The phases
    share the space; 64 floats of block-reduction scratch follow it."""
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


def _check_tensor(t, name, dtypes, device, who="fused_decode_step"):
    if t.device != device:
        raise ValueError(f"{who}: {name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{who}: {name} has dtype {t.dtype}, expected one of "
                        f"{dtypes}")


def weight_kind(w, name, device, who, group=None, s_dtype=None):
    """(kind, group size, bf16 scales) of one weight the kernels stream,
    after checking its device, dtypes, contiguity and 16-byte alignment."""
    if isinstance(w, QuantTensor):
        g, s_dt = w.group_size, w.s.dtype
        if group is not None and g != group:
            raise ValueError(f"{who}: {name} has group size {g}, expected {group}")
        _check_tensor(w.q, name, (torch.int8,), device, who)
        _check_tensor(w.s, f"{name}.s", (s_dtype or s_dt,), device, who)
        if s_dt not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{who}: scales must be fp32 or bf16")
        if not (w.q.is_contiguous() and w.s.is_contiguous()) or (
                w.q.data_ptr() % 16 or w.s.data_ptr() % 16):
            raise ValueError(f"{who}: {name} must be contiguous and 16-byte "
                             "aligned")
        return W_INT8, g, s_dt == torch.bfloat16
    if w.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{who}: dense weights must be bf16 or fp32, got {w.dtype}")
    _check_tensor(w, name, (w.dtype,), device, who)
    if not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError(f"{who}: {name} must be contiguous and 16-byte aligned")
    return (W_BF16 if w.dtype == torch.bfloat16 else W_FP32), 0, False


def _weight_kind(blocks, device, who="fused_decode_step"):
    names = ("wqkv", "wo", "w13", "w2")
    ws = [blocks[n] for n in names]
    quant = [isinstance(w, QuantTensor) for w in ws]
    if any(quant) and not all(quant):
        raise ValueError(f"{who}: mixed quantized and dense weights")
    if all(quant):
        g, s_dt = ws[0].group_size, ws[0].s.dtype
        for n, w in zip(names, ws):
            weight_kind(w, n, device, who, g, s_dt)
        return W_INT8, g, s_dt == torch.bfloat16
    dt = ws[0].dtype
    for n, w in zip(names, ws):
        _check_tensor(w, n, (dt,), device, who)
        weight_kind(w, n, device, who)
    return weight_kind(ws[0], "wqkv", device, who)


def _ws(device, name, numel, dtype, zero=False):
    """A scratch tensor of at least `numel` elements, kept per device and
    reused by every launch (ops/kernels/workspace.py). The split counters
    start at zero and the kernel leaves them at zero."""
    return workspace.scratch(device, f"fused_{name}", numel, dtype, zero)


PHASES = ("qkv", "attention", "wo", "gate_up", "w2")


def step_args(who, cfg, params, x0, k_cache, v_cache, pos, sin, cos, flags,
              grid_for, extra=None, trace=None, grid=None):
    """Check a megakernel launch's inputs and fill its `_Args`.

    flags: the (qkv, wo, gate/up, w2) activation types; grid_for(w_kind,
    smem) -> blocks per SM; extra(grid) -> (fp32 partials, tile counters)
    that a phase beyond the layer stack needs; grid: the launch's blocks
    (default: every block that fits, at most two per SM; a grid beyond
    what fits is refused by the cooperative launch). Returns (args, x_out,
    tensors the launch reads that must outlive this call's locals)."""
    dev = x0.device
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{who}: x0 is on {dev}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    blocks = params["blocks"]
    L, A, KV = k_cache.shape
    d, H, KH, hd, hidden = _geometry(cfg, blocks)
    w_kind, g, s_bf16 = _weight_kind(blocks, dev, who)
    cpt = _COLS_PER_THREAD[w_kind]
    n_qkv = (H + 2 * KH) * hd
    if KV != KH * hd or tuple(v_cache.shape) != (L, A, KV) or L != cfg.n_layers:
        raise ValueError(f"{who}: caches {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} do not fit the model")
    if (k_cache.stride()[1:] != (KV, 1) or v_cache.stride() != k_cache.stride()
            or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16):
        raise ValueError(f"{who}: cache rows must be contiguous, 16-byte "
                         "aligned and both caches laid out alike")
    if hd % 8 or hd > 256:
        raise ValueError(f"{who}: head_dim {hd} must be a multiple of 8 and "
                         "<= 256")
    if d % 8 or hidden % 8:
        raise ValueError(f"{who}: dim {d} and hidden {hidden} must be "
                         "multiples of 8, the kernel's staging load")
    for n in (n_qkv, d, hidden):
        if n % cpt:
            raise ValueError(f"{who}: width {n} is not a multiple of {cpt}, "
                             "the kernel's column run")
    if w_kind == W_INT8 and any(flags) and g % 4:
        raise ValueError(f"{who}: int8 activations need a group size "
                         f"divisible by 4, got {g}")
    _check_tensor(x0, "x0", (torch.bfloat16, torch.float32), dev, who)
    _check_tensor(k_cache, "k_cache", (torch.bfloat16, torch.float32), dev, who)
    _check_tensor(v_cache, "v_cache", (k_cache.dtype,), dev, who)
    _check_tensor(pos, "pos", (torch.int32,), dev, who)
    _check_tensor(sin, "sin", (torch.float32,), dev, who)
    _check_tensor(cos, "cos", (torch.float32,), dev, who)
    if pos.numel() != 1 or x0.shape != (1, d) or not x0.is_contiguous():
        raise ValueError(f"{who}: pos must hold one value and x0 be a "
                         "contiguous [1, d] row")
    if tuple(sin.shape) != (cfg.seq_len, hd // 2) or not (
            sin.is_contiguous() and cos.is_contiguous()):
        raise ValueError(f"{who}: sin/cos must be contiguous "
                         "[seq_len, head_dim // 2] tables")
    bias = blocks.get("bqkv")
    if bias is not None:
        _check_tensor(bias, "bqkv", (torch.bfloat16, torch.float32), dev, who)
        bias = bias.contiguous()
    norms = [blocks["attn_norm"].float().contiguous(),
             blocks["ffn_norm"].float().contiguous(),
             params["final_norm"].float().contiguous()]

    smem = smem_bytes(max(d, hidden), A, hd)
    if grid is None:
        grid = min(grid_for(w_kind, smem), _MAX_BLOCKS_PER_SM) * _sms(dev)
    parts, tiles = extra(grid) if extra else (0, 0)
    plans = []
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
    a.bqkv = None if bias is None else bias.data_ptr()
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
            raise ValueError(f"{who}: trace must be a contiguous int64 tensor "
                             f"of {2 + 5 * L} elements on {dev}")
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
    return a, x_out, (bias, norms)


def plan_summary(a, device, lm=None) -> dict:
    """A launch's grid, blocks per SM and each GEMV phase's plan from its
    `_Args`: column threads, units per split, column tiles and K splits;
    lm: the chunk kernel's lm_head as (ct, ups, vocab, kind, group size)."""
    cpt = _COLS_PER_THREAD[a.w_kind]
    phases = {}
    for i, (name, K, ncols) in enumerate((
            ("qkv", a.d, (a.H + 2 * a.KH) * a.hd), ("wo", a.H * a.hd, a.d),
            ("gate_up", a.d, a.hidden), ("w2", a.hidden, a.d))):
        ct, ups = a.col_threads[i], a.units_per_split[i]
        unit = a.g if a.w_kind == W_INT8 else (
            _DENSE_UNIT_ROWS if K % _DENSE_UNIT_ROWS == 0 else K)
        phases[name] = dict(ct=ct, ups=ups, tiles=-(-ncols // (ct * cpt)),
                            splits=-(-(K // unit) // ups))
    if lm is not None:
        ct, ups, V, kind, g = lm
        unit = g if kind == W_INT8 else (
            _DENSE_UNIT_ROWS if a.d % _DENSE_UNIT_ROWS == 0 else a.d)
        phases["lm_head"] = dict(ct=ct, ups=ups,
                                 tiles=-(-V // (ct * _COLS_PER_THREAD[kind])),
                                 splits=-(-(a.d // unit) // ups))
    return dict(grid=a.grid, blocks_per_sm=a.grid / _sms(device),
                smem_bytes=a.smem_bytes, phases=phases)


def fused_decode_step(cfg, params, x0, k_cache, v_cache, pos, sin, cos,
                      trace=None, grid=None):
    """One decode step of the whole layer stack for B = 1 (see the module
    docstring for the contract). CPU tensors take the plain version; CUDA
    tensors launch csrc/fused_decode.cu once, or raise.

    trace: optional int64 CUDA tensor of 2 + 5 L elements; the kernel writes
    the card's global timer (ns) at its start, after each phase of each
    layer (PHASES order) and at its end. `phase_times` reads it. grid: the
    launch's blocks (tests run blocks that take several items; default
    every block that fits, at most two per SM). `fused_decode_step.plan`
    holds the last launch's `plan_summary`."""
    if x0.device.type == "cpu":
        return fused_decode_step_ref(cfg, params, x0, k_cache, v_cache, pos,
                                     sin, cos)
    blocks = params["blocks"]
    nt = plan_tiles(blocks, k_cache.dtype, k_cache.shape[1])
    if nt is None:
        raise ValueError("fused_decode_step: the model does not fit the "
                         "megakernel's plan")
    launch, occ = kernel_fns(SOURCE, "fused_decode")
    a, x_out, keep = step_args(
        "fused_decode_step", cfg, params, x0, k_cache, v_cache, pos, sin, cos,
        gemv_int8_flags(blocks, nt),
        lambda kind, smem: blocks_per_sm(SOURCE, occ, x0.device, kind, smem),
        trace=trace, grid=grid)
    rc = launch(ctypes.byref(a), torch.cuda.current_stream(x0.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_decode_step: cooperative launch failed, "
                           f"CUDA error {rc}")
    fused_decode_step.launches += 1
    fused_decode_step.plan = plan_summary(a, x0.device)
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
fused_decode_step.plan = None


# ---------------------------------------------------------------------------
# The greedy chunk megakernel: `steps` greedy B = 1 steps in one launch
# (kuiperllama_tpu/ops/pallas/fused_decode.py `_chunk_kernel`, entry
# `fused_decode_chunk`; the CUDA source is csrc/fused_decode_chunk.cu).

CHUNK_SOURCE = "fused_decode_chunk"
_NEG_INF = -1e30  # the JAX kernel's NEG_INF: the running max starts there


def _pick_vt(Vpad: int, d: int, itemsize: int,
             budget: int = 17 * 1024 * 1024) -> int:
    """Vocab tile of the JAX chunk kernel: the largest 128-multiple divisor
    of Vpad whose weight tile (d x VT) fits the budget. The tiles only order
    the argmax (`_first_max`); the card's kernel tiles the vocabulary its
    own way and gives the same token."""
    best = 128
    for c in range(128, Vpad + 1, 128):
        if Vpad % c == 0 and c * d * itemsize <= budget:
            best = c
    return best


def lm_int8_activation(lm, d: int) -> bool:
    """Whether the chunk kernel's in-kernel lm_head GEMV quantizes its
    activation to int8: a quantized lm_head whose PADDED scale rows reach
    the int8 rule (the JAX `_gemv(xf, lm, lm_s, g)`). The per-step route's
    lm_head goes through `linear` and keeps the bf16 activation."""
    return (isinstance(lm, QuantTensor)
            and gemv_int8_auto(padded_groups(d // lm.group_size)))


def _first_max(logits: torch.Tensor, d: int, itemsize: int) -> int:
    """The JAX chunk kernel's greedy token: vocabulary tiles in order, each
    tile's first maximum, a later tile only when strictly greater (ties go
    to the lower index, `_chunk_kernel` :812-819)."""
    V = logits.numel()
    vt = _pick_vt(-(-V // 2048) * 2048, d, itemsize)
    best, tok = _NEG_INF, 0
    for j in range(0, V, vt):
        tile = logits[j:j + vt]
        m = float(tile.max())
        if m > best:
            best, tok = m, j + int(torch.argmax(tile))  # torch: the first max
    return tok


def fused_decode_chunk_ref(cfg, params, x0, k_cache, v_cache, pos, sin, cos,
                           steps: int, logits=None):
    """The plain version of the chunk kernel: `steps` iterations of the small
    megakernel's step (same plan, NT and activation types), each ending with
    the final rmsnorm, the lm_head GEMV, the first-max argmax and the next
    token's embedding row rounded to bf16. Step 0 starts from x0 as given.
    The chunk's K/V rows land in the caches at pos .. pos + steps - 1 in
    place. Returns (tokens int32 [steps], k_cache, v_cache); a list passed
    as `logits` receives each step's fp32 logits (the tie checks read
    them)."""
    blocks = params["blocks"]
    A = k_cache.shape[1]
    nt = plan_tiles(blocks, k_cache.dtype, A)
    if nt is None:
        raise ValueError("fused_decode_chunk_ref: the model does not fit the "
                         "megakernel's plan")
    pos0 = _pos_value(pos)
    if pos0 < 0 or pos0 + steps > A:
        raise ValueError(f"fused_decode_chunk_ref: slots {pos0} .. "
                         f"{pos0 + steps - 1} outside [0, {A})")
    flags = gemv_int8_flags(blocks, nt)
    d = x0.shape[-1]
    lm = params["lm_head"]
    lm_int8 = lm_int8_activation(lm, d)
    itemsize = 1 if isinstance(lm, QuantTensor) else lm.element_size()
    x = x0.reshape(-1).float()
    toks = []
    for s in range(steps):
        x = _layers_ref(cfg, blocks, x, k_cache, v_cache, pos0 + s, pos0, sin,
                        cos, flags, nt)
        xf = _rmsnorm_bf16(x, params["final_norm"], cfg.norm_eps)
        y = _gemv_ref(xf, lm, lm_int8)
        if logits is not None:
            logits.append(y)
        tok = _first_max(y, d, itemsize)
        toks.append(tok)
        x = _bf16(params["tok_emb"][tok].float())
    return (torch.tensor(toks, dtype=torch.int32, device=x0.device), k_cache,
            v_cache)


class _ChunkArgs(ctypes.Structure):
    """Mirror of `ChunkArgs` in csrc/fused_decode_chunk.cu."""
    _fields_ = [
        ("f", _Args), ("lm", _c_void_p), ("lm_s", _c_void_p), ("emb", _c_void_p),
        ("tokens", _c_void_p), ("pmax", _c_void_p), ("pidx", _c_void_p),
        ("steps", _c_int), ("vocab", _c_int), ("lm_kind", _c_int),
        ("lm_g", _c_int), ("lm_s_bf16", _c_int), ("lm_int8a", _c_int),
        ("lm_ct", _c_int), ("lm_ups", _c_int),
    ]


def fused_decode_chunk(cfg, params, x0, k_cache, v_cache, pos, sin, cos,
                       steps: int, grid=None):
    """`steps` greedy decode iterations for B = 1 in one launch of
    csrc/fused_decode_chunk.cu. x0 [1, d] is the embedding of the current
    token at slot `pos`; the caller guarantees pos + steps <= A (the cache
    window). Returns (tokens int32 [steps] on the device: the greedy
    continuation, k_cache, v_cache), the chunk's K/V rows written in place.
    CPU tensors take the plain version; CUDA tensors launch or raise.
    grid: the launch's blocks, as `fused_decode_step`'s;
    `fused_decode_chunk.plan` holds the last launch's `plan_summary`."""
    if x0.device.type == "cpu":
        return fused_decode_chunk_ref(cfg, params, x0, k_cache, v_cache, pos,
                                      sin, cos, steps)
    who = "fused_decode_chunk"
    blocks = params["blocks"]
    nt = plan_tiles(blocks, k_cache.dtype, k_cache.shape[1])
    if nt is None:
        raise ValueError(f"{who}: the model does not fit the megakernel's plan")
    if steps < 1 or cfg.n_layers < 1:
        raise ValueError(f"{who}: needs steps >= 1 and n_layers >= 1")
    dev = x0.device
    d = _geometry(cfg, blocks)[0]
    lm = params["lm_head"]
    lm_kind, lm_g, lm_s_bf16 = weight_kind(lm, "lm_head", dev, who)
    V = lm.shape[-1]
    cpt = _COLS_PER_THREAD[lm_kind]
    if tuple(lm.shape) != (d, V) or V % cpt:
        raise ValueError(f"{who}: lm_head {tuple(lm.shape)} must be [{d}, V] "
                         f"with V a multiple of {cpt}, the kernel's column run")
    lm_int8 = lm_int8_activation(lm, d)
    if lm_kind == W_INT8 and (d % lm_g or (lm_int8 and lm_g % 4)):
        raise ValueError(f"{who}: lm_head group size {lm_g} does not fit dim {d}")
    emb = params["tok_emb"]
    _check_tensor(emb, "tok_emb", (torch.bfloat16, torch.float32), dev, who)
    if emb.shape[-1] != d or emb.shape[0] < V:
        raise ValueError(f"{who}: tok_emb {tuple(emb.shape)} does not cover "
                         f"the lm_head's {V} tokens")
    emb = emb.to(torch.bfloat16).contiguous()  # the JAX kernel's bf16 rows
    units = _units(d, lm)[1]
    lm_plan = []

    def lm_extra(grid):
        ct, ups = gemv_tiling(V, units, cpt, grid)
        tiles, splits = -(-V // (ct * cpt)), -(-units // ups)
        lm_plan.extend((ct, ups, tiles))
        return (splits * V if splits > 1 else 0, tiles)

    launch, occ = kernel_fns(CHUNK_SOURCE, "fused_decode_chunk", _ChunkArgs)
    a, _, keep = step_args(
        who, cfg, params, x0, k_cache, v_cache, pos, sin, cos,
        gemv_int8_flags(blocks, nt),
        lambda kind, smem: blocks_per_sm(CHUNK_SOURCE, occ, dev, kind, smem),
        extra=lm_extra, grid=grid)
    ct, ups, tiles = lm_plan
    tokens = torch.empty(steps, dtype=torch.int32, device=dev)
    c = _ChunkArgs()
    c.f = a
    if lm_kind == W_INT8:
        c.lm, c.lm_s = lm.q.data_ptr(), lm.s.data_ptr()
    else:
        c.lm = lm.data_ptr()
    c.emb, c.tokens = emb.data_ptr(), tokens.data_ptr()
    c.pmax = _ws(dev, "pmax", tiles, torch.float32).data_ptr()
    c.pidx = _ws(dev, "pidx", tiles, torch.int32).data_ptr()
    c.steps, c.vocab, c.lm_kind, c.lm_g = steps, V, lm_kind, lm_g
    c.lm_s_bf16, c.lm_int8a, c.lm_ct, c.lm_ups = int(lm_s_bf16), int(lm_int8), ct, ups
    rc = launch(ctypes.byref(c), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{who}: cooperative launch failed, CUDA error {rc}")
    fused_decode_chunk.launches += 1
    fused_decode_chunk.plan = plan_summary(a, dev, (ct, ups, V, lm_kind, lm_g))
    return tokens, k_cache, v_cache


fused_decode_chunk.launches = 0
fused_decode_chunk.plan = None
