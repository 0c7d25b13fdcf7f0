"""The big-model B = 1 decode megakernel (Llama-2-7B, Llama-3-8B class):
one launch per decode step for the whole layer stack, its routing plan and
its plain PyTorch version.

Port of kuiperllama_tpu/ops/pallas/fused_decode_big.py (`_kernel`, entry
`fused_decode_step_big`). The CUDA source is csrc/fused_decode_big.cu; its
header says what bounds it on the card and how its design deals with that.

Contract: as `fused_decode.fused_decode_step` (x0 [1, d], caches
[L, A, KH*hd] with contiguous rows, pos a one-element int32 tensor with
pos < A; the new K/V rows land at slot `pos` in place; returns (x_final,
k_cache, v_cache)). The differences from the small megakernel:
  * int8 weights only (the JAX plan rejects dense ones);
  * every GEMV (qkv, wo, gate/up, w2) takes the int8 activation when
    `int8_a` is true (default KT_BIG_INT8, ops/tuning.py), the bf16
    activation when false; the small kernel chooses per projection;
  * the JAX kernel tiles every projection (plan_big: NQ qkv column tiles,
    NO wo row tiles, NT FFN column tiles). Each tile edge is a group edge,
    so the tiles change only the fp32 order of the wo and w2 sums, which
    the plain version repeats: partial sums added in tile order.

The plan decides the route (the Generator takes this kernel under
KT_FUSED_BIG=1 when the small plan does not fit and this one does). It
follows the JAX `plan_big` to the letter, on the JAX package's padded scale
rows: at group 256 with bf16 scales the wo row tile must be a multiple of
16 g = 4096 rows, which exceeds the tile budget at Llama-2-7B, so there is
no plan there; group 64, or fp32 scales, plan.

On the CPU `fused_decode_step_big` runs the plain version; on a CUDA tensor
it launches the kernel or raises. `fused_decode_step_big.launches` counts
launches; `.plan` holds the last launch's `walk_summary`.

Scratch (ops/kernels/workspace.py): the kernel's phases that may overlap
(wo after qkv, w2 after gate/up: completion flags, not grid barriers,
separate them) keep their split partials and counters apart, the
completion flags follow the split counters, and the residual stream takes
two d-float buffers. The CUDA source alone knows that layout: its C entry
`fused_decode_big_scratch` gives the sizes the wrapper allocates. The
kernel leaves counters and flags at zero.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...quant import QuantTensor
from ..tuning import BIG_INT8
from . import build
from . import fused_decode as fd

SOURCE = "fused_decode_big"

# The JAX plan's numbers (fused_decode_big.py `_TILE_BUDGET`, `plan_big`):
# on the TPU they budget VMEM; here they decide the route and the NO and NT
# tile counts, which set the fp32 order of the wo and w2 sums. Tests patch
# _TILE_BUDGET as the JAX package's tests patch theirs.
_TILE_BUDGET = 9 * (1 << 20)
_VMEM_LIMIT = fd._VMEM_LIMIT  # bound at import, as the JAX module binds it


def _pick_div(dim: int, quantum: int, cap_bytes: int, row_bytes: int):
    """Largest multiple-of-`quantum` divisor of dim with
    tile * row_bytes <= cap_bytes; None if nothing divides."""
    best = None
    for k in range(1, dim // quantum + 1):
        t = k * quantum
        if dim % t == 0 and t * row_bytes <= cap_bytes:
            best = t
    return best


def plan_big(blocks, cache_dtype=torch.bfloat16, active_len: int = 1024):
    """Tiling plan of the big-model megakernel, dict(TQ, NQ, TR, NO, ht, NT),
    or None when the model does not take it (dense weights, dims that do not
    divide, or the JAX VMEM estimate over its budget). Reads only shapes and
    dtypes, so shape-only stand-ins (tensors on the "meta" device) do."""
    if "wqkv" not in blocks or "w13" not in blocks:
        return None
    wqkv, wo, w13, w2 = (blocks.get(n) for n in ("wqkv", "wo", "w13", "w2"))
    if not isinstance(wqkv, QuantTensor):
        return None
    g = wqkv.group_size
    d, QCOLS = fd._kn(wqkv)
    hidden = fd._kn(w2)[0]
    if d % g or hidden % g or QCOLS % 128 or d % 128:
        return None
    ngd = d // g
    # the JAX plan compares its padded scale rows with d / g
    for w in (wqkv, w13, wo):
        if fd.padded_groups(fd._kn(w)[0] // g) != ngd:
            return None
    sdt = wqkv.s.element_size()
    TQ = _pick_div(QCOLS, 128, _TILE_BUDGET, d)
    squant = (16 if sdt == 2 else 8) * g  # wo row tile: whole scale-row blocks
    TR = _pick_div(d, squant, _TILE_BUDGET, d)
    ht = _pick_div(hidden, max(128, g), _TILE_BUDGET, 3 * d)
    if TQ is None or TR is None or ht is None:
        return None
    if hidden // ht > 64:
        return None  # degenerate tiling; the layered path instead
    NQ, NO, NT = QCOLS // TQ, d // TR, hidden // ht
    slab = active_len * d * fd._itemsize(cache_dtype)
    est = 2 * (TQ * d + TQ * ngd * sdt
               + TR * d + (TR // g) * d * sdt
               + 2 * d * ht + 2 * ngd * ht * sdt
               + ht * d + 8 * d * 4
               + 2 * slab)
    est += (NQ * TQ + 2 * d) * 4 + 2 * ngd * d
    if est > int(_VMEM_LIMIT * 0.82):
        return None
    return dict(TQ=TQ, NQ=NQ, TR=TR, NO=NO, ht=ht, NT=NT)


def fits_vmem_big(blocks, cache_dtype=torch.bfloat16,
                  active_len: int = 1024) -> bool:
    """Whether the model takes the big-model megakernel (the JAX package's
    name; on the card it is the routing rule, not a memory budget)."""
    return plan_big(blocks, cache_dtype, active_len) is not None


def fused_decode_step_big_ref(cfg, params, x0, k_cache, v_cache, pos, sin,
                              cos, int8_a=None):
    """The plain version: the JAX big `_kernel`'s arithmetic and rounding
    points in torch ops. int8_a None takes KT_BIG_INT8."""
    blocks = params["blocks"]
    A = k_cache.shape[1]
    plan = plan_big(blocks, k_cache.dtype, A)
    if plan is None:
        raise ValueError("fused_decode_step_big_ref: the model does not fit "
                         "the big megakernel's plan")
    p_i = fd._pos_value(pos)
    if not 0 <= p_i < A:
        raise ValueError(f"fused_decode_step_big_ref: pos {p_i} outside [0, {A})")
    flags = (BIG_INT8 if int8_a is None else bool(int8_a),) * 4
    x = fd._layers_ref(cfg, blocks, x0.reshape(-1).float(), k_cache, v_cache,
                       p_i, p_i, sin, cos, flags, plan["NT"], plan["NO"])
    xo = fd._rmsnorm_bf16(x, params["final_norm"], cfg.norm_eps)
    return xo.reshape(1, -1).to(x0.dtype), k_cache, v_cache


def _scratch_sizes(a) -> tuple:
    """(fp32 partials, counter words, residual floats) of a launch with the
    filled `_Args` a, from the kernel's `fused_decode_big_scratch`."""
    fn = build.entry(SOURCE, "fused_decode_big_scratch",
                     [ctypes.POINTER(fd._Args)] + [ctypes.POINTER(ctypes.c_int)] * 3)
    out = [ctypes.c_int(0) for _ in range(3)]
    rc = fn(ctypes.byref(a), *(ctypes.byref(v) for v in out))
    if rc != 0:
        raise ValueError("fused_decode_step_big: the plan's column tiles or the "
                         f"model's {a.H} heads exceed the kernel's split counters "
                         f"and flags (CUDA error {rc})")
    return tuple(v.value for v in out)


@functools.lru_cache(maxsize=64)
def _flushes(g: int, phases: tuple) -> int:
    """The flushes of one layer; phases: each GEMV phase's (K, halves, column
    threads, units per split, column tiles, int8 activation). Cached: a
    launch's plan repeats every step, and the count walks every lane."""
    qpg, flushes = g // 4, 0
    for K, halves, ct, ups, tiles, int8 in phases:
        klanes, per_tile = fd._THREADS // ct, 0
        for sp in range(-(-(K // g) // ups)):
            row0, row1 = sp * ups * g, min(K, (sp + 1) * ups * g)
            if not int8:
                per_tile += klanes * (row1 - row0) // g
                continue
            base, nq = row0 // 4, (row1 - row0) // 4
            for kl in range(klanes):
                c0, c1 = base + kl * nq // klanes, base + (kl + 1) * nq // klanes
                if c1 > c0:
                    per_tile += (c1 - 1) // qpg - c0 // qpg + 1
        flushes += per_tile * ct * halves * tiles
    return flushes


def walk_summary(a, device) -> dict:
    """`fused_decode.plan_summary` of a big-kernel launch's `_Args`, with
    each GEMV phase's work items and the step's flushes: the times a lane
    scales its sums into its accumulators. With int8 activations a k-lane
    walks a contiguous run of its split's quads and flushes once per group
    the run touches (csrc/fused_decode_big.cu `lane_run`, `stream_int8`);
    with bf16 activations every k-lane flushes once per group of the
    split."""
    out = fd.plan_summary(a, device)
    phases = []
    for i, (name, K, halves) in enumerate((("qkv", a.d, 1), ("wo", a.H * a.hd, 1),
                                           ("gate_up", a.d, 2), ("w2", a.hidden, 1))):
        ph = out["phases"][name]
        ph["items"] = ph["tiles"] * ph["splits"]
        phases.append((K, halves, a.col_threads[i], a.units_per_split[i], ph["tiles"],
                       bool(a.int8_act[i])))
    out["flushes_per_step"] = _flushes(a.g, tuple(phases)) * a.L
    return out


def fused_decode_step_big(cfg, params, x0, k_cache, v_cache, pos, sin, cos,
                          int8_a=None, trace=None, grid=None):
    """One decode step of the whole layer stack for B = 1 at big-model
    geometry (see the module docstring). CPU tensors take the plain version;
    CUDA tensors launch csrc/fused_decode_big.cu once, or raise.

    trace: optional int64 CUDA tensor of 2 + 5 L elements, filled as the
    small kernel fills it (`fused_decode.phase_times` reads it). grid: the
    launch's blocks (tests run blocks that take several items; default
    every block that fits, at most two per SM). `fused_decode_step_big.plan`
    holds the last launch's `walk_summary`."""
    if x0.device.type == "cpu":
        return fused_decode_step_big_ref(cfg, params, x0, k_cache, v_cache,
                                         pos, sin, cos, int8_a)
    who = "fused_decode_step_big"
    blocks = params["blocks"]
    if plan_big(blocks, k_cache.dtype, k_cache.shape[1]) is None:
        raise ValueError(f"{who}: the model does not fit the big megakernel's "
                         "plan")
    g = blocks["wqkv"].group_size
    if g % 8:
        raise ValueError(f"{who}: group size {g} must be a multiple of 8, the "
                         "kernel's staging load")
    int8_a = BIG_INT8 if int8_a is None else bool(int8_a)
    launch, occ = fd.kernel_fns(SOURCE, "fused_decode_big")
    a, x_out, keep = fd.step_args(
        who, cfg, params, x0, k_cache, v_cache, pos, sin, cos, (int8_a,) * 4,
        lambda kind, smem: fd.blocks_per_sm(SOURCE, occ, x0.device,
                                            int(int8_a), smem),
        trace=trace, grid=grid)
    parts, words, x_floats = _scratch_sizes(a)
    a.partial = fd._ws(x0.device, "partial", parts, torch.float32).data_ptr()
    a.counters = fd._ws(x0.device, "counters", words, torch.int32, zero=True).data_ptr()
    a.x = fd._ws(x0.device, "x", x_floats, torch.float32).data_ptr()
    rc = launch(ctypes.byref(a), torch.cuda.current_stream(x0.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{who}: cooperative launch failed, CUDA error {rc}")
    fused_decode_step_big.launches += 1
    fused_decode_step_big.plan = walk_summary(a, x0.device)
    return x_out, k_cache, v_cache


fused_decode_step_big.launches = 0
fused_decode_step_big.plan = None


def kernel_attributes(int8_a=None) -> dict:
    """The compiled kernel variant's registers a thread and local-memory
    bytes a thread (where ptxas spills), from cudaFuncGetAttributes. Needs
    the card."""
    fn = build.entry(SOURCE, "fused_decode_big_attributes",
                     [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                      ctypes.POINTER(ctypes.c_int)])
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    variant = int(BIG_INT8 if int8_a is None else bool(int8_a))
    rc = fn(variant, ctypes.byref(regs), ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"fused_decode_big: attribute query failed, CUDA error {rc}")
    return dict(registers=regs.value, local_bytes=local.value)
