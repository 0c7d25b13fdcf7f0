"""The big-model megakernel's GEMV walk (csrc/fused_decode_big.cu), emulated
on the CPU, since the kernel itself runs only on the card.

The emulation follows the int8-activation walk lane by lane: the wrapper's
plan (`gemv_tiling`: CT column threads of 16 columns, 256 / CT k-lanes, K
split in whole groups); an item's activation staged as eight values a
thread, the g / 8 threads of a group finding its amax by an xor-shuffle
tree, then quantized as JAX's `_quant_act`; k-lane kl walking the
contiguous run of quads [kl nq / klanes, (kl + 1) nq / klanes) of the
split, summing __dp4a products in int32 over the part of each group its run
covers and scaling them once at the group's end (fma by fma); the block's
`tile_reduce` adding the k-lanes in 256 / W strided parts, then the parts;
the last split adding the splits in split order.

Held to the JAX package's `_quant_act` and `_gemv_from_act` (the big
`_kernel`'s GEMV) at single-projection 7B shapes within 1e-5 of max|ref|,
since the arithmetic is the same and only the fp32 order of the group sums
differs; the plain version's `_gemv_ref` as closely. A whole step with
every GEMV in the walk's order is held to JAX's big `_kernel` under the
Pallas interpreter at tests/test_torch_fused_decode_big.py's geometry and
tolerances (between phases the step rounds to bf16 and requantizes to int8,
which turns a last-bit fp32 difference into a bf16 or int8 step, so a step
is not held to 1e-5). The plan covers every (column tile, K split) once at
grids 1, 132 and 264, the k-lanes' runs every quad of a split once.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kuiperllama_tpu.ops.pallas import fused_decode as jfd
from kuiperllama_tpu.ops.pallas import fused_decode_big as jbig
from kuiperllama_tpu.models import decoder as jdec
from kuiperllama_tpu_torch.config import preset_config
from kuiperllama_tpu_torch.models import decoder
from kuiperllama_tpu_torch.ops.kernels import build
from kuiperllama_tpu_torch.ops.kernels import fused_decode as tfd
from kuiperllama_tpu_torch.ops.kernels import fused_decode_big as tfb
from kuiperllama_tpu_torch.ops.rope import apply_rope
from kuiperllama_tpu_torch.quant import QuantTensor

from test_torch_fused_decode_big import _hold, _pair, small_tiles  # noqa: F401
from torch_threads import one_thread  # noqa: F401

THREADS, WARPS = 256, 8
GRIDS = [1, 132, 264]
# The split counters a phase has (one per column tile): the kernel's own
# constant, which its `fused_decode_big_scratch` sizes the workspace by.
SPLIT_COUNTERS = int(re.search(r"\bkSplitB = (\d+)",
                               (build.CSRC / "fused_decode_big.cu").read_text()).group(1))


def _fma(a, b, c):
    """fmaf: one rounding of a * b + c (the product is exact in fp64)."""
    return (a.double() * b.double() + c.double()).float()


def stage_quant(h, g):
    """stage_split: thread t holds h[8 t, 8 t + 8) of the split; the g / 8
    threads of a group take the max of their maxima over an xor tree; then
    d = amax / 127 (1 where amax is 0) and Aq = rint(h / d). Returns (Aq as
    int64 [K], d fp32 [K / g])."""
    team = g // 8
    per_thread = h.float().abs().reshape(-1, 8).amax(dim=1)   # [K / 8]
    m = per_thread.reshape(-1, team).clone()                  # [groups, team]
    o = 1
    while o < team:
        m = torch.maximum(m, m[:, torch.arange(team) ^ o])
        o <<= 1
    assert (m == m[:, :1]).all()  # every thread of a group holds its amax
    amax = m[:, 0]
    dd = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    aq = torch.round(h.float().reshape(-1, g) / dd[:, None]).long().reshape(-1)
    return aq, dd


def lane_runs(row0, row1, klanes):
    """The kernel's `lane_run`: k-lane kl's quads [c0, c1) of the split."""
    base, nq = row0 // 4, (row1 - row0) // 4
    return [(base + kl * nq // klanes, base + (kl + 1) * nq // klanes)
            for kl in range(klanes)]


def walk_gemv(h, w, ncols, halves, grid, cols=None):
    """What gemv_phase_big (int8 activations), tile_reduce and finish_big
    compute for one projection's columns (the first `cols` of each half,
    whole tiles; default all): y [halves * ncols] fp32 before the
    epilogue."""
    q = w.q
    K, N = q.shape
    g = w.group_size
    ng, qpg = K // g, g // 4
    s = w.s[:ng].float()
    ct, ups = tfd.gemv_tiling(ncols, ng, 16, grid)
    W, klanes = ct * 16, THREADS // ct
    P = THREADS // W
    splits = -(-ng // ups)
    aq, dd = stage_quant(h, g)
    y = torch.zeros(halves * ncols)
    for tile in range(-(-(cols or ncols) // W)):
        width = min(W, ncols - tile * W)  # lanes past ncols are dead
        parts = []
        for split in range(splits):
            row0 = split * ups * g
            row1 = min(K, row0 + ups * g)
            out = torch.zeros((halves, width))
            for hh in range(halves):
                c0 = hh * ncols + tile * W
                acc = torch.zeros((klanes, width))
                for kl, (q0, q1) in enumerate(lane_runs(row0, row1, klanes)):
                    start = q0
                    while start < q1:  # the run's part of one group, then its flush
                        grp = start // qpg
                        end = min(q1, (grp + 1) * qpg)
                        rows = slice(4 * start, 4 * end)
                        ip = (aq[rows, None] * q[rows, c0:c0 + width].long()).sum(dim=0)
                        assert int(ip.abs().max()) < 2 ** 31
                        t = ip.float() * dd[grp]
                        acc[kl] = _fma(t, s[grp, c0:c0 + width], acc[kl])
                        start = end
                red2 = torch.zeros((P, width))
                for p in range(P):
                    for lane in range(p, klanes, P):
                        red2[p] = red2[p] + acc[lane]
                o = torch.zeros(width)
                for p in range(P):
                    o = o + red2[p]
                out[hh] = o
            parts.append(out)
        v = parts[0]
        if splits > 1:
            v = torch.zeros((halves, width))
            for p in parts:
                v = v + p
        for hh in range(halves):
            lo = hh * ncols + tile * W
            y[lo:lo + width] = v[hh]
    return y


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _projection(seed, K, N, g, s_bf16):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal(K).astype(np.float32)
    h = torch.from_numpy(h).to(torch.bfloat16).float()
    q = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8))
    s = torch.from_numpy(rng.uniform(0.005, 0.02, (K // g, N)).astype(np.float32))
    if s_bf16:
        s = s.to(torch.bfloat16)
    return h, QuantTensor(q=q, s=s, group_size=g)


# (projection, K, the real projection's ncols, halves) at Llama-2-7B;
# 256 columns of each half are emulated, with the real width's plan
PROJECTIONS = [("qkv", 4096, 12288, 1), ("wo", 4096, 4096, 1),
               ("gate_up", 4096, 11008, 2), ("w2", 11008, 4096, 1)]


@pytest.mark.parametrize("name,K,ncols,halves", PROJECTIONS)
@pytest.mark.parametrize("g", [64, 256])
@pytest.mark.parametrize("s_bf16", [False, True])
def test_walk_matches_jax_projection(name, K, ncols, halves, g, s_bf16):
    cols = 256
    h, w = _projection(K + ncols + g, K, halves * ncols, g, s_bf16)
    got = walk_gemv(h, w, ncols, halves, 264, cols=cols)
    ng = K // g
    hj = jnp.asarray(h.numpy(), jnp.bfloat16)
    Aq, d = jfd._quant_act(hj[None, :], ng, K, g)
    # the activation as the kernel stages it is JAX's, bit for bit
    aq, dd = stage_quant(h, g)
    Aq = np.asarray(Aq)
    assert np.array_equal(Aq.sum(axis=0), aq.numpy())
    assert np.array_equal(np.asarray(d)[:, 0], dd.numpy())
    for hh in range(halves):
        c = slice(hh * ncols, hh * ncols + cols)
        sj = jnp.asarray(w.s[:, c].float().numpy(),
                         jnp.bfloat16 if s_bf16 else jnp.float32)
        want = jfd._gemv_from_act(jnp.asarray(Aq), d, jnp.asarray(w.q[:, c].numpy()),
                                  sj, ())
        assert _rel(got[c], want[0]) <= 1e-5
        plain = tfd._gemv_ref(h, QuantTensor(q=w.q[:, c], s=w.s[:, c], group_size=g),
                              True)
        assert _rel(got[c], plain) <= 1e-5


def kernel_rmsnorm(x, w, eps):
    """stage_split's norm: each thread's fma sum of squares over its eights
    (k = 8 t + 2048 i) in order, the warps' xor trees, the warps added in
    order; rn = 1 / sqrt(ss / d + eps); bf16(x * rn * w)."""
    d = x.numel()
    part = torch.zeros(THREADS)
    for base in range(0, d, THREADS * 8):
        for j in range(8):
            idx = base + torch.arange(THREADS) * 8 + j
            ok = idx < d
            v = x[idx.clamp(max=d - 1)]
            part = torch.where(ok, _fma(v, v, part), part)
    lanes = part.reshape(WARPS, 32)
    o = 16
    while o >= 1:
        lanes = lanes + lanes[:, torch.arange(32) ^ o]
        o //= 2
    t = torch.zeros(())
    for i in range(WARPS):
        t = t + lanes[i, 0]
    rn = 1.0 / torch.sqrt(t / d + torch.tensor(eps, dtype=torch.float32))
    return tfd._bf16(x * rn * w.float())


def walk_step(cfg, params, x0, k_cache, v_cache, pos, sin, cos, grid):
    """One step of the plain version's layer stack with every GEMV in the
    walk's order and the norms in the kernel's; the caches take the new rows
    in place. Returns x_final [1, d] in x0's dtype."""
    blocks = params["blocks"]
    d, H, KH, hd, hidden = tfd._geometry(cfg, blocks)
    g = blocks["wqkv"].group_size
    pr = min(pos, cfg.seq_len - 1)
    s_row, c_row = sin[pr].float(), cos[pr].float()
    scale = tfd.attention_scale(hd)

    def layer_w(name, li):
        w = blocks[name]
        return QuantTensor(q=w.q[li], s=w.s[li][:w.q.shape[1] // g], group_size=g)

    x = x0.reshape(-1).float()
    for li in range(k_cache.shape[0]):
        h1 = kernel_rmsnorm(x, blocks["attn_norm"][li], cfg.norm_eps)
        y = walk_gemv(h1, layer_w("wqkv", li), (H + 2 * KH) * hd, 1, grid)
        if "bqkv" in blocks:
            y = y + blocks["bqkv"][li].float()
        y = tfd._bf16(y)
        q = tfd._bf16(apply_rope(y[:H * hd].reshape(1, H, hd), s_row, c_row,
                                 cfg.rope_style))[0]
        k = tfd._bf16(apply_rope(y[H * hd:(H + KH) * hd].reshape(1, KH, hd), s_row,
                                 c_row, cfg.rope_style))[0]
        v = y[(H + KH) * hd:].reshape(KH, hd)
        attn = tfd._attend_ref(q, k, v, k_cache[li, :pos], v_cache[li, :pos], scale,
                               k_cache.dtype)
        k_cache[li, pos] = k.reshape(-1).to(k_cache.dtype)
        v_cache[li, pos] = v.reshape(-1).to(v_cache.dtype)
        x = tfd._bf16(x + walk_gemv(attn, layer_w("wo", li), d, 1, grid))
        h2 = kernel_rmsnorm(x, blocks["ffn_norm"][li], cfg.norm_eps)
        gu = walk_gemv(h2, layer_w("w13", li), hidden, 2, grid)
        gate, up = tfd._bf16(gu[:hidden]), tfd._bf16(gu[hidden:])
        act = tfd._bf16(tfd._bf16(gate * torch.sigmoid(gate)) * up)
        x = tfd._bf16(x + walk_gemv(act, layer_w("w2", li), d, 1, grid))
    xo = kernel_rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return xo.reshape(1, -1).to(x0.dtype)


@pytest.mark.parametrize("grid", [8, 264])
@pytest.mark.parametrize("family", ["llama2", "qwen2"])
def test_walk_step_matches_jax_kernel(family, grid, small_tiles):  # noqa: F811
    jc, tc, jp, tp = _pair(family)
    L, KV, A, pos = jc.n_layers, jc.kv_dim, 32, 9
    rng = np.random.default_rng(11)
    kc = jnp.asarray(rng.standard_normal((L, A, KV)), jnp.bfloat16)
    vc = jnp.asarray(rng.standard_normal((L, A, KV)), jnp.bfloat16)
    sin, cos = jdec.build_rope(jc)
    xj, kj, vj = jbig.fused_decode_step_big(
        jc, jp, jp["tok_emb"][jnp.asarray([7])], kc, vc, jnp.int32(pos), sin, cos,
        int8_a=True)
    kt = torch.from_numpy(np.asarray(kc, np.float32)).to(torch.bfloat16)
    vt = torch.from_numpy(np.asarray(vc, np.float32)).to(torch.bfloat16)
    tsin, tcos = decoder.build_rope(tc, "cpu")
    xt = walk_step(tc, tp, tp["tok_emb"][[7]], kt, vt, pos, tsin, tcos, grid)
    _hold(np.asarray(xj, np.float32), xt.float().numpy(),
          (np.asarray(kj, np.float32), np.asarray(vj, np.float32)),
          (kt.float().numpy(), vt.float().numpy()), pos, jc.head_dim, True)


# chip_smoke.py BIG_CASES and the CPU tests' dim 512 geometry: (preset or
# None, group size)
GEOMETRIES = [("llama2-7b", 64), ("llama2-7b", 256), ("llama3-8b", 64), (None, 32)]


def _phases(preset, g):
    if preset is None:
        d, H, KH, hd, hidden = 512, 4, 2, 128, 512
    else:
        cfg = preset_config(preset)
        d, H, KH, hd, hidden = (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                cfg.hidden_dim)
    return [("qkv", d, (H + 2 * KH) * hd, 1), ("wo", H * hd, d, 1),
            ("gate_up", d, hidden, 2), ("w2", hidden, d, 1)]


def _flushes(K, ncols, halves, g, grid):
    """Lane flushes of one phase: every k-lane of every column thread once
    per group its run touches, in every (tile, split, half)."""
    ct, ups = tfd.gemv_tiling(ncols, K // g, 16, grid)
    qpg, n = g // 4, 0
    for sp in range(-(-(K // g) // ups)):
        row0, row1 = sp * ups * g, min(K, (sp + 1) * ups * g)
        n += sum((c1 - 1) // qpg - c0 // qpg + 1
                 for c0, c1 in lane_runs(row0, row1, THREADS // ct) if c1 > c0)
    return n * ct * halves * -(-ncols // (16 * ct))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("preset,g", GEOMETRIES)
def test_plan_covers_every_item_once(preset, g, grid):
    for name, K, ncols, halves in _phases(preset, g):
        ng, qpg = K // g, g // 4
        ct, ups = tfd.gemv_tiling(ncols, ng, 16, grid)
        W, klanes = ct * 16, THREADS // ct
        tiles, splits = -(-ncols // W), -(-ng // ups)
        items = tiles * splits
        # block b takes items b, b + grid, ...: each (tile, split) once
        done = sorted(i for b in range(grid) for i in range(b, items, grid))
        assert done == list(range(items)), name
        # the splits tile [0, K) in whole groups, in order
        bounds = [(sp * ups * g, min(K, (sp + 1) * ups * g)) for sp in range(splits)]
        assert bounds[0][0] == 0 and bounds[-1][1] == K
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert all(lo % g == 0 and hi % g == 0 for lo, hi in bounds)
        for lo, hi in bounds:
            # the k-lanes' runs take every quad of the split once, in runs
            # that differ by at most one quad
            runs = lane_runs(lo, hi, klanes)
            assert runs[0][0] == lo // 4 and runs[-1][1] == hi // 4
            assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
            lens = [c1 - c0 for c0, c1 in runs]
            assert max(lens) - min(lens) <= 1
        # the split partials and counters of the phases that may overlap
        # (qkv with wo, gate/up with w2) fit their regions
        assert tiles <= SPLIT_COUNTERS and W <= 256


def _pr4_flushes(K, ncols, halves, g, grid):
    """The same count for the first port's strided walk: k-lane kl took
    quads kl, kl + klanes, ... of a split and flushed once per group among
    them."""
    ct, ups = tfd.gemv_tiling(ncols, K // g, 16, grid)
    klanes, qpg, n = THREADS // ct, g // 4, 0
    for sp in range(-(-(K // g) // ups)):
        base, end = sp * ups * g // 4, min(K, (sp + 1) * ups * g) // 4
        n += sum(len({c // qpg for c in range(base + kl, end, klanes)})
                 for kl in range(klanes))
    return n * ct * halves * -(-ncols // (16 * ct))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("preset,g", GEOMETRIES[:3])
def test_flushes_per_step(preset, g, grid, monkeypatch):
    """walk_summary's flush count against the runs counted here; at
    Llama-2-7B g 64 on 264 blocks it is under a sixth of the strided walk's,
    which flushed after every quad."""
    from types import SimpleNamespace

    cfg = preset_config(preset)
    a = SimpleNamespace(d=cfg.dim, H=cfg.n_heads, KH=cfg.n_kv_heads, hd=cfg.head_dim,
                        hidden=cfg.hidden_dim, g=g, L=cfg.n_layers, w_kind=tfd.W_INT8,
                        grid=grid, smem_bytes=0, int8_act=[1] * 4,
                        col_threads=[], units_per_split=[])
    want = pr4 = 0
    for name, K, ncols, halves in _phases(preset, g):
        ct, ups = tfd.gemv_tiling(ncols, K // g, 16, grid)
        a.col_threads.append(ct)
        a.units_per_split.append(ups)
        want += _flushes(K, ncols, halves, g, grid)
        pr4 += _pr4_flushes(K, ncols, halves, g, grid)
    monkeypatch.setattr(tfd, "_sms", lambda dev: 132)
    out = tfb.walk_summary(a, None)
    assert out["flushes_per_step"] == want * a.L
    assert want <= pr4
    if preset == "llama2-7b" and g == 64 and grid == 264:
        assert pr4 >= 6 * want
