"""The small megakernels' schedule and arithmetic (csrc/fused_decode.cu,
csrc/fused_decode_chunk.cu on csrc/fused_decode_common.cuh), on the CPU.

Schedule: the wrapper's plan (`gemv_tiling`, the launch's grid) on
shape-only stand-ins of chip_smoke's FUSED_CASES and CHUNK_CASES
geometries at grids 1, 8, 33, 132 and 264: block b takes items b, b + grid,
... of every phase in order, every (column tile, K split) once; the splits
tile the rows in whole units; what a phase reads is written by the phase
before its grid barrier; a tile's split counter counts its splits, and the
last split adds them in split order whatever order they arrive in.

Arithmetic: the kernel's GEMV emulated lane by lane in torch (the k-lanes'
shares of each group or unit, the int8 byte-permute conversion, the fma
points, `tile_reduce`'s order, the splits added in order) is held to the
plain version's `_gemv_ref` within 1e-5 of max|ref| (only the fp32 order of
sums differs), and, swapped into the plain step, to JAX's `_fused_step`
under the Pallas interpreter within tests/test_torch_fused_decode.py's
tolerances.
"""

import numpy as np
import pytest
import torch

from kuiperllama_tpu_torch.config import preset_config
from kuiperllama_tpu_torch.ops.kernels import fused_decode as tfd
from kuiperllama_tpu_torch.quant import QuantTensor, quantize_q80

import test_torch_fused_decode as tfdt
from torch_threads import one_thread  # noqa: F401

THREADS = 256
GRIDS = [1, 8, 33, 132, 264]
# chip_smoke.py FUSED_CASES and CHUNK_CASES: (preset, INT8, group size)
CASES = [("tinyllama-1.1b", True, 256), ("llama3.2-1b", True, 256),
         ("qwen2.5-0.5b", False, 0), ("tinyllama-1.1b", True, 64)]


def _phases(cfg, quant, g, lm=True):
    """(name, K, ncols, halves, kind, group) of every GEMV phase, with the
    chunk kernel's lm_head, from the preset's shapes."""
    d, hd, H, KH, hid = cfg.dim, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.hidden_dim
    kind = tfd.W_INT8 if quant else tfd.W_BF16
    out = [("qkv", d, (H + 2 * KH) * hd, 1), ("wo", H * hd, d, 1),
           ("gate_up", d, hid, 2), ("w2", hid, d, 1)]
    out = [(n, K, nc, hv, kind, g) for n, K, nc, hv in out]
    if lm:
        out.append(("lm_head", d, cfg.vocab_size, 1, kind, g))
    return out


def _plan(K, ncols, kind, g, grid):
    """(ct, ups, W, unit, tiles, splits) as the wrapper plans the phase."""
    cpt = tfd._COLS_PER_THREAD[kind]
    unit = g if kind == tfd.W_INT8 else (64 if K % 64 == 0 else K)
    ct, ups = tfd.gemv_tiling(ncols, K // unit, cpt, grid)
    W = ct * cpt
    return ct, ups, W, unit, -(-ncols // W), -(-(K // unit) // ups)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("preset,quant,g", CASES)
def test_schedule_covers_every_item_once(preset, quant, g, grid):
    cfg = preset_config(preset)
    for name, K, ncols, halves, kind, gg in _phases(cfg, quant, g):
        ct, ups, W, unit, tiles, splits = _plan(K, ncols, kind, gg, grid)
        assert THREADS % ct == 0 and W % tfd._COLS_PER_THREAD[kind] == 0
        items = tiles * splits
        # the plan fills the grid without a second round wherever it can
        if tiles <= grid:
            assert items <= grid, (name, items, grid)
        done = []
        for b in range(grid):
            mine = list(range(b, items, grid))
            assert mine == sorted(mine)
            done += mine
        assert sorted(done) == list(range(items))
        # the splits tile [0, K) in whole units, in order
        rows = [(s * ups * unit, min(K, (s + 1) * ups * unit)) for s in range(splits)]
        assert rows[0][0] == 0 and rows[-1][1] == K
        assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
        assert all((r1 - r0) % unit == 0 for r0, r1 in rows)
        # the column tiles cover every column (both halves of gate/up)
        assert tiles * W >= ncols > (tiles - 1) * W
        # a tile's split counter: one arrival per split, the last adds
        arrivals = [0] * tiles
        for it in range(items):
            arrivals[it // splits] += 1
        assert arrivals == [splits] * tiles


@pytest.mark.parametrize("grid", [8, 264])
@pytest.mark.parametrize("preset,quant,g", CASES)
def test_each_phase_reads_what_the_one_before_wrote(preset, quant, g, grid):
    """Between two grid barriers a phase reads only what the phase before
    wrote: qkv columns for each attention head, attention's head rows for
    each wo split, the residual's columns for gate/up and the next qkv, and
    gate/up's columns for each w2 split, each written by exactly one tile."""
    cfg = preset_config(preset)
    ph = {n: (K, nc, kind, gg) for n, K, nc, _, kind, gg in _phases(cfg, quant, g, lm=False)}

    def writers(name):
        K, ncols, kind, gg = ph[name]
        _, _, W, _, tiles, _ = _plan(K, ncols, kind, gg, grid)
        cover = np.zeros(ncols, int)
        for t in range(tiles):
            cover[t * W:min(ncols, (t + 1) * W)] += 1
        return cover

    hd, H, KH = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    qkv = writers("qkv")
    assert (qkv == 1).all()
    for h in range(H):  # a head reads its q, its KV group's k and v
        kh = h // (H // KH)
        for c0 in (h * hd, (H + kh) * hd, (H + KH + kh) * hd):
            assert (qkv[c0:c0 + hd] == 1).all()
    # attention writes every row wo's splits read, head by head
    K, _, kind, gg = ph["wo"]
    _, ups, _, unit, _, splits = _plan(K, ph["wo"][1], kind, gg, grid)
    heads_of = [set(range(s * ups * unit // hd, -(-min(K, (s + 1) * ups * unit) // hd)))
                for s in range(splits)]
    assert set().union(*heads_of) == set(range(H))
    assert (writers("wo") == 1).all() and (writers("w2") == 1).all()  # the residual
    assert (writers("gate_up") == 1).all()  # every row of w2 (act)


def test_last_split_adds_in_split_order_whatever_arrives_last():
    rng = np.random.default_rng(0)
    parts = rng.standard_normal((8, 64)).astype(np.float32) * 10.0 ** rng.integers(-3, 4, (8, 64))
    want = np.float32(0)
    for p in parts:
        want = np.float32(want + p)
    for order in (range(8), reversed(range(8)), rng.permutation(8)):
        buf = np.zeros_like(parts)
        for s in order:  # each split stores its partial; the last sums them
            buf[s] = parts[s]
        got = np.zeros(64, np.float32)
        for s in range(8):
            got = np.float32(got + buf[s])
        np.testing.assert_array_equal(got, want)


def test_int8_byte_permute_is_exact():
    """csrc `i8f`: byte j of (w ^ 0x80808080) placed into the low mantissa
    byte of 2^23 (`__byte_perm(w, 0x4B000000, 0x7540 + j)`), minus 2^23 +
    128, is the int8 value, for every byte value in every position."""
    q = np.arange(-128, 128, dtype=np.int8)
    for j in range(4):
        packed = np.zeros(256, np.uint32)
        packed |= (q.view(np.uint8).astype(np.uint32) << (8 * j))
        flipped = packed ^ np.uint32(0x80808080)
        byte = (flipped >> np.uint32(8 * j)) & np.uint32(0xFF)
        bits = np.uint32(0x4B000000) | byte
        f = bits.view(np.float32) - np.float32(8388736.0)
        np.testing.assert_array_equal(f, q.astype(np.float32))


# ---------------------------------------------------------------------------
# The kernel's GEMV, lane by lane


def _fma(a, b, c):
    """fmaf: one rounding of a * b + c (the product is exact in fp64)."""
    return (a.double() * b.double() + c.double()).float()


def kernel_gemv(h, w, int8_a, grid):
    """What csrc gemv_phase + finish_item compute for one projection (all
    columns): a column's k-lanes (256 / ct) take their share of each group
    (int8) or of the split's rows (dense), fma by fma as the kernel does;
    `tile_reduce` adds the lanes in P = 256 / W strided parts, then the
    parts; the last split adds the splits in order."""
    h = h.float()
    if isinstance(w, QuantTensor):
        K, N = w.q.shape
        kind, g = tfd.W_INT8, w.group_size
        q = w.q.float()
        s = w.s.float()
    else:
        K, N = w.shape
        kind, g = (tfd.W_BF16 if w.dtype == torch.bfloat16 else tfd.W_FP32), 0
        q = w.float()
    ct, ups, W, unit, _, splits = _plan(K, N, kind, g, grid)
    klanes, P = THREADS // ct, THREADS // W
    outs = []
    for sp in range(splits):
        r0, r1 = sp * ups * unit, min(K, (sp + 1) * ups * unit)
        acc = torch.zeros((klanes, N))
        if kind == tfd.W_INT8:
            for grp in range(r0 // g, r1 // g):
                kb = grp * g
                hg = h[kb:kb + g]
                if int8_a:
                    amax = hg.abs().max()
                    dd = amax / 127.0 if amax > 0 else torch.tensor(1.0)
                    aq = torch.round(hg / dd).double()
                for kl in range(klanes):
                    if int8_a:
                        rows = [kb + 4 * c + i for c in range(kl, g // 4, klanes) for i in range(4)]
                        ip = (aq[[r - kb for r in rows], None] * q[rows].double()).sum(0)
                        acc[kl] = _fma(ip.float() * dd, s[grp], acc[kl])
                    else:
                        part = torch.zeros(N)
                        for k in range(kl, g, klanes):
                            part = _fma(h[kb + k], q[kb + k], part)
                        acc[kl] = _fma(part, s[grp], acc[kl])
        else:
            for kl in range(klanes):
                for r in range(r0 + kl, r1, klanes):
                    acc[kl] = _fma(h[r], q[r], acc[kl])
        red2 = torch.zeros((P, N))
        for p in range(P):
            for lane in range(p, klanes, P):
                red2[p] = red2[p] + acc[lane]
        out = torch.zeros(N)
        for p in range(P):
            out = out + red2[p]
        outs.append(out)
    if splits == 1:
        return outs[0]
    v = torch.zeros(N)
    for o in outs:
        v = v + o
    return v


def _weight(kind, K, N, g, rng):
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32) * 0.05)
    if kind == "int8":
        return quantize_q80(w, group_size=g)
    if kind == "int8_bf16s":
        qt = quantize_q80(w, group_size=g)
        return QuantTensor(q=qt.q, s=qt.s.to(torch.bfloat16), group_size=g)
    return w.to(torch.bfloat16) if kind == "bf16" else w


@pytest.mark.parametrize("grid", [8, 33, 264])
@pytest.mark.parametrize("kind,g,int8_a,K,N", [
    ("int8", 32, False, 256, 512), ("int8_bf16s", 64, False, 512, 256),
    ("int8", 8, True, 256, 384), ("int8_bf16s", 32, True, 512, 256),
    ("bf16", 0, False, 256, 512), ("fp32", 0, False, 512, 128),
])
def test_kernel_gemv_matches_plain(kind, g, int8_a, K, N, grid):
    rng = np.random.default_rng(K + N + g)
    h = tfd._bf16(torch.from_numpy(rng.standard_normal(K).astype(np.float32)))
    w = _weight(kind, K, N, g, rng)
    got = kernel_gemv(h, w, int8_a, grid)
    want = tfd._gemv_ref(h, w, int8_a)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("grid", [8, 264])
@pytest.mark.parametrize("family,quant", [("llama2", True), ("qwen2", True),
                                          ("llama2", False), ("qwen2", False)])
def test_kernel_step_matches_jax(family, quant, grid, monkeypatch):
    """The plain step with every GEMV in the kernel's order, against JAX's
    `_fused_step` under the Pallas interpreter (tests/test_torch_fused_decode
    `_check_step`: x_final and every layer's new rows within 1e-2, layer 0's
    within one bf16 ulp)."""
    monkeypatch.setattr(tfd, "_gemv_ref",
                        lambda h, w, int8_a: kernel_gemv(h, w, int8_a, grid))
    tfdt._check_step(family, quant, 32, 1)
