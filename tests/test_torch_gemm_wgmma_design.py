"""The wgmma route of the GEMM's fast mode (csrc/quant_gemm.cu
`gemm_tma_kernel`), emulated on the CPU, since the kernel runs only on the
card.

- The int8 tile as its TMA box writes it (128-byte swizzle: 16-byte chunk c
  of k-row r stored at chunk c ^ (r % 8)), read by ldmatrix.x4.trans at each
  lane's address: lane (gr, t) gets k-rows (2t, 2t + 1), (2t + 8, 2t + 9) of
  block columns col = 16 chunk + 2 gr and col + 1, and each 8-address phase
  of the instruction touches 32 distinct banks (no conflict).
- x's tile as its TMA box writes it, read back through the wgmma B
  descriptor's address function (start address advanced 32 bytes a 16-k
  step and 1024 bytes an 8-row group, the swizzle applied to the address):
  it reproduces x.
- The A fragment of the PTX ISA's register layout for wgmma (warp w of the
  warpgroup: rows 16 w + gr and + 8, k 2t .. 2t + 1 and + 8), the
  accumulator layout of m64nNk16 (register 4 j + e: row gr, x row 8 j + 2t +
  e; 4 j + 2 + e: row gr + 8), N = M rounded up to 8 as one wgmma per set
  bit of N / 8, one after another (the layout of one m64nNk16), and the
  epilogue's map.
- The whole block with its K splits summed in split order, at M of 1, 8, 33
  and 255: against the JAX package's fast-mode Pallas matmul (interpret
  mode) to the fast mode's 2e-3 and the port's plain version to 1e-5.
- The split grid at the plan's own splits (`gemm_wgmma_plan`): every
  (column tile, 64-row K stage) unit once on every preset's INT8 shapes;
  the grid emulated block by block, each block's fp32 partial in its split's
  slot and `reduce_splits` adding them in split order, at M of 1, 8, 33, 72
  and 128 against the same two references, and bit for bit the same
  whatever order the blocks finish in.
- The split plan (fp32 partials at most the weight's bytes) and the route
  on every preset's INT8 shapes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kuiperllama_tpu.ops.pallas import quant_matmul as jqm
from kuiperllama_tpu_torch.config import MODEL_SHAPES, preset_config
from kuiperllama_tpu_torch.ops.kernels import quant_matmul as tqm
from test_torch_gemm_design import _pack_exact, _q_at
from torch_threads import one_thread  # noqa: F401

BN, BK, ROW = 128, 64, 128  # block columns, k-rows a stage, bytes a smem row


def _swizzle(addr):
    """The 128-byte swizzle on a shared address (1024-byte aligned tile):
    address bits 4-6 XOR bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _tma_tile(rows):
    """A [r, 128-byte] tile as TMA writes it with the 128-byte swizzle."""
    r, width = rows.shape
    assert width == ROW
    out = np.zeros(r * ROW, np.uint8)
    lin = np.arange(r * ROW)
    out[_swizzle(lin)] = rows.reshape(-1)
    return out


def _lane_rows(chunk):
    """The 32 addresses ldmatrix.x4.trans gets from a warp for one 32-row
    half: lane L gives row L at its chunk's swizzled place."""
    lane = np.arange(32)
    return lane * ROW + ((chunk ^ (lane & 7)) << 4)


def _ldsm_x4_trans(smem, addrs):
    """[32 lanes, 4 registers] uint32: matrix i's rows are the 16 bytes at
    addrs[8 i .. 8 i + 7]; lane (gr, t) gets b16 column gr of rows 2t (low
    half) and 2t + 1 (high half)."""
    regs = np.zeros((32, 4), np.uint32)
    for i in range(4):
        rows = np.stack([smem[a:a + 16] for a in addrs[8 * i:8 * i + 8]]).view(np.uint16)
        for lane in range(32):
            gr, t = lane >> 2, lane & 3
            regs[lane, i] = np.uint32(rows[2 * t, gr]) | (np.uint32(rows[2 * t + 1, gr]) << 16)
    return regs


def _bf16_pair(bits):
    return torch.from_numpy(np.asarray(bits, np.uint32).view(np.int32).copy()).view(torch.bfloat16)


def _dequant_frag(lo, hi, sa, sb):
    """The kernel's dequant_frag on [32] words: A registers a0..a3 as bf16
    pairs [32, 4, 2] (float32)."""
    lo, hi = lo ^ np.uint32(0x80808080), hi ^ np.uint32(0x80808080)
    out = []
    for w, (i, j), sc in ((lo, (0, 2), sa), (lo, (1, 3), sb), (hi, (0, 2), sa), (hi, (1, 3), sb)):
        packed = _bf16_pair(_pack_exact(_q_at(w, i), _q_at(w, j))).reshape(32, 2)
        out.append((packed * sc).float().numpy())  # fma.rn.bf16x2 with a -0 addend
    return np.stack(out, axis=1)


def _scale_pairs(s, kb, g, n0, cols, N, K):
    """bf16 (s, s) of columns cols (absolute n0 + cols) for k-row kb; zero
    past N and K (the TMA box fills zeros)."""
    n = n0 + cols
    if kb >= K:
        return torch.zeros((len(cols), 2), dtype=torch.bfloat16)
    v = np.where(n < N, s[kb // g, np.minimum(n, N - 1)], 0.0).astype(np.float32)
    return torch.from_numpy(np.repeat(v[:, None], 2, axis=1)).to(torch.bfloat16)


def _b_operand(xs, nw, sub):
    """B [16 k, nw] read through the descriptor of the x tile at 16-k step
    sub: row n's k at start + 32 sub + 1024 (n // 8) + 128 (n % 8) + 2 k,
    swizzled."""
    n = np.arange(nw)[None, :]
    k = np.arange(16)[:, None]
    addr = 32 * sub + 1024 * (n // 8) + ROW * (n % 8) + 2 * k
    addr = _swizzle(addr)
    return xs.view(np.uint8)[addr[..., None] + np.arange(2)].copy().view(np.uint16)[..., 0]


def _pieces(nw):
    """(rows, first row, accumulator offset) of each wgmma of a step: one
    per set bit of nw / 8, the widest first, one after another."""
    out, mb, p = [], 0, 256
    while p >= 8:
        if nw & p:
            out.append((p, mb, mb // 2))
            mb += p
        p //= 2
    return out


def _acc_map(rows, off):
    """m64nNk16's accumulator layout for a piece of `rows` x rows at
    register offset off: register off + 4 j + e holds row gr, x row
    8 j + 2t + e (off + 4 j + 2 + e: row gr + 8), as [registers], [x rows
    less 2t]."""
    j, e = np.meshgrid(np.arange(rows // 8), np.arange(2), indexing="ij")
    return (off + 4 * j + e).ravel(), (8 * j + e).ravel()


def _emulate_block(x, q, s, g, n0, k_begin, k_end):
    """One block of the wgmma kernel: fp32 outputs [M, BN] for columns
    n0 .. n0 + 127, K rows [k_begin, k_end), through its smem layouts,
    ldmatrix, A fragments, wgmma pieces, accumulator layout and epilogue."""
    M, K = x.shape
    N = q.shape[1]
    nw = -(-M // 8) * 8
    xb = torch.from_numpy(x).to(torch.bfloat16)
    acc = np.zeros((2, 4, 32, nw // 2), np.float32)  # [warpgroup, warp, lane, register]
    for k0 in range(k_begin, k_end, BK):
        # the stage as the three TMA boxes write it (zeros past K, N, M)
        qt = np.zeros((BK, BN), np.int8)
        kr, nc = min(BK, K - k0), min(BN, N - n0)
        qt[:kr, :nc] = q[k0:k0 + kr, n0:n0 + nc]
        qs = _tma_tile(qt.view(np.uint8))
        xt = np.zeros((nw, BK), np.uint16)
        kx = min(BK, K - k0)
        xt[:M, :kx] = xb[:, k0:k0 + kx].view(torch.int16).numpy().view(np.uint16)
        xs = _tma_tile(xt.view(np.uint8).reshape(nw, ROW)).view(np.uint16)
        for v in range(2):
            for warp in range(4):
                chunk = 4 * v + warp
                lane = np.arange(32)
                col = 16 * chunk + 2 * (lane >> 2)
                for p in range(2):
                    u = _ldsm_x4_trans(qs, 32 * p * ROW + _lane_rows(chunk))
                    for h in range(2):
                        sub = 2 * p + h
                        kb = k0 + 16 * sub
                        sa = _scale_pairs(s, kb, g, n0, col, N, K)
                        sb = _scale_pairs(s, kb, g, n0, col + 1, N, K)
                        frag = _dequant_frag(u[:, 2 * h], u[:, 2 * h + 1], sa, sb)
                        # A [16 rows of this warp, 16 k] from the registers
                        A = np.zeros((16, 16), np.float32)
                        for ln in range(32):
                            gr, t = ln >> 2, ln & 3
                            A[gr, 2 * t:2 * t + 2] = frag[ln, 0]
                            A[gr + 8, 2 * t:2 * t + 2] = frag[ln, 1]
                            A[gr, 2 * t + 8:2 * t + 10] = frag[ln, 2]
                            A[gr + 8, 2 * t + 8:2 * t + 10] = frag[ln, 3]
                        B = _b_operand(xs, nw, sub)
                        Bf = torch.from_numpy(B.astype(np.int16)).view(torch.bfloat16).float().numpy()
                        for rows, mb, off in _pieces(nw):
                            D = A @ Bf[:, mb:mb + rows]  # this warp's 16 rows
                            reg, m = _acc_map(rows, off)
                            for ln in range(32):
                                gr, t = ln >> 2, ln & 3
                                acc[v, warp, ln, reg] += D[gr, m + 2 * t]
                                acc[v, warp, ln, reg + 2] += D[gr + 8, m + 2 * t]
    # the epilogue: put2(m, acc[4j + e], acc[4j + 2 + e]) at columns col, col + 1
    out = np.zeros((M, BN), np.float32)
    for v in range(2):
        for warp in range(4):
            for ln in range(32):
                gr, t = ln >> 2, ln & 3
                col = 16 * (4 * v + warp) + 2 * gr
                for rows, mb, off in _pieces(nw):
                    reg, m = _acc_map(rows, off)
                    m = mb + m + 2 * t
                    live = m < M
                    out[m[live], col] = acc[v, warp, ln, reg[live]]
                    out[m[live], col + 1] = acc[v, warp, ln, reg[live] + 2]
    return out


def test_ldmatrix_phases_are_conflict_free_and_read_the_fragment_rows():
    rng = np.random.default_rng(3)
    tile = rng.integers(0, 256, (BK, BN)).astype(np.uint8)
    smem = _tma_tile(tile)
    for chunk in range(8):
        for p in range(2):
            addrs = 32 * p * ROW + _lane_rows(chunk)
            for phase in range(4):
                banks = {(a // 4 + j) % 32 for a in addrs[8 * phase:8 * phase + 8] for j in range(4)}
                assert len(banks) == 32
            regs = _ldsm_x4_trans(smem, addrs)
            for lane in range(32):
                gr, t = lane >> 2, lane & 3
                c = 16 * chunk + 2 * gr
                for i, base in enumerate((0, 8, 16, 24)):
                    k = 32 * p + base + 2 * t
                    want = [tile[k, c], tile[k, c + 1], tile[k + 1, c], tile[k + 1, c + 1]]
                    got = [(int(regs[lane, i]) >> (8 * b)) & 0xFF for b in range(4)]
                    assert got == want


@pytest.mark.parametrize("nw", [8, 24, 64, 136, 256])
def test_b_descriptor_reads_x_back(nw):
    rng = np.random.default_rng(nw)
    xt = rng.integers(0, 1 << 16, (nw, BK)).astype(np.uint16)
    xs = _tma_tile(xt.view(np.uint8).reshape(nw, ROW)).view(np.uint16)
    for sub in range(4):
        B = _b_operand(xs, nw, sub)
        assert np.array_equal(B, xt[:, 16 * sub:16 * sub + 16].T)
        for rows, mb, _ in _pieces(nw):
            # a piece's descriptor starts 1024 bytes an 8-row group later
            assert mb % 8 == 0 and np.array_equal(B[:, mb:mb + rows], xt[mb:mb + rows, 16 * sub:16 * sub + 16].T)


@pytest.mark.parametrize("nw", list(range(8, 257, 8)))
def test_pieces_make_the_layout_of_one_wgmma(nw):
    """The pieces of a step cover every x row once, and their registers,
    one piece after another, hold m64nNk16's layout for N = nw."""
    regs, rows = [], []
    for p, mb, off in _pieces(nw):
        reg, m = _acc_map(p, off)
        regs += list(reg)
        rows += list(mb + m)
    whole_reg, whole_m = _acc_map(nw, 0)
    assert regs == list(whole_reg) and rows == list(whole_m)
    assert sorted({mb + r for p, mb, _ in _pieces(nw) for r in range(p)}) == list(range(nw))


# M = 1 past 64 groups, as the port routes it: the JAX package takes its
# block-diagonal GEMV, with another rounding, at 64 groups or fewer
@pytest.mark.parametrize("M,K,N,g,splits", [(1, 1040, 128, 16, 2), (8, 256, 128, 32, 2),
                                             (33, 192, 144, 64, 2), (255, 128, 128, 16, 1),
                                             (8, 208, 128, 16, 1)])
def test_block_emulation_matches_jax(M, K, N, g, splits):
    rng = np.random.default_rng(M + K + N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    q = rng.integers(-128, 128, (K, N)).astype(np.int8)
    s = rng.uniform(0.005, 0.02, (K // g, N)).astype(np.float32)
    kps = -(-K // (splits * BK)) * BK
    y = np.zeros((M, N), np.float32)
    for n0 in range(0, N, BN):
        parts = [_emulate_block(x, q, s, g, n0, kb, min(K, kb + kps))
                 for kb in range(0, K, kps)]
        total = np.zeros_like(parts[0])
        for part in parts:  # reduce_splits: split order
            total += part
        width = min(BN, N - n0)
        y[:, n0:n0 + width] = total[:, :width]
    want = np.asarray(jqm._quant_matmul_2d(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                                           g, mode="fast"), np.float32)
    assert np.abs(y - want).max() / np.abs(want).max() <= 2e-3
    plain = tqm.quant_gemm_ref(torch.from_numpy(x), torch.from_numpy(q),
                               torch.from_numpy(s), g).numpy()
    assert np.abs(y - plain).max() / np.abs(plain).max() <= 1e-5


def _int8_shapes(name):
    """(K, N) of every INT8 projection of a preset: wqkv, wo, w13, w2 and
    the lm_head."""
    cfg = preset_config(name)
    hd = cfg.dim // cfg.n_heads
    return [(cfg.dim, (cfg.n_heads + 2 * cfg.n_kv_heads) * hd), (cfg.n_heads * hd, cfg.dim),
            (cfg.dim, 2 * cfg.hidden_dim), (cfg.hidden_dim, cfg.dim), (cfg.dim, cfg.vocab_size)]


@pytest.mark.parametrize("name", sorted(MODEL_SHAPES))
def test_every_preset_shape_takes_the_wgmma_route(name):
    for K, N in _int8_shapes(name):
        for g in (64, 256):
            if K % g:
                continue
            for M in (1, 2, 8, 32, 255):
                assert tqm.takes_wgmma(M, K, N, g), (name, K, N, g, M)
            assert not tqm.takes_wgmma(8, K, N, g, mode="exact")
            assert not tqm.takes_wgmma(8, K, N, g, aligned=False)
            assert not tqm.takes_wgmma(257, K, N, g)


@pytest.mark.parametrize("M,K,N,g", [(8, 1024, 1000, 64), (8, 648, 264, 24),
                                     (8, 640, 256, 8), (8, 512, 24, 32), (8, 4104, 4096, 8)])
def test_ragged_shapes_keep_the_mma_sync_route(M, K, N, g):
    assert not tqm.takes_wgmma(M, K, N, g)


def _split_units(M, K, N, sms):
    """The split grid of the plan: [block] -> (tile, first stage, end
    stage, split), block b = split * tiles + tile (csrc/quant_gemm.cu
    `gemm_tma_kernel`: blockIdx.x the tile, blockIdx.y the split)."""
    kps = tqm.gemm_wgmma_plan(M, K, N, sms)
    tiles, stages, ss = -(-N // BN), -(-K // BK), kps // BK
    splits = -(-K // kps)
    return [(b % tiles, b // tiles * ss, min(stages, (b // tiles + 1) * ss), b // tiles)
            for b in range(tiles * splits)]


def _split_emulate(x, q, s, g, sms, order):
    """y [M, N] fp32 as the split grid computes it: each block by
    `_emulate_block` into its split's fp32 partial, the blocks finishing in
    `order` (a permutation of the grid); then `reduce_splits` adds every
    element's partials in split order from fp32 zero."""
    M, K = x.shape
    N = q.shape[1]
    units = _split_units(M, K, N, sms)
    splits = units[-1][3] + 1
    partial = np.full((splits, M, -(-N // BN) * BN), np.nan, np.float32)
    for b in order:
        tile, lo, hi, sp = units[b]
        partial[sp, :, tile * BN:(tile + 1) * BN] = _emulate_block(
            x, q, s, g, tile * BN, lo * BK, min(K, hi * BK))
    y = np.zeros((M, partial.shape[2]), np.float32)
    for sp in range(splits):
        y += partial[sp]
    assert not np.isnan(y).any()
    return y[:, :N]


# these sizes cut tiles into K splits (4 on 66 SMs past at most 64 rows; 2
# and 3 past 64 rows on 132 SMs). M = 1 past 64 groups, as the port routes
# it (at 64 groups or fewer it takes the GEMV)
@pytest.mark.parametrize("M,K,N,g,sms", [
    (1, 1040, 256, 16, 66), (8, 1024, 256, 256, 66), (33, 1024, 256, 64, 66),
    (128, 1024, 384, 64, 132), (72, 1024, 256, 256, 132)])
def test_split_grid_emulation_matches_jax(M, K, N, g, sms):
    rng = np.random.default_rng(M + K + N + sms)
    x = rng.standard_normal((M, K)).astype(np.float32)
    q = rng.integers(-128, 128, (K, N)).astype(np.int8)
    s = rng.uniform(0.005, 0.02, (K // g, N)).astype(np.float32)
    units = _split_units(M, K, N, sms)
    assert units[-1][3] > 0
    y = _split_emulate(x, q, s, g, sms, range(len(units)))
    want = np.asarray(jqm._quant_matmul_2d(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                                           g, mode="fast"), np.float32)
    assert np.abs(y - want).max() / np.abs(want).max() <= 2e-3
    plain = tqm.quant_gemm_ref(torch.from_numpy(x), torch.from_numpy(q),
                               torch.from_numpy(s), g).numpy()
    assert np.abs(y - plain).max() / np.abs(plain).max() <= 1e-5


# (M, N, SMs): 4 splits of 2 tiles, 2 splits of 3 tiles past 64 rows
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("M,N,sms", [(8, 256, 66), (128, 384, 132)])
def test_split_grid_blocks_in_any_order_give_the_same_bits(seed, M, N, sms):
    K, g = 1024, 64
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    q = rng.integers(-128, 128, (K, N)).astype(np.int8)
    s = rng.uniform(0.005, 0.02, (K // g, N)).astype(np.float32)
    units = _split_units(M, K, N, sms)
    assert units[-1][3] >= 1
    first = _split_emulate(x, q, s, g, sms, range(len(units)))
    order = rng.permutation(len(units))
    assert np.array_equal(_split_emulate(x, q, s, g, sms, order), first)


@pytest.mark.parametrize("name", sorted(MODEL_SHAPES))
@pytest.mark.parametrize("M", [1, 8, 32, 64, 65, 128, 255, 256])
def test_split_grid_covers_every_unit_once(name, M):
    """Every (tile, stage) unit of every INT8 projection is taken by exactly
    one block: a block per (tile, split), the tile fastest; every split but
    the last is the plan's whole stages, the last no longer; one partial
    slot a (tile, split)."""
    for K, N in _int8_shapes(name):
        for sms in (1, 3, 66, 132):
            units = _split_units(M, K, N, sms)
            tiles, stages = -(-N // BN), -(-K // BK)
            ss = tqm.gemm_wgmma_plan(M, K, N, sms) // BK
            assert [u[0] for u in units[:tiles]] == list(range(tiles))
            seen = np.zeros((tiles, stages), int)
            for tile, lo, hi, _ in units:
                seen[tile, lo:hi] += 1
                assert 0 < hi - lo <= ss and (hi - lo == ss or hi == stages)
            assert (seen == 1).all()
            assert len({(u[0], u[3]) for u in units}) == len(units)


@pytest.mark.parametrize("name", sorted(MODEL_SHAPES))
@pytest.mark.parametrize("M", [1, 8, 32, 64, 65, 128, 255, 256])
def test_split_plan_keeps_partials_under_the_weight(name, M):
    for K, N in _int8_shapes(name):
        for sms in (1, 66, 132):
            kps = tqm.gemm_wgmma_plan(M, K, N, sms)
            splits = -(-K // kps)
            assert kps % BK == 0 and kps >= min(K, 256) or splits == 1
            assert 4 * splits * M * N <= K * N or splits == 1
            # no allowed split is cheaper in the plan's model
            best = tqm.wgmma_plan_cost(M, K, N, sms, kps)
            for s in range(1, max(1, min(K // 256, K // (4 * M))) + 1):
                other = -(-K // (s * BK)) * BK
                assert best <= tqm.wgmma_plan_cost(M, K, N, sms, other)


# ---------------------------------------------------------------------------
# the cost probe (tools/gemm_costs.py)


def test_gemm_costs_cells_and_bound():
    import chip_smoke
    from kuiperllama_tpu_torch.tools import gemm_costs as gc

    cells = {(name, M, g) for name, M, g in gc.CELLS}
    for name, K, N, _ in chip_smoke.GEMV_SHAPES[:4]:
        assert gc.SHAPES[name] == (K, N)
        for M in (8, 16, 32, 64, 128, 192, 255, 256):
            assert (name, M, 256) in cells
            bytes_ms, ops_ms = chip_smoke.bound(M, K, N, 256, 2, 2, 2, "bf16")
            b_us, o_us = gc.bound_us(M, K, N, 256)
            assert b_us == pytest.approx(bytes_ms * 1e3) and o_us == pytest.approx(ops_ms * 1e3)
    assert ("w2", 1, 64) in cells and ("lm_head", 8, 256) in cells
    assert gc.SHAPES["w2"][0] // 64 == 172 and not tqm.takes_wgmma(1, 11008, 4096, 24)


@pytest.mark.parametrize("argv", [[], ["--fit"], ["--layer", "--graph"]])
def test_gemm_costs_without_a_card_exits(argv):
    from kuiperllama_tpu_torch.tools import gemm_costs as gc

    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe would measure")
    with pytest.raises(SystemExit) as e:
        gc.main(argv)
    assert e.value.code not in (0, None)
    assert "needs a CUDA device" in str(e.value.code)


@pytest.mark.parametrize("name", ["wgmma_ring_only", "wgmma_no_dequant", "wgmma_no_mma",
                                  "wgmma_no_sum", "wgmma_empty", "gemv_no_sum",
                                  "gemv_empty"])
def test_gemm_costs_variant_applies_once(name):
    from kuiperllama_tpu_torch.ops.kernels import build
    from kuiperllama_tpu_torch.tools import gemm_costs as gc

    table = gc.GEMV_VARIANTS if name in gc.GEMV_VARIANTS else gc.WGMMA_VARIANTS
    source = "quant_gemv" if name in gc.GEMV_VARIANTS else "quant_gemm"
    text = (build.CSRC / f"{source}.cu").read_text()
    out = gc.variant_source(name, text)
    assert out != text
    for old, _ in table[name]:
        assert text.count(old) == 1 and out.count(old) <= 1
    with pytest.raises(RuntimeError, match="occurs 0 times"):
        gc.variant_source(name, text.replace(table[name][0][0], ""))


@pytest.mark.parametrize("a_us,tbps", [(10.37, 2.343), (9.55, 2.8), (0.0, 1.24)])
def test_gemm_costs_fit_recovers_a_line(a_us, tbps):
    """The --fit line through synthetic times t = a + bytes / BW over the
    sweep's weight bytes: a and BW back, and the residuals are each
    point's noise less the fit's share of it."""
    from kuiperllama_tpu_torch.tools import gemm_costs as gc

    nbytes = [K * N for K in gc.FIT_K for N in gc.FIT_N]
    exact = [a_us + b / (tbps * 1e6) for b in nbytes]
    a, bw, res = gc.fit_line(nbytes, exact)
    assert a == pytest.approx(a_us, abs=1e-6) and bw == pytest.approx(tbps, rel=1e-9)
    assert max(map(abs, res)) < 1e-6
    noise = np.random.default_rng(0).normal(0, 0.3, len(nbytes))
    a, bw, res = gc.fit_line(nbytes, [t + e for t, e in zip(exact, noise)])
    assert a == pytest.approx(a_us, abs=0.5) and bw == pytest.approx(tbps, rel=0.02)
    assert sum(res) == pytest.approx(0.0, abs=1e-9)
    assert max(map(abs, res)) <= max(map(abs, noise)) + 0.3


def test_gemm_costs_fit_grid_and_sweep():
    """The sweep's shapes take the kernels it names: every point's GEMV
    takes the GEMV's shapes (at most 64 groups), every GEMM point the wgmma
    route, and each kernel's grid is its plan's."""
    from kuiperllama_tpu_torch.tools import gemm_costs as gc

    assert gc.FIT_N[0] == 1024 and gc.FIT_N[-1] == 22016 and gc.FIT_K == (4096, 11008)
    for K in gc.FIT_K:
        assert K // gc.FIT_GROUP <= 64
        for N in gc.FIT_N:
            for M in gc.FIT_ROWS[1:]:
                assert tqm.takes_wgmma(M, K, N, gc.FIT_GROUP)
                grid = gc.fit_grid("wgmma", M, K, N, gc.FIT_GROUP, 132)
                kps = tqm.gemm_wgmma_plan(M, K, N, 132)
                assert grid["blocks"] == -(-N // BN) * -(-K // kps)
                assert grid["slots"] == 132 * (2 if M <= 64 else 1)
                one = gc.fit_grid("wgmma_one_wave", M, K, N, gc.FIT_GROUP, 132)
                assert one["waves"] <= 1 or one["blocks"] == -(-N // BN)
                assert gc.one_wave_kps(M, K, N, 132) % BK == 0
            grid = gc.fit_grid("gemv", 1, K, N, gc.FIT_GROUP, 132)
            ct = tqm.gemv_col_threads(K, N, gc.FIT_GROUP, 132)
            gps = tqm.gemv_plan(K, N, gc.FIT_GROUP, 132, col_threads=ct)
            assert grid["blocks"] == -(-N // (16 * ct)) * -(-(K // gc.FIT_GROUP) // gps)
