"""The arithmetic of the two exp_kernel probes (csrc/exp_kernel.cu), emulated
on the CPU, since the kernels themselves run only on the card.

- The split plans (`outscale_plan`, `stream_plan`, `split_bounds`) at SM
  counts 1, 8, 33 and 132, for every TinyLlama-1.1B shape of the tool and
  every tile it takes there: each K row of each tile is read by exactly one
  block, and the grid has at least two blocks per SM wherever the tile has
  rows enough to split.
- The outscale kernel lane by lane: the XOR-swizzled int8 stage, the
  byte permutes into bf16x2 A fragments of the weight columns, x^T as the
  n8 B operand (rows >= M zero), the m16n8k16 fragment layouts of the PTX
  ISA, each group's four k16 steps into a zeroed fp32 fragment that is then
  multiplied by its scale row and added to the accumulators, the splits'
  partials added in split order and the k-tiles in k order by the last
  block. The emulation matches the JAX tool's `_outscale_kernel` under the
  Pallas interpreter to one bf16 ulp (2^-7 of max|JAX|: both round once to
  bf16 after fp32 sums in different orders) and the plain version's fp32
  sums (`outscale_sums`) to 1e-5 relative (only the fp32 order of the adds
  inside a k-tile moves).
- The stream kernel's split int32 sums, added per tile in int64 and then
  as fp32 in k order, equal the plain
  version exactly and JAX's `stream` exactly below 2^24 (within 1e-6
  relative above, where JAX's fp32 tile sum rounds).
- The cost probe (tools/probe_costs.py): each source variant's pieces still
  occur once in csrc/exp_kernel.cu; without a card the probe exits.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_exp_kernel import load_jax_tool

from kuiperllama_tpu_torch.ops.kernels import build
from kuiperllama_tpu_torch.tools import exp_kernel as ek
from kuiperllama_tpu_torch.tools import probe_costs as pc
from torch_threads import one_thread  # noqa: F401

SMS = (1, 8, 33, 132)
BN, G, SUB = ek.OUTSCALE_BN, ek.G, 16


@pytest.fixture(scope="module")
def jk():
    return load_jax_tool("exp_kernel")


def _stream_tiles(K, N):
    return [(tk, tn) for tk, tn in ek.STREAM_TILES if K % tk == 0 and N % tn == 0]


def _covered_once(n, r):
    b = ek.split_bounds(n, r)
    seen = np.zeros(n, np.int64)
    for i in range(r):
        # the kernels' index arithmetic: i * n / r in integers
        lo, hi = i * n // r, (i + 1) * n // r
        assert (lo, hi) == (b[i], b[i + 1]) and hi > lo
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert max(np.diff(b)) - min(np.diff(b)) <= 1


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", list(ek.SHAPES))
def test_outscale_plan_covers_every_group_once(sms, shape):
    K, N = ek.SHAPES[shape]
    for tk in [t for t in (2048, 1024, 512, 256, 128, 64) if K % t == 0]:
        r = ek.outscale_plan(K, N, tk, sms)
        ngt = tk // G
        assert 1 <= r <= ngt
        _covered_once(ngt, r)
        blocks = -(-N // BN) * (K // tk) * r
        assert blocks >= 2 * sms or r == ngt, (tk, r, blocks)
        # the fewest splits that do: one fewer would not
        assert r == 1 or -(-N // BN) * (K // tk) * (r - 1) < 2 * sms


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", list(ek.SHAPES))
def test_stream_plan_covers_every_row_once(sms, shape):
    K, N = ek.SHAPES[shape]
    for tk, tn in _stream_tiles(K, N) + [(64, 128), (12, 128)]:
        if K % tk or N % tn:
            continue
        r = ek.stream_plan(K, N, tk, tn, sms)
        tiles = (K // tk) * (N // tn)
        assert 1 <= r <= tk
        _covered_once(tk, r)
        assert tiles * r >= 2 * sms or r == tk
        assert r == 1 or tiles * (r - 1) < 2 * sms  # the fewest that do


def test_stream_plan_values():
    assert ek.stream_plan(2048, 2560, 2048, 512, 132) == 53   # 5 tiles
    assert ek.stream_plan(2048, 2048, 2048, 1024, 132) == 132  # 2 tiles
    assert ek.stream_plan(5632, 2048, 512, 512, 132) == 6      # 44 tiles
    assert ek.stream_plan(12, 128, 12, 128, 132) == 12         # one row a split


# ---------------------------------------------------------------------------
# outscale, lane by lane


def _swz(r, c):
    return c ^ (((r >> 2) & 3) << 5)


def _q_at(u, i):
    """The kernel's q_at: byte i of the sign-flipped word as an fp32."""
    magic = np.uint32(0x4B000000) | ((u >> np.uint32(8 * i)) & np.uint32(0xFF))
    return np.array(magic).view(np.float32) - np.float32(8388736.0)


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _emulate_group(ws, xs):
    """One ring stage (group) of one block: the fp32 fragments of each warp
    and lane after the four k16 steps into a zeroed fragment. ws: swizzled
    int8 [64, 128]; xs: bf16-valued fp32 [NT * 8, 64] (rows >= M zero).
    Returns the group's product [128, NT * 8] (column, x row) as the lanes
    hold it."""
    nt_count = xs.shape[0] // 8
    out = np.zeros((BN, nt_count * 8), np.float32)
    for warp in range(4):
        f = np.zeros((2, nt_count, 16, 8), np.float32)  # D of each (m16, n8) tile
        for sub in range(G // SUB):
            A = np.zeros((2, 16, 16), np.float32)
            B = np.zeros((nt_count, 16, 8), np.float32)
            for lane in range(32):
                gr, t = lane >> 2, lane & 3
                col = warp * 32 + 4 * gr
                rows = [sub * SUB + 4 * t + j for j in range(4)]
                u = np.array([ws[r].view(np.uint8)[_swz(r, col):_swz(r, col) + 4].copy()
                              .view(np.uint32)[0] for r in rows], np.uint32) ^ np.uint32(0x80808080)
                # lo[i]: column col + i at k-rows 4t, 4t+1; hi[i]: 4t+2, 4t+3
                lo = [(_q_at(u[0], i), _q_at(u[1], i)) for i in range(4)]
                hi = [(_q_at(u[2], i), _q_at(u[3], i)) for i in range(4)]
                for a in range(2):
                    # a0 (gr, 2t..), a1 (gr+8, 2t..), a2 (gr, 2t+8..), a3 (gr+8, 2t+8..)
                    regs = (lo[2 * a], lo[2 * a + 1], hi[2 * a], hi[2 * a + 1])
                    for reg, (row, slot) in zip(regs, ((gr, 2 * t), (gr + 8, 2 * t),
                                                       (gr, 2 * t + 8), (gr + 8, 2 * t + 8))):
                        A[a, row, slot:slot + 2] = reg
                for nt in range(nt_count):
                    xv = xs[nt * 8 + gr, sub * SUB + 4 * t: sub * SUB + 4 * t + 4]
                    B[nt, 2 * t:2 * t + 2, gr] = xv[:2]
                    B[nt, 2 * t + 8:2 * t + 10, gr] = xv[2:]
            for a in range(2):
                for nt in range(nt_count):
                    f[a, nt] = (A[a] @ B[nt]).astype(np.float32) + f[a, nt]
        for lane in range(32):  # C layout: element e at (gr + 8 (e // 2), 2t + e % 2)
            gr, t = lane >> 2, lane & 3
            col = warp * 32 + 4 * gr
            for a in range(2):
                for nt in range(nt_count):
                    for e in range(4):
                        c = col + 2 * a + e // 2
                        m = nt * 8 + 2 * t + e % 2
                        out[c, m] = f[a, nt, gr + 8 * (e // 2), 2 * t + e % 2]
    return out


def _emulate_outscale(x, q, s, tk, r):
    """The kernel's fp32 sums [M, N] at plan r: blocks of 128 columns x
    split z = (k-tile, split), each group through `_emulate_group` into the
    block's accumulators (fp32 fma), the partials added in split order then
    k-tile order by the column tile's last block."""
    M, K = x.shape
    N = q.shape[1]
    nt_count = 1 if M <= 8 else 2
    ngt, n_k = tk // G, K // tk
    xb = _bf16(x)
    total = np.zeros((M, N), np.float32)
    for n0 in range(0, N, BN):
        cols = min(BN, N - n0)
        parts = []
        for z in range(n_k * r):
            kt, sp = divmod(z, r)
            g0 = kt * ngt + sp * ngt // r
            g1 = kt * ngt + (sp + 1) * ngt // r
            acc = np.zeros((BN, nt_count * 8), np.float32)
            for grp in range(g0, g1):
                ws = np.zeros((G, BN), np.int8)
                for rr in range(G):
                    for c in range(0, cols):
                        ws[rr, _swz(rr, c)] = q[grp * G + rr, n0 + c]
                xs = np.zeros((nt_count * 8, G), np.float32)
                xs[:M] = xb[:, grp * G:(grp + 1) * G]
                ss = np.zeros(BN, np.float32)
                ss[:cols] = s[grp, n0:n0 + cols]
                prod = _emulate_group(ws, xs).astype(np.float64)
                # the fragment times its column's scale, added by one fma
                acc = (prod * ss[:, None] + acc).astype(np.float32)
            parts.append(acc[:cols, :M].T)
        tot = np.zeros((M, cols), np.float32)
        til = None
        for z, p in enumerate(parts):
            til = p.copy() if z % r == 0 else (til + p).astype(np.float32)
            if z % r == r - 1:
                tot = (tot + til).astype(np.float32)
        total[:, n0:n0 + cols] = tot
    return total


@pytest.mark.parametrize("M,K,N,tk,sms,s_bf16", [
    (8, 256, 256, 256, 8, False),     # one k-tile, 4 groups split 4 ways
    (8, 512, 256, 128, 8, True),      # four k-tiles of 2 groups, each split in 2
    (1, 256, 192, 256, 1, False),     # a ragged 128-column tile (N % 128 == 64)
    (16, 384, 128, 128, 33, True),    # two n8 tiles, three k-tiles
    (7, 256, 128, 256, 132, False),   # rows 7 of 8 masked, one group a split
])
def test_outscale_emulation_matches_jax_and_plain(jk, M, K, N, tk, sms, s_bf16):
    rng = np.random.default_rng(M * K + N + tk)
    x = rng.standard_normal((M, K)).astype(np.float32)
    q = rng.integers(-128, 128, (K, N)).astype(np.int8)
    s = rng.uniform(0.005, 0.02, (K // G, N)).astype(np.float32)
    if s_bf16:
        s = _bf16(s)
    r = ek.outscale_plan(K, N, tk, sms)
    assert r > 1 or K // tk > 1 or sms == 1
    got = _emulate_outscale(x, q, s, tk, r)

    sums = ek.outscale_sums(torch.from_numpy(x), torch.from_numpy(q),
                            torch.from_numpy(s), tk, N).numpy()
    assert np.abs(got - sums).max() <= 1e-5 * np.abs(sums).max()

    sdt = jnp.bfloat16 if s_bf16 else jnp.float32
    want = np.asarray(jk.outscale(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q),
                                  jnp.asarray(s, sdt), tk, N).astype(jnp.float32))
    got16 = _bf16(got)
    assert np.abs(got16 - want).max() <= 2.0 ** -7 * np.abs(want).max()


def test_outscale_sums_round_to_the_plain_version():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((8, 256)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-127, 128, (256, 128)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(0.005, 0.02, (4, 128)).astype(np.float32))
    assert torch.equal(ek.outscale_sums(x, q, s, 128, 128).to(torch.bfloat16),
                       ek.outscale_ref(x, q, s, 128, 128))


# ---------------------------------------------------------------------------
# stream


def _emulate_stream(q, tk, tn, r):
    """The kernel's value: int32 per block (tile rows split r ways), the
    last column tile's partials per k-tile in int64, the k-tiles as fp32 in
    k order."""
    K, N = q.shape
    n_k = K // tk
    j = N // tn - 1
    total = np.float32(0)
    for kt in range(n_k):
        parts = []
        for sp in range(r):
            lo, hi = kt * tk + sp * tk // r, kt * tk + (sp + 1) * tk // r
            v = q[lo:hi, j * tn:(j + 1) * tn].astype(np.int64).sum()
            assert abs(v) < 2 ** 31  # the block's int32 sum is exact
            parts.append(v)
        total = np.float32(total + np.float32(np.int64(sum(parts))))
    return total


@pytest.mark.parametrize("K,N,tk,tn,sms", [
    (512, 256, 128, 256, 8),
    (256, 512, 256, 256, 33),
    (1024, 384, 256, 128, 132),
    (96, 40, 32, 8, 8),       # the scalar path's shape
])
def test_stream_split_sums_equal_jax(jk, K, N, tk, tn, sms):
    q = np.random.default_rng(K + N + tn).integers(-128, 128, (K, N)).astype(np.int8)
    r = ek.stream_plan(K, N, tk, tn, sms)
    assert r > 1
    got = _emulate_stream(q, tk, tn, r)
    assert got == ek.stream_ref(torch.from_numpy(q), tk, tn).item()
    assert got == np.asarray(jk.stream(jnp.asarray(q), tk, tn))[0, 0]


@pytest.mark.parametrize("sms", [8, 132])
def test_stream_split_sums_above_2_24(jk, sms):
    q = np.random.default_rng(3).integers(100, 128, (1024, 512)).astype(np.int8)
    r = ek.stream_plan(1024, 512, 512, 512, sms)
    got = _emulate_stream(q, 512, 512, r)
    want = np.asarray(jk.stream(jnp.asarray(q), 512, 512))[0, 0]
    assert abs(want) > 2 ** 24
    assert got == ek.stream_ref(torch.from_numpy(q), 512, 512).item()
    assert abs(got - want) <= 1e-6 * abs(want)


# ---------------------------------------------------------------------------
# the cost probe


@pytest.mark.parametrize("name", list(pc.SUBSTITUTIONS))
def test_probe_variant_applies_once(name):
    text = (build.CSRC / f"{ek.SOURCE}.cu").read_text()
    out = pc.variant_source(name, text)
    assert out != text
    for old, new in pc.SUBSTITUTIONS[name]:
        assert text.count(old) == 1 and (out.count(old) == 0 or old in new)
    with pytest.raises(RuntimeError, match="occurs 0 times"):
        pc.variant_source(name, text.replace(pc.SUBSTITUTIONS[name][0][0], ""))


def test_probe_without_a_card_exits():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe would measure")
    with pytest.raises(SystemExit) as e:
        pc.main([])
    assert e.value.code not in (0, None)
