"""The arithmetic of the GEMM's fast kernel (csrc/quant_gemm.cu), emulated on
the CPU, since the kernel itself runs only on the card.

- The packed dequant identity: one rounded bf16 product bf16(q) * bf16(s)
  equals round_bf16(q * round_bf16(s)), bit for bit, over every int8 value
  and a spread of scales.
- The kernel's bit tricks: int8 to an exact fp32 through 2^23 + (q + 128),
  two such floats packed into bf16x2 by their upper halves.
- Its data layout: the XOR-swizzled int8 tile, the byte transpose into mma
  A fragments with the k order permuted alike in A and in x's B fragments,
  the m16n8k16 fragment layouts of the PTX ISA, the epilogue's column map,
  the K splits summed in split order (as reduce_splits sums them). The
  emulation, run on one block's tiles, equals the JAX package's fast-mode
  Pallas matmul (interpret mode) to the fast mode's 2e-3 (only the fp32
  summation order differs).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kuiperllama_tpu.ops.pallas import quant_matmul as jqm
from kuiperllama_tpu_torch.ops.kernels import quant_matmul as tqm
from torch_threads import one_thread  # noqa: F401


def _bits16(t):
    return t.view(torch.int16).numpy().astype(np.uint16)


@pytest.mark.parametrize("lo,hi", [(0.005, 0.02), (1e-4, 1e-3), (0.5, 3.0),
                                   (1e-30, 1e-28), (1e20, 1e22)])
def test_packed_dequant_identity(lo, hi):
    rng = np.random.default_rng(int(np.log10(hi)) + 40)
    q = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)[:, None]  # [256, 1]
    s = torch.from_numpy(rng.uniform(lo, hi, (1, 512)).astype(np.float32))
    s = torch.cat([s, -s], dim=1)
    packed = q.to(torch.bfloat16) * s.to(torch.bfloat16)        # one bf16 product
    current = (q.float() * s.to(torch.bfloat16).float()).to(torch.bfloat16)
    assert np.array_equal(_bits16(packed), _bits16(current))
    # the plain version's weight rounding is the same product
    plain = tqm.dequantize_bf16(q.expand(256, 1024).contiguous(), s, 256)
    assert np.array_equal(_bits16(plain), _bits16(packed))


def _q_at(u, i):
    """The kernel's q_at: byte i of the sign-flipped word as an fp32."""
    magic = np.uint32(0x4B000000) | ((u >> np.uint32(8 * i)) & np.uint32(0xFF))
    return magic.view(np.float32) - np.float32(8388736.0)


def _pack_exact(lo, hi):
    """bf16x2 of two integer-valued floats: their upper 16 bits."""
    return ((lo.view(np.uint32) >> np.uint32(16))
            | (hi.view(np.uint32) & np.uint32(0xFFFF0000)))


def test_int8_to_bf16x2_bit_tricks():
    vals = np.arange(-128, 128, dtype=np.int8)
    words = vals.view(np.uint8).reshape(64, 4).copy().view(np.uint32).ravel()
    u = words ^ np.uint32(0x80808080)
    got = np.stack([_q_at(u, i) for i in range(4)], axis=1).ravel()
    assert np.array_equal(got, vals.astype(np.float32))
    pairs = _pack_exact(got[0::2].copy(), got[1::2].copy())
    as_bf16 = torch.from_numpy(pairs.view(np.int32).copy()).view(torch.bfloat16).float()
    assert torch.equal(as_bf16.reshape(-1), torch.from_numpy(vals.astype(np.float32)))


BN, BK, SUB = 128, 64, 16


def _swz(r, c):
    return c ^ (((r >> 2) & 3) << 5)


def _emulate_block(x, q, s, g, m0, n0, k_begin, k_end, nt_count):
    """One block of the fast kernel: fp32 outputs [8 nt_count, BN] for x rows
    m0.., columns n0.., K rows [k_begin, k_end), through the kernel's smem
    layout, fragments and epilogue."""
    M, K = x.shape
    N = q.shape[1]
    rows = 8 * nt_count
    out = np.zeros((rows, BN), np.float32)
    for k0 in range(k_begin, k_end, BK):
        # the ring stage: swizzled int8 tile, x tile (bf16), scale rows
        ws = np.zeros((BK, BN), np.int8)
        for r in range(BK):
            for c in range(BN):
                k, n = k0 + r, n0 + c
                if k < k_end and n < N:
                    ws[r, _swz(r, c)] = q[k, n]
        xs = np.zeros((rows, BK), np.float32)
        for r in range(rows):
            for c in range(BK):
                if m0 + r < M and k0 + c < k_end:
                    xs[r, c] = x[m0 + r, k0 + c]
        xs = torch.from_numpy(xs).to(torch.bfloat16)
        for sub in range(BK // SUB):
            kb = k0 + sub * SUB
            if kb >= k_end:
                break
            for warp in range(4):
                A = [np.zeros((16, 16), np.float32) for _ in range(2)]
                B = [np.zeros((16, 8), np.float32) for _ in range(nt_count)]
                for lane in range(32):
                    gr, t = lane >> 2, lane & 3
                    col = warp * 32 + 4 * gr
                    u = np.array([ws[sub * SUB + 4 * t + j].view(np.uint8)[
                        _swz(sub * SUB + 4 * t + j, col):][:4].copy().view(np.uint32)[0]
                        for j in range(4)], np.uint32) ^ np.uint32(0x80808080)
                    lo, hi = [], []
                    for i in range(4):
                        n = n0 + col + i
                        sv = float(s[kb // g, n]) if n < N else 0.0
                        sb = torch.tensor([sv, sv]).to(torch.bfloat16)
                        for dst, (a, b) in ((lo, (0, 1)), (hi, (2, 3))):
                            bits = _pack_exact(np.array([_q_at(u[a], i)]),
                                               np.array([_q_at(u[b], i)]))
                            pair = torch.from_numpy(bits.view(np.int32).copy()).view(
                                torch.bfloat16)
                            dst.append((pair * sb).float().numpy())  # fma.rn.bf16x2
                    # A fragments: reg0 (gr, 2t..), reg1 (gr+8, 2t..),
                    # reg2 (gr, 2t+8..), reg3 (gr+8, 2t+8..)
                    for tile in range(2):
                        regs = (lo[2 * tile], lo[2 * tile + 1], hi[2 * tile],
                                hi[2 * tile + 1])
                        for reg, (row, slot) in zip(regs, ((gr, 2 * t), (gr + 8, 2 * t),
                                                           (gr, 2 * t + 8), (gr + 8, 2 * t + 8))):
                            A[tile][row, slot:slot + 2] = reg
                    for nt in range(nt_count):
                        xv = xs[nt * 8 + gr, sub * SUB + 4 * t: sub * SUB + 4 * t + 4].float()
                        B[nt][2 * t:2 * t + 2, gr] = xv[:2].numpy()
                        B[nt][2 * t + 8:2 * t + 10, gr] = xv[2:].numpy()
                for nt in range(nt_count):
                    D = [A[tile] @ B[nt] for tile in range(2)]
                    for lane in range(32):  # C layout and the epilogue's map
                        gr, t = lane >> 2, lane & 3
                        col = warp * 32 + 4 * gr
                        for e in range(2):
                            m = nt * 8 + 2 * t + e
                            out[m, col + 0] += D[0][gr, 2 * t + e]
                            out[m, col + 1] += D[0][gr + 8, 2 * t + e]
                            out[m, col + 2] += D[1][gr, 2 * t + e]
                            out[m, col + 3] += D[1][gr + 8, 2 * t + e]
    return out


@pytest.mark.parametrize("M,K,N,g", [(3, 256, 160, 64), (8, 192, 128, 32)])
def test_fast_kernel_layout_emulation_matches_jax(M, K, N, g):
    rng = np.random.default_rng(M + K)
    x = rng.standard_normal((M, K)).astype(np.float32)
    q = rng.integers(-128, 128, (K, N)).astype(np.int8)
    s = rng.uniform(0.005, 0.02, (K // g, N)).astype(np.float32)
    kps = 128  # two K splits, summed in split order as reduce_splits does
    rows = tqm.gemm_block_rows(M)
    y = np.zeros((M, N), np.float32)
    for n0 in range(0, N, BN):
        parts = [_emulate_block(x, q, s, g, 0, n0, kb, min(K, kb + kps), rows // 8)
                 for kb in range(0, K, kps)]
        total = np.zeros_like(parts[0])
        for p in parts:
            total += p
        width = min(BN, N - n0)
        y[:, n0:n0 + width] = total[:M, :width]
    want = np.asarray(jqm._quant_matmul_2d(jnp.asarray(x), jnp.asarray(q),
                                           jnp.asarray(s), g, mode="fast"), np.float32)
    assert np.abs(y - want).max() / np.abs(want).max() <= 2e-3
    # and the plain version, which rounds in the same places, to fp32 order
    plain = tqm.quant_gemm_ref(torch.from_numpy(x), torch.from_numpy(q),
                               torch.from_numpy(s), g).numpy()
    assert np.abs(y - plain).max() / np.abs(plain).max() <= 1e-5
