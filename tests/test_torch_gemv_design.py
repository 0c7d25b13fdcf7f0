"""The partition of the M = 1 GEMV (csrc/quant_gemv.cu), emulated on the CPU,
since the kernel itself runs only on the card.

The emulation follows the kernel's walk: tiles of 16 x CT columns (CT column
threads a warp, `gemv_col_threads`); K split into runs of `gemv_plan`
groups (blockIdx.y); min(8, gps) warps per block, warp w owning groups
g0 + w, g0 + w + nwarps, ...; in a warp, sub-lane sl of S = 32 / CT sums
rows sl, sl + S, ... of a group in row order in fp32 (each int8 value made
exact by the kernel's byte trick, checked here too); the S sub-lanes' sums
are reduced in the kernel's reduce-scatter tree (pairs sl, sl ^ S/2, then
sl ^ S/4, ..., 1); each group's P is scaled once into the warp's
accumulator, the warps are summed in warp order and the splits in split
order. Columns never mix, so a narrow N is emulated with the plan of the
real projection's width. Held against the JAX package's `_diag_gemv_xla`
and its `_kernel_diag` (the Pallas interpreter) within 1e-5 relative with
fp32 output: the arithmetic is the same and only the fp32 order differs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kuiperllama_tpu.ops.pallas import quant_matmul as jqm
from kuiperllama_tpu_torch.ops.kernels import quant_matmul as tqm
from torch_threads import one_thread  # noqa: F401

SMS = 132  # an H100 SXM's streaming multiprocessors


def _tree(sub):
    """The kernel's reduce-scatter over the sub-lane axis (dim 1, size S):
    every step adds the partner's half, so each sub-lane's columns end as
    the same tree sum."""
    vals = [sub[:, i] for i in range(sub.shape[1])]
    h = len(vals) // 2
    while h >= 1:
        vals = [vals[i] + vals[i ^ h] for i in range(len(vals))]
        h //= 2
    return vals[0]


def gemv_emulate(x, q, s, g, gps, ct):
    """y [1, N] fp32 in the kernel's order of operations."""
    K, N = q.shape
    ng = K // g
    S = 32 // ct
    xb = x.reshape(-1).to(torch.bfloat16).float()
    qf = q.float().reshape(ng, g, N)
    xg = xb.reshape(ng, g)
    # sub-lane sums: rows sl + S i in row order; rows past g add nothing
    sub = torch.zeros((ng, S, N))
    for i in range(-(-g // S)):
        rows = torch.arange(S) + S * i
        ok = rows < g
        r = rows.clamp(max=g - 1)
        term = xg[:, r][:, :, None] * qf[:, r, :]  # exact products in fp32
        sub = sub + term * ok[None, :, None]
    P = _tree(sub)                                 # [ng, N]
    Sc = s[:ng].float()
    splits = -(-ng // gps)
    nwarps = min(tqm._GEMV_WARPS, gps)
    y = torch.zeros(N)
    for sp in range(splits):
        g0, g1 = sp * gps, min(ng, (sp + 1) * gps)
        block = torch.zeros(N)
        for w in range(nwarps):
            acc = torch.zeros(N)
            for grp in range(g0 + w, g1, nwarps):   # one fma per group
                acc = (acc.double() + P[grp].double() * Sc[grp].double()).float()
            block = block + acc
        y = y + block
    return y[None, :]


def _operands(seed, K, N, g, s_bf16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, K)).astype(np.float32)
    q = rng.integers(-127, 128, (K, N)).astype(np.int8)
    s = rng.uniform(0.005, 0.02, (K // g, N)).astype(np.float32)
    st = torch.from_numpy(s)
    if s_bf16:
        st = st.to(torch.bfloat16)
        s = st.float().numpy()
    return x, q, s, st


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


# (K, g, N of the real projection whose plan and layout are emulated, N
# emulated)
@pytest.mark.parametrize("K,g,n_real,N", [
    (4096, 256, 4096, 256),     # wo: 4 column threads a warp
    (4096, 256, 12288, 256),    # wqkv
    (4096, 256, 22016, 256),    # w13
    (11008, 256, 4096, 256),    # w2: 43 groups, the last split short
    (4096, 256, 32000, 256),    # lm_head
    (4096, 64, 4096, 256),      # 64 groups, the longest walk
    (1024, 256, 200, 200),      # ragged N (the byte-load path)
])
@pytest.mark.parametrize("s_bf16", [False, True])
def test_gemv_partition_matches_jax(K, g, n_real, N, s_bf16):
    x, q, s, st = _operands(K + N + g, K, N, g, s_bf16)
    ct = tqm.gemv_col_threads(K, n_real, g, SMS, n_real % 16 == 0)
    gps = tqm.gemv_plan(K, n_real, g, SMS, col_threads=ct)
    got = gemv_emulate(torch.from_numpy(x), torch.from_numpy(q), st, g, gps, ct)
    sj = jnp.asarray(s, jnp.bfloat16 if s_bf16 else jnp.float32)
    xla = jqm._diag_gemv_xla(jnp.asarray(x), jnp.asarray(q), sj, g)
    pallas = jqm._quant_matmul_2d(jnp.asarray(x), jnp.asarray(q), sj, g,
                                  mode="fast")
    assert _rel(got, xla) <= 1e-5
    assert _rel(got, pallas) <= 1e-5
    # the plain version (another fp32 order) agrees as closely
    plain = tqm.quant_gemv_ref(torch.from_numpy(x), torch.from_numpy(q), st, g)
    assert _rel(got, plain) <= 1e-5


@pytest.mark.parametrize("K,N,g", [(4096, 4096, 256), (4096, 12288, 256),
                                   (4096, 22016, 256), (11008, 4096, 256),
                                   (4096, 32000, 256), (4096, 4096, 64)])
def test_gemv_plan_fills_the_card(K, N, g):
    """At the 7B shapes every split's groups are spread over the block's
    warps, and the warps in flight give every SM at least 32 KB of loads:
    a warp waits on one batch with the next already issued, two batches of
    8 rows of 16 bytes per lane (8 KB a warp, one group per warp at a time)."""
    ng = K // g
    ct = tqm.gemv_col_threads(K, N, g, SMS)
    gps = tqm.gemv_plan(K, N, g, SMS, col_threads=ct)
    splits = -(-ng // gps)
    tiles = -(-N // (16 * ct))
    warps = tiles * sum(min(tqm._GEMV_WARPS, min(ng, (i + 1) * gps) - i * gps)
                        for i in range(splits))
    assert warps * 32 * 2 * 8 * 16 / SMS >= 32 * 1024
    # the grid reaches the planned blocks per SM, or every group has a warp
    assert (tiles * splits >= tqm._GEMV_BLOCKS_PER_SM[ct] * SMS
            or gps <= tqm._GEMV_WARPS)


@pytest.mark.parametrize("ct", [4, 8])
def test_gemv_reduce_scatter(ct):
    """The shuffle steps of `reduce_group`, lane by lane (lane = sl * CT +
    column thread; partner lane ^ h * CT), leave sub-lane sl with the 16 / S
    columns from (16 / S) sl of the tree sum."""
    S = 32 // ct
    rng = np.random.default_rng(ct)
    part = rng.standard_normal((S, 16)).astype(np.float32)  # [sub-lane, column]
    p = [part[sl].copy() for sl in range(S)]
    h, n = S // 2, 8
    while h >= 1:
        new = []
        for sl in range(S):
            hi = bool(sl & h)
            keep = p[sl][n:2 * n] if hi else p[sl][:n]
            # the partner sends the half this lane keeps
            recv = p[sl ^ h][n:2 * n] if hi else p[sl ^ h][:n]
            new.append(keep + recv)
        p, h, n = new, h // 2, n // 2
    want = _tree(torch.from_numpy(part)[None, :, :])[0].numpy()
    nc = 16 // S
    for sl in range(S):
        np.testing.assert_array_equal(p[sl][:nc], want[nc * sl:nc * sl + nc])


def test_int8_byte_trick_is_exact():
    """The kernel's int8 to fp32: the sign-flipped byte as the low mantissa
    byte of 2^23 (0x4B0000xx), less 2^23 + 128, is the int8 value exactly."""
    q = np.arange(-128, 128, dtype=np.int8)
    u = (q.view(np.uint8) ^ np.uint8(0x80)).astype(np.uint32)
    f = (np.uint32(0x4B000000) | u).view(np.float32) - np.float32(8388736.0)
    np.testing.assert_array_equal(f, q.astype(np.float32))
