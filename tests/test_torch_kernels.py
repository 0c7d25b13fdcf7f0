"""The plain versions of the port's INT8 GEMV and GEMM, and the routing in
ops/linear.py, against the JAX package on the same numpy inputs.

The JAX side runs its Pallas kernels in interpret mode on the CPU, as
tests/test_pallas_quant_matmul.py does, plus its XLA routes. Tolerances are
max-abs error relative to max|want|: exact mode 1e-5; fast mode 2e-3 against
the JAX fast-mode functions, which round in the same places. Fast mode sits
about 3e-3 from the fp32 oracle on both sides, which the last assertion of
the GEMV test pins as a class bound. The CUDA kernels themselves are held
against these plain versions on the card in test_torch_kernels_cuda.py.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kuiperllama_tpu.ops.pallas import quant_matmul as jqm
from kuiperllama_tpu.quant import QuantArray
from kuiperllama_tpu_torch.ops import linear as tlin
from kuiperllama_tpu_torch.ops.kernels import quant_matmul as tqm
from kuiperllama_tpu_torch.quant import QuantTensor

# the JAX ops package re-exports a function named `linear`: load the module
jlin = importlib.import_module("kuiperllama_tpu.ops.linear")


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _operands(seed, M, K, N, g, L=None):
    rng = np.random.default_rng(seed)
    lead = () if L is None else (L,)
    q = rng.integers(-127, 128, lead + (K, N)).astype(np.int8)
    s = rng.uniform(0.005, 0.02, lead + (K // g, N)).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    return x, q, s


def _jax_w(q, s, g, s_bf16=False):
    sj = jnp.asarray(s, jnp.bfloat16 if s_bf16 else jnp.float32)
    return QuantArray(q=jnp.asarray(q), s=sj, group_size=g)


def _torch_w(q, s, g, s_bf16=False):
    st = torch.from_numpy(s)
    return QuantTensor(q=torch.from_numpy(q),
                       s=st.to(torch.bfloat16) if s_bf16 else st, group_size=g)


@pytest.mark.parametrize("K,N,g,s_bf16", [
    (256, 384, 64, False), (896, 256, 64, True), (4096, 512, 64, False),
    (1024, 256, 256, True), (512, 200, 256, False),
])
def test_gemv_plain_matches_jax(K, N, g, s_bf16):
    x, q, s = _operands(K + N, 1, K, N, g)
    jw, tw = _jax_w(q, s, g, s_bf16), _torch_w(q, s, g, s_bf16)
    got = tqm.quant_gemv(torch.from_numpy(x), tw.q, tw.s, g)  # CPU: plain
    assert got.dtype == torch.float32 and got.shape == (1, N)
    xla = jqm._diag_gemv_xla(jnp.asarray(x), jw.q, jw.s, g)
    pallas = jqm._quant_matmul_2d(jnp.asarray(x), jw.q, jw.s, g, mode="fast")
    assert _rel(got, xla) <= 2e-3
    assert _rel(got, pallas) <= 2e-3
    oracle = jlin._quant_matmul_xla(jnp.asarray(x), _jax_w(q, s, g))
    assert _rel(got, oracle) <= 5e-3
    # bf16 activations stay bf16 on the way out
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tqm.quant_gemv(xb, tw.q, tw.s, g).dtype == torch.bfloat16


@pytest.mark.parametrize("M,K,N,g", [
    (2, 256, 384, 64), (8, 512, 256, 64), (4, 192, 320, 64),
    (16, 512, 256, 256), (1, 64 * 72, 128, 64),
])
@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_gemm_plain_matches_jax(M, K, N, g, mode):
    x, q, s = _operands(M * K + N, M, K, N, g)
    jw, tw = _jax_w(q, s, g), _torch_w(q, s, g)
    got = tqm.quant_gemm(torch.from_numpy(x), tw.q, tw.s, g, mode)
    assert got.shape == (M, N)
    pallas = jqm._quant_matmul_2d(jnp.asarray(x), jw.q, jw.s, g, mode=mode)
    if mode == "exact":
        assert _rel(got, pallas) <= 1e-5
        assert _rel(got, jlin._quant_matmul_xla(jnp.asarray(x), jw)) <= 1e-5
    else:  # M = 1 here has 72 groups: the JAX fast route is its GEMM too
        assert _rel(got, pallas) <= 2e-3


def test_gemm_plain_bf16_scales_fast():
    x, q, s = _operands(9, 8, 512, 256, 64)
    jw, tw = _jax_w(q, s, 64, True), _torch_w(q, s, 64, True)
    got = tqm.quant_gemm(torch.from_numpy(x), tw.q, tw.s, 64, "fast")
    assert _rel(got, jqm._quant_matmul_2d(jnp.asarray(x), jw.q, jw.s, 64)) <= 2e-3


def _route_spy(monkeypatch):
    seen = []
    for name in ("quant_gemv", "quant_gemm", "_dequant_dot"):
        real = getattr(tlin, name)
        monkeypatch.setattr(
            tlin, name,
            lambda *a, _n=name, _r=real, **k: seen.append(_n) or _r(*a, **k))
    return seen


@pytest.mark.parametrize("rows,K,g,mode,route", [
    (1, 512, 64, "fast", "quant_gemv"),        # 8 groups
    (1, 64 * 64, 64, "fast", "quant_gemv"),    # exactly 64 groups
    (1, 64 * 65, 64, "fast", "quant_gemm"),    # 65 groups: GEMM, as in JAX
    (1, 512, 64, "exact", "quant_gemm"),       # the GEMV is fast-only
    (32, 512, 256, "fast", "quant_gemm"),
    (255, 256, 64, "exact", "quant_gemm"),
    (256, 256, 64, "fast", "_dequant_dot"),    # dequantize-then-dot
])
def test_linear_routes_like_jax(monkeypatch, rows, K, g, mode, route):
    N = 192
    x, q, s = _operands(rows + K, rows, K, N, g, L=2)
    seen = _route_spy(monkeypatch)
    tw = _torch_w(q, s, g)
    bias = np.random.default_rng(0).standard_normal((2, N)).astype(np.float32)
    got = tlin.linear_layered(torch.from_numpy(x)[None], tw, 1,
                              torch.from_numpy(bias), mode=mode)
    assert seen == [route]
    assert got.shape == (1, rows, N)

    jqm.set_quant_matmul_mode(mode)
    try:
        want = jlin.linear_layered(jnp.asarray(x)[None], _jax_w(q, s, g),
                                   jnp.int32(1), jnp.asarray(bias))
    finally:
        jqm.set_quant_matmul_mode("fast")
    assert _rel(got, want) <= (1e-5 if mode == "exact" else 2e-3)


def test_large_m_route_bf16_rounds_once():
    """rows >= 256 with bf16 activations: one bf16 matmul of bf16 operands
    (fp32 accumulation inside), as the JAX route's fp32 dot then cast."""
    x, q, s = _operands(5, 256, 256, 128, 64)
    tw = _torch_w(q, s, 64, True)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tlin.linear(xb, tw)
    want = jlin._dequant_dot_xla(jnp.asarray(x, jnp.bfloat16), _jax_w(q, s, 64, True))
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), np.asarray(want, np.float32)) <= 2 ** -7


def test_layer_of_stack_is_a_view():
    x, q, s = _operands(1, 1, 256, 128, 64, L=3)
    tw = _torch_w(q, s, 64)
    layer = tw[2]
    assert layer.q.data_ptr() == tw.q.data_ptr() + 2 * 256 * 128
    assert layer.s.data_ptr() == tw.s.data_ptr() + 2 * 4 * 128 * 4


@pytest.mark.parametrize("K,N,g", [(4096, 4096, 256), (4096, 22016, 256),
                                   (11008, 4096, 256), (4096, 32000, 256),
                                   (4096, 4096, 64), (128, 256, 64)])
def test_gemv_split_plan(K, N, g):
    ng = K // g
    ct = tqm.gemv_col_threads(K, N, g, 132)
    gps = tqm.gemv_plan(K, N, g, 132, col_threads=ct)
    splits = -(-ng // gps)
    assert 1 <= gps <= ng and (splits - 1) * gps < ng <= splits * gps
    assert gps * g <= tqm._GEMV_MAX_STAGED_K
    # every warp of a block walks as many groups once a split outgrows it
    assert gps <= tqm._GEMV_WARPS or gps % tqm._GEMV_WARPS == 0 or gps == ng
    tiles = -(-N // (16 * ct))
    blocks = splits * tiles
    assert blocks >= min(4 * 132, ng * tiles) // 2


@pytest.mark.parametrize("M,K,N", [(32, 4096, 12288), (32, 4096, 4096),
                                   (32, 11008, 4096), (255, 4096, 12288),
                                   (1, 11008, 4096), (3, 1088, 100),
                                   (7, 192, 200)])
def test_gemm_split_plan(M, K, N):
    kps = tqm.gemm_k_per_split(M, K, N, 132)
    splits = -(-K // kps)
    assert kps % 64 == 0 and (splits - 1) * kps < K <= splits * kps
    assert splits == 1 or kps >= 256
    rows = tqm.gemm_block_rows(M)
    assert rows >= min(M, 64) and (rows == 8 or rows // 2 < M)
    tiles = -(-N // 128) * -(-M // rows)
    assert tiles * splits >= min(3 * 132, tiles * (K // 256)) // 2


def test_library_name_covers_every_header(tmp_path, monkeypatch):
    """A kernel's library is named by a hash of its source, every csrc/*.cuh
    header and the flags: an edited or added header rebuilds every source,
    unchanged files keep the name."""
    from kuiperllama_tpu_torch.ops.kernels import build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "common.cuh"\n')
    (csrc / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    first = build.lib_path("k")
    assert build.lib_path("k") == first
    (csrc / "common.cuh").write_text("// v2\n")
    edited = build.lib_path("k")
    assert edited != first
    (csrc / "more.cuh").write_text("// new\n")
    assert build.lib_path("k") not in (first, edited)
    (csrc / "more.cuh").unlink()
    assert build.lib_path("k") == edited


def test_megakernel_sources_share_one_header():
    from kuiperllama_tpu_torch.ops.kernels import build

    for name in ("fused_decode", "fused_decode_big", "fused_decode_chunk"):
        assert '#include "fused_decode_common.cuh"' in (
            build.CSRC / f"{name}.cu").read_text()
