"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a GPU. The file imports
no JAX, so on a machine with a card and without JAX it runs alone:
    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
Tolerances are max-abs error relative to max|ref|: the rounding is the same
on both sides and only the fp32 summation order differs, so fast mode holds
to 1e-3 and exact mode to 1e-5. A bf16 output is rounded once on each side,
and a sum that differs in its last fp32 bits can round to the neighbouring
bf16 value: one bf16 ulp, at most 2^-7 of max|ref|.
"""

import numpy as np
import pytest
import torch

from kuiperllama_tpu_torch.ops.kernels import quant_matmul as qm

pytestmark = pytest.mark.cuda
BF16_ULP = 2.0 ** -7
TOL = {"fast": 1e-3, "exact": 1e-5}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _operands(dev, M, K, N, g, x_dtype, s_dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(0.005, 0.02, (K // g, N)).astype(np.float32))
    return x.to(dev, x_dtype), q.to(dev), s.to(dev, s_dtype)


def _rel(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-9)).item()


@pytest.mark.parametrize("K,N,g", [
    (4096, 4096, 256), (4096, 12288, 256), (11008, 4096, 256),
    (4096, 4096, 64), (256, 1000, 64), (512, 24, 32),
])
@pytest.mark.parametrize("x_dtype,s_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.float32, torch.bfloat16),
])
def test_gemv_matches_plain(dev, K, N, g, x_dtype, s_dtype):
    x, q, s = _operands(dev, 1, K, N, g, x_dtype, s_dtype)
    before = qm.quant_gemv.launches
    got = qm.quant_gemv(x, q, s, g)
    torch.cuda.synchronize()
    assert qm.quant_gemv.launches == before + 1
    want = qm.quant_gemv_ref(x, q, s, g)
    assert got.dtype == x_dtype and got.shape == (1, N)
    tol = BF16_ULP if x_dtype == torch.bfloat16 else 1e-3
    assert _rel(got, want) <= tol
    # deterministic: the K splits reduce in a fixed order
    assert torch.equal(qm.quant_gemv(x, q, s, g), got)


def test_gemv_ignores_scale_rows_past_k_over_g(dev):
    K, N, g = 1024, 512, 64
    x, q, s = _operands(dev, 1, K, N, g, torch.float32, torch.float32)
    padded = torch.cat([s, torch.full((5, N), float("nan"), device=dev)])
    assert torch.equal(qm.quant_gemv(x, q, padded, g), qm.quant_gemv(x, q, s, g))


def test_gemv_layer_view(dev):
    L, K, N, g = 3, 1024, 768, 256
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.integers(-127, 128, (L, K, N)).astype(np.int8)).to(dev)
    s = torch.from_numpy(rng.uniform(0.005, 0.02, (L, K // g, N)).astype(np.float32)).to(dev)
    x = torch.randn(1, K, device=dev)
    for li in range(L):
        got = qm.quant_gemv(x, q[li], s[li], g)
        want = qm.quant_gemv(x, q[li].clone(), s[li].clone(), g)
        assert torch.equal(got, want)


@pytest.mark.parametrize("M,K,N,g", [
    (2, 4096, 12288, 256), (32, 4096, 4096, 256), (255, 4096, 4096, 256),
    (32, 11008, 4096, 256), (1, 11008, 4096, 64), (7, 192, 200, 64),
    (3, 1088, 100, 64),  # seven K splits, the last one short; ragged N
])
@pytest.mark.parametrize("mode", ["fast", "exact"])
@pytest.mark.parametrize("x_dtype,s_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
])
def test_gemm_matches_plain(dev, M, K, N, g, mode, x_dtype, s_dtype):
    x, q, s = _operands(dev, M, K, N, g, x_dtype, s_dtype)
    before = qm.quant_gemm.launches
    got = qm.quant_gemm(x, q, s, g, mode)
    torch.cuda.synchronize()
    assert qm.quant_gemm.launches == before + 1
    want = qm.quant_gemm_ref(x, q, s, g, mode)
    assert got.dtype == x_dtype and got.shape == (M, N)
    assert _rel(got, want) <= (BF16_ULP if x_dtype == torch.bfloat16 else TOL[mode])


@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_gemm_unaligned_x_takes_scalar_loads(dev, mode):
    x, q, s = _operands(dev, 5, 512, 256, 64, torch.float32, torch.float32)
    buf = torch.empty(x.numel() + 1, device=dev)
    xu = buf[1:].view(5, 512)  # contiguous, 4 bytes past a 16-byte boundary
    xu.copy_(x)
    assert xu.data_ptr() % 16 != 0
    got = qm.quant_gemm(xu, q, s, 64, mode)
    assert _rel(got, qm.quant_gemm_ref(x, q, s, 64, mode)) <= TOL[mode]


def test_gemm_split_k_is_deterministic(dev):
    x, q, s = _operands(dev, 32, 4096, 4096, 256, torch.bfloat16, torch.bfloat16)
    assert qm.gemm_k_per_split(32, 4096, 4096, 132) < 4096
    assert torch.equal(qm.quant_gemm(x, q, s, 256), qm.quant_gemm(x, q, s, 256))


def test_wrappers_reject_bad_input(dev):
    x, q, s = _operands(dev, 1, 512, 256, 64, torch.float32, torch.float32)
    with pytest.raises(ValueError):
        qm.quant_gemv(x, q.cpu(), s, 64)
    with pytest.raises(TypeError):
        qm.quant_gemv(x.half(), q, s, 64)
    with pytest.raises(ValueError):
        qm.quant_gemm(x, q.t(), s, 64)  # not contiguous, wrong shape
    with pytest.raises(ValueError):
        qm.quant_gemm(x, q, s[:3], 64)  # too few scale rows
    with pytest.raises(ValueError):
        qm.quant_gemm(x, q, s, 64, mode="approx")
