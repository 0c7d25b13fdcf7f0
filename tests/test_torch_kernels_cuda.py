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


# ---------------------------------------------------------------------------
# The decode megakernel (csrc/fused_decode.cu) against its plain version.
# x_final and the new K/V rows: max-abs error relative to max|plain| 1e-2.
# The rounding points are the same on both sides; the kernel sums in another
# fp32 order (k-lane shares, K splits), and a one-ulp difference before a
# bf16 rounding, or before the int8 requantization of an activation, can
# carry through the layers.


def _fused_case(dev, family, kind, g, L=2, dim=256, hidden=512, heads=4,
                kv_heads=2, seed=0):
    from kuiperllama_tpu_torch.config import tiny_config
    from kuiperllama_tpu_torch.fuse import fuse_params
    from kuiperllama_tpu_torch.params import random_params, to_device
    from kuiperllama_tpu_torch.quant import cast_scales, quantize_q80

    cfg = tiny_config(family, dim=dim, hidden_dim=hidden, n_layers=L,
                      n_heads=heads, n_kv_heads=kv_heads, vocab_size=64,
                      seq_len=512)
    dtype = torch.float32 if kind == "fp32" else torch.bfloat16
    params = to_device(random_params(cfg, seed=seed), device=dev, dtype=dtype)
    if kind.startswith("int8"):
        blocks = dict(params["blocks"])
        for n in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
            blocks[n] = quantize_q80(blocks[n].float(), group_size=g)
        params = dict(params, blocks=blocks)
        if kind == "int8_bf16s":
            params = cast_scales(params, torch.bfloat16)
    return cfg, fuse_params(params)


def _fused_run(cfg, params, dev, pos, A, S, cache_dtype, fn):
    from kuiperllama_tpu_torch.models import decoder

    gen = torch.Generator(device="cpu").manual_seed(pos)
    L, KV = cfg.n_layers, cfg.kv_dim
    full_k = torch.randn((L, S, KV), generator=gen).to(dev, cache_dtype)
    full_v = torch.randn((L, S, KV), generator=gen).to(dev, cache_dtype)
    kc, vc = full_k[:, :A], full_v[:, :A]  # a window view, as the Generator passes
    # one rope table for every device: torch.sin on the card and on the CPU
    # may differ in the last bit
    sin, cos = (t.to(dev) for t in decoder.build_rope(cfg, "cpu"))
    x0 = params["tok_emb"][torch.tensor([5], device=dev)]
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    x, _, _ = fn(cfg, params, x0, kc, vc, p, sin, cos)
    return x, full_k, full_v


@pytest.mark.parametrize("family,kind,g", [
    ("llama2", "int8", 32), ("llama2", "int8_bf16s", 64),
    ("llama2", "int8", 8), ("qwen2", "int8_bf16s", 8),
    ("llama2", "bf16", 0), ("qwen2", "bf16", 0), ("qwen2", "fp32", 0),
])
@pytest.mark.parametrize("cache", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pos", [0, 37, 255])
def test_fused_decode_matches_plain(dev, family, kind, g, cache, pos):
    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd

    cfg, params = _fused_case(dev, family, kind, g)
    before = fd.fused_decode_step.launches
    x, k, v = _fused_run(cfg, params, dev, pos, 256, 512, cache,
                         fd.fused_decode_step)
    torch.cuda.synchronize()
    assert fd.fused_decode_step.launches == before + 1
    xr, kr, vr = _fused_run(cfg, params, dev, pos, 256, 512, cache,
                            fd.fused_decode_step_ref)
    assert x.dtype == xr.dtype and x.shape == xr.shape
    assert torch.isfinite(x.float()).all()
    assert _rel(x, xr) <= 1e-2
    for got, want in ((k, kr), (v, vr)):
        assert torch.equal(got[:, :pos], want[:, :pos])
        assert torch.equal(got[:, pos + 1:], want[:, pos + 1:])
        assert _rel(got[:, pos], want[:, pos]) <= 1e-2
    # deterministic: fixed-order reductions, no float atomics
    x2, k2, _ = _fused_run(cfg, params, dev, pos, 256, 512, cache,
                           fd.fused_decode_step)
    assert torch.equal(x2, x) and torch.equal(k2, k)


def _to_cpu(tree):
    from kuiperllama_tpu_torch.quant import QuantTensor

    if isinstance(tree, QuantTensor):
        return QuantTensor(tree.q.cpu(), tree.s.cpu(), tree.group_size)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


@pytest.mark.parametrize("g,L", [(64, 1), (64, 2), (256, 2)])
def test_fused_decode_full_width(dev, g, L):
    """TinyLlama-1.1B width; g = 64 takes int8 activations. At full width
    the plain version run on the card (cuBLAS summation order) sits up to
    3e-2 from the same plain version run on the CPU, so the kernel is held to
    the CPU run, whose order the CPU tests tie to the JAX package's."""
    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd

    cfg, params = _fused_case(dev, "llama2", "int8_bf16s", g, L=L, dim=2048,
                              hidden=5632, heads=32, kv_heads=4)
    assert any(fd.gemv_int8_flags(params["blocks"], 2)) == (g == 64)
    x, k, v = _fused_run(cfg, params, dev, 100, 256, 512, torch.bfloat16,
                         fd.fused_decode_step)
    cpu = torch.device("cpu")
    xr, kr, vr = _fused_run(cfg, _to_cpu(params), cpu, 100, 256, 512,
                            torch.bfloat16, fd.fused_decode_step_ref)
    assert _rel(x.cpu(), xr) <= 1e-2
    assert _rel(k[:, 100].cpu(), kr[:, 100]) <= 1e-2
    assert _rel(v[:, 100].cpu(), vr[:, 100]) <= 1e-2


def test_fused_decode_trace(dev):
    """A traced launch computes the same step and stores rising timestamps,
    one per phase of each layer; `phase_times` reads them."""
    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd

    cfg, params = _fused_case(dev, "llama2", "int8_bf16s", 64)
    L = cfg.n_layers
    trace = torch.zeros(2 + 5 * L, dtype=torch.int64, device=dev)
    traced = lambda *a: fd.fused_decode_step(*a, trace=trace)
    x, k, _ = _fused_run(cfg, params, dev, 37, 256, 512, torch.bfloat16, traced)
    x0, k0, _ = _fused_run(cfg, params, dev, 37, 256, 512, torch.bfloat16,
                           fd.fused_decode_step)
    assert torch.equal(x, x0) and torch.equal(k, k0)
    t = trace.cpu()
    assert bool((t[1:] >= t[:-1]).all()) and t[-1] > t[0] > 0
    times = fd.phase_times(trace, L)
    assert set(times) == set(fd.PHASES) | {"final", "total"}
    assert all(v >= 0 for v in times.values()) and times["total"] > 0


def test_fused_decode_rejects_bad_input(dev):
    from kuiperllama_tpu_torch.models import decoder
    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd

    cfg, params = _fused_case(dev, "llama2", "int8", 32)
    sin, cos = decoder.build_rope(cfg, dev)
    x0 = params["tok_emb"][torch.tensor([5], device=dev)]
    kc = torch.zeros((cfg.n_layers, 256, cfg.kv_dim), device=dev)
    p = torch.tensor([3], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # rows not contiguous
        fd.fused_decode_step(cfg, params, x0, kc.transpose(1, 2), kc, p, sin, cos)
    with pytest.raises(TypeError):  # pos of the wrong type
        fd.fused_decode_step(cfg, params, x0, kc, kc.clone(), p.long(), sin, cos)
    with pytest.raises(ValueError):  # a weight on the CPU
        blocks = dict(params["blocks"], wo=params["blocks"]["wo"].__class__(
            q=params["blocks"]["wo"].q.cpu(), s=params["blocks"]["wo"].s.cpu(),
            group_size=32))
        fd.fused_decode_step(cfg, dict(params, blocks=blocks), x0, kc,
                             kc.clone(), p, sin, cos)
