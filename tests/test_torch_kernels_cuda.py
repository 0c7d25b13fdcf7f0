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
    (4096, 22016, 256), (4096, 32000, 256),
    (4096, 4096, 64), (256, 1000, 64), (512, 24, 32), (1024, 1000, 64),
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


@pytest.mark.parametrize("K,N,g", [(4096, 4096, 256), (11008, 4096, 256),
                                   (4096, 4096, 64), (1024, 1000, 64)])
def test_gemv_every_layout_and_plan(dev, K, N, g):
    """Every layout and plan the planner can pick holds to the plain version
    and repeats bit for bit (the last block of a column tile sums the K
    splits in split order), and the split counters are left at zero."""
    x, q, s = _operands(dev, 1, K, N, g, torch.bfloat16, torch.bfloat16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = qm.quant_gemv_ref(x, q, s, g)
    for ct in ((4, 8) if N % 16 == 0 else (8,)):
        for bps in (2, 4, 8):
            gps = qm.gemv_plan(K, N, g, sms, bps, ct)
            a = qm.gemv_launch(x, q, s, g, gps, ct)
            assert torch.equal(qm.gemv_launch(x, q, s, g, gps, ct), a)
            assert _rel(a, want) <= BF16_ULP
    torch.cuda.synchronize()
    assert int(qm._counters(dev, 1).abs().sum()) == 0


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


@pytest.mark.parametrize("M", [1, 8, 16, 33, 64, 128, 255])
@pytest.mark.parametrize("K,N,g", [(4096, 4096, 256), (1088, 100, 64), (192, 200, 64),
                                   (512, 24, 32), (640, 256, 8), (648, 264, 24)])
@pytest.mark.parametrize("x_dtype,s_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32),
])
def test_gemm_fast_every_m_tile(dev, M, K, N, g, x_dtype, s_dtype):
    """Fast mode at every block M tile (8, 16, 32, 64 rows; several tiles
    past 64), on the vector route and on ragged N (scalar loads), with a
    group size under 16 (scales read per k-row pair); deterministic."""
    x, q, s = _operands(dev, M, K, N, g, x_dtype, s_dtype, seed=M + N)
    got = qm.quant_gemm(x, q, s, g)
    want = qm.quant_gemm_ref(x, q, s, g)
    assert got.dtype == x_dtype and got.shape == (M, N)
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= (BF16_ULP if x_dtype == torch.bfloat16 else TOL["fast"])
    assert torch.equal(qm.quant_gemm(x, q, s, g), got)


def test_gemm_fast_ignores_scale_rows_past_k_over_g(dev):
    x, q, s = _operands(dev, 8, 1024, 512, 64, torch.bfloat16, torch.bfloat16)
    padded = torch.cat([s, torch.full((5, 512), float("nan"), device=dev,
                                      dtype=s.dtype)])
    assert torch.equal(qm.quant_gemm(x, q, padded, 64), qm.quant_gemm(x, q, s, 64))


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


# ---------------------------------------------------------------------------
# The big-model megakernel (csrc/fused_decode_big.cu) against its plain
# version: x_final and the new K/V rows to 1e-2 of max|plain|, as the small
# kernel. Its plan needs d / g to be a multiple of 16 (the JAX package's
# padded scale rows): dim 512 at g 32.


def _big_case(dev, family, s_bf16, g=32, L=2, dim=512, hidden=512, heads=4,
              kv_heads=2):
    return _fused_case(dev, family, "int8_bf16s" if s_bf16 else "int8", g, L=L,
                       dim=dim, hidden=hidden, heads=heads, kv_heads=kv_heads)


@pytest.mark.parametrize("family,s_bf16", [("llama2", True), ("llama2", False),
                                           ("qwen2", True)])
@pytest.mark.parametrize("int8_a", [True, False])
@pytest.mark.parametrize("cache", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pos", [0, 37, 255])
def test_fused_big_matches_plain(dev, family, s_bf16, int8_a, cache, pos):
    from kuiperllama_tpu_torch.ops.kernels import fused_decode_big as fb

    cfg, params = _big_case(dev, family, s_bf16)
    assert fb.plan_big(params["blocks"], cache, 256) is not None
    kernel = lambda *a: fb.fused_decode_step_big(*a, int8_a=int8_a)
    plain = lambda *a: fb.fused_decode_step_big_ref(*a, int8_a=int8_a)
    before = fb.fused_decode_step_big.launches
    x, k, v = _fused_run(cfg, params, dev, pos, 256, 512, cache, kernel)
    torch.cuda.synchronize()
    assert fb.fused_decode_step_big.launches == before + 1
    xr, kr, vr = _fused_run(cfg, params, dev, pos, 256, 512, cache, plain)
    assert x.dtype == xr.dtype and x.shape == xr.shape
    assert torch.isfinite(x.float()).all()
    assert _rel(x, xr) <= 1e-2
    for got, want in ((k, kr), (v, vr)):
        assert torch.equal(got[:, :pos], want[:, :pos])
        assert torch.equal(got[:, pos + 1:], want[:, pos + 1:])
        assert _rel(got[:, pos], want[:, pos]) <= 1e-2
    x2, k2, _ = _fused_run(cfg, params, dev, pos, 256, 512, cache, kernel)
    assert torch.equal(x2, x) and torch.equal(k2, k)


@pytest.mark.parametrize("g", [64, 128])
def test_fused_big_wide(dev, g):
    """TinyLlama-1.1B width (d / g = 32 and 16), held to the plain version
    run on the CPU, as the small kernel's full-width test."""
    from kuiperllama_tpu_torch.ops.kernels import fused_decode_big as fb

    cfg, params = _big_case(dev, "llama2", True, g=g, dim=2048, hidden=5632,
                            heads=32, kv_heads=4)
    x, k, v = _fused_run(cfg, params, dev, 100, 256, 512, torch.bfloat16,
                         fb.fused_decode_step_big)
    cpu = torch.device("cpu")
    xr, kr, vr = _fused_run(cfg, _to_cpu(params), cpu, 100, 256, 512,
                            torch.bfloat16, fb.fused_decode_step_big_ref)
    assert _rel(x.cpu(), xr) <= 1e-2
    assert _rel(k[:, 100].cpu(), kr[:, 100]) <= 1e-2
    assert _rel(v[:, 100].cpu(), vr[:, 100]) <= 1e-2


# chip_smoke.py BIG_CASES at full width, 2 layers: (preset, group size,
# bf16 scales); held to the plain version on the card within FUSED_TOL's
# 2-layer int8 limit, 5e-2
@pytest.mark.parametrize("preset,g,s_bf16", [("llama2-7b", 64, True),
                                             ("llama2-7b", 256, False),
                                             ("llama3-8b", 64, True)])
def test_fused_big_cases(dev, preset, g, s_bf16):
    from kuiperllama_tpu_torch.config import preset_config
    from kuiperllama_tpu_torch.fuse import fuse_params
    from kuiperllama_tpu_torch.ops.kernels import fused_decode_big as fb
    from kuiperllama_tpu_torch.params import random_params_device
    from kuiperllama_tpu_torch.quant import cast_scales

    cfg = preset_config(preset, n_layers=2, seq_len=512)
    params = random_params_device(cfg, device=dev, seed=1, quantize=True,
                                  group_size=g)
    if s_bf16:
        params = cast_scales(params, torch.bfloat16)
    params = fuse_params(params)
    assert fb.plan_big(params["blocks"], torch.bfloat16, 256) is not None
    before = fb.fused_decode_step_big.launches
    x, k, v = _fused_run(cfg, params, dev, 100, 256, 512, torch.bfloat16,
                         fb.fused_decode_step_big)
    torch.cuda.synchronize()
    assert fb.fused_decode_step_big.launches == before + 1
    xr, kr, vr = _fused_run(cfg, params, dev, 100, 256, 512, torch.bfloat16,
                            fb.fused_decode_step_big_ref)
    assert torch.isfinite(x.float()).all()
    assert _rel(x, xr) <= 5e-2
    for got, want in ((k, kr), (v, vr)):
        assert torch.equal(got[:, :100], want[:, :100])
        for li in range(cfg.n_layers):
            assert _rel(got[li, 100], want[li, 100]) <= 5e-2
    x2, _, _ = _fused_run(cfg, params, dev, 100, 256, 512, torch.bfloat16,
                          fb.fused_decode_step_big)
    assert torch.equal(x2, x)


def test_fused_big_trace_and_rejects(dev):
    from kuiperllama_tpu_torch.models import decoder
    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd
    from kuiperllama_tpu_torch.ops.kernels import fused_decode_big as fb

    cfg, params = _big_case(dev, "llama2", True)
    L = cfg.n_layers
    trace = torch.zeros(2 + 5 * L, dtype=torch.int64, device=dev)
    traced = lambda *a: fb.fused_decode_step_big(*a, trace=trace)
    x, _, _ = _fused_run(cfg, params, dev, 37, 256, 512, torch.bfloat16, traced)
    x0, _, _ = _fused_run(cfg, params, dev, 37, 256, 512, torch.bfloat16,
                          fb.fused_decode_step_big)
    assert torch.equal(x, x0)
    t = trace.cpu()
    assert bool((t[1:] >= t[:-1]).all()) and fd.phase_times(trace, L)["total"] > 0
    # dense weights have no big plan
    dcfg, dense = _fused_case(dev, "llama2", "bf16", 0, dim=512)
    sin, cos = decoder.build_rope(dcfg, dev)
    kc = torch.zeros((dcfg.n_layers, 256, dcfg.kv_dim), device=dev)
    p = torch.tensor([3], dtype=torch.int32, device=dev)
    x0 = dense["tok_emb"][torch.tensor([5], device=dev)]
    with pytest.raises(ValueError):
        fb.fused_decode_step_big(dcfg, dense, x0, kc, kc.clone(), p, sin, cos)
    x0 = params["tok_emb"][torch.tensor([5], device=dev)]
    with pytest.raises(TypeError):  # pos of the wrong type
        fb.fused_decode_step_big(cfg, params, x0, kc, kc.clone(), p.long(), sin, cos)


# ---------------------------------------------------------------------------
# The greedy chunk megakernel (csrc/fused_decode_chunk.cu) against its plain
# version on the card: the tokens equal up to an exact logit tie (at the
# first difference the plain version's logits of the two tokens lie within
# 2e-3 of max(1, max|logit|), and nothing after it is compared), and the K/V
# rows of the steps before it to 1e-2 of max|plain| per layer.


def _chunk_case(dev, family, kind, g, lm_quant, **dims):
    from kuiperllama_tpu_torch.quant import cast_scales, quantize_q80

    cfg, params = _fused_case(dev, family, kind, g, **dims)
    if lm_quant:
        lm = quantize_q80(params["lm_head"].float(), group_size=g)
        if kind == "int8_bf16s":
            lm = cast_scales(lm, torch.bfloat16)
        params = dict(params, lm_head=lm)
    return cfg, params


def _chunk_run(cfg, params, dev, pos, steps, cache_dtype, fn, **kw):
    from kuiperllama_tpu_torch.models import decoder

    gen = torch.Generator(device="cpu").manual_seed(pos)
    L, KV = cfg.n_layers, cfg.kv_dim
    full_k = torch.randn((L, 512, KV), generator=gen).to(dev, cache_dtype)
    full_v = torch.randn((L, 512, KV), generator=gen).to(dev, cache_dtype)
    sin, cos = (t.to(dev) for t in decoder.build_rope(cfg, "cpu"))
    x0 = params["tok_emb"][torch.tensor([5], device=dev)]
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    toks, _, _ = fn(cfg, params, x0, full_k[:, :256], full_v[:, :256], p, sin,
                    cos, steps, **kw)
    return toks.cpu().tolist(), full_k, full_v


def _hold_chunk(cfg, params, dev, pos, steps, cache_dtype):
    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd

    before = fd.fused_decode_chunk.launches
    got, k, v = _chunk_run(cfg, params, dev, pos, steps, cache_dtype,
                           fd.fused_decode_chunk)
    torch.cuda.synchronize()
    assert fd.fused_decode_chunk.launches == before + 1
    logits = []
    want, kr, vr = _chunk_run(cfg, params, dev, pos, steps, cache_dtype,
                              fd.fused_decode_chunk_ref, logits=logits)
    assert len(got) == steps and all(0 <= t < cfg.vocab_size for t in got)
    n = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), steps)
    if n < steps:
        row = logits[n]
        gap = abs(float(row[got[n]]) - float(row[want[n]]))
        assert gap <= 2e-3 * max(1.0, row.abs().max().item()), (n, got, want)
    for got_c, want_c in ((k, kr), (v, vr)):
        assert torch.equal(got_c[:, :pos], want_c[:, :pos])
        assert torch.equal(got_c[:, pos + steps:], want_c[:, pos + steps:])
        for li in range(cfg.n_layers):
            # rows up to the first differing token came from the same tokens
            assert _rel(got_c[li, pos:pos + n + 1], want_c[li, pos:pos + n + 1]) <= 1e-2
    return got


@pytest.mark.parametrize("family,kind,g,lm_quant", [
    ("llama2", "int8", 32, True), ("llama2", "int8_bf16s", 64, True),
    ("llama2", "int8", 8, True), ("qwen2", "int8", 32, False),
    ("qwen2", "bf16", 0, False), ("qwen2", "fp32", 0, False),
])
@pytest.mark.parametrize("cache", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pos", [0, 37, 240])
def test_fused_chunk_matches_plain(dev, family, kind, g, lm_quant, cache, pos):
    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd

    cfg, params = _chunk_case(dev, family, kind, g, lm_quant)
    got = _hold_chunk(cfg, params, dev, pos, 16, cache)
    again, _, _ = _chunk_run(cfg, params, dev, pos, 16, cache, fd.fused_decode_chunk)
    assert again == got  # fixed-order reductions: the same tokens every run


def test_fused_chunk_int8_lm_head(dev):
    """dim 512 at g 16: the lm_head's 32 group rows take the int8
    activation in the chunk kernel."""
    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd

    cfg, params = _chunk_case(dev, "llama2", "int8", 16, True, dim=512)
    assert fd.lm_int8_activation(params["lm_head"], cfg.dim)
    _hold_chunk(cfg, params, dev, 37, 16, torch.bfloat16)


def test_fused_chunk_rejects_bad_input(dev):
    from kuiperllama_tpu_torch.models import decoder
    from kuiperllama_tpu_torch.ops.kernels import fused_decode as fd

    cfg, params = _chunk_case(dev, "llama2", "int8", 32, True)
    sin, cos = decoder.build_rope(cfg, dev)
    x0 = params["tok_emb"][torch.tensor([5], device=dev)]
    kc = torch.zeros((cfg.n_layers, 256, cfg.kv_dim), device=dev)
    p = torch.tensor([3], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # an lm_head on the CPU
        lm = params["lm_head"]
        fd.fused_decode_chunk(cfg, dict(params, lm_head=lm.__class__(
            q=lm.q.cpu(), s=lm.s.cpu(), group_size=lm.group_size)), x0, kc,
            kc.clone(), p, sin, cos, 4)
    with pytest.raises(ValueError):  # no steps
        fd.fused_decode_chunk(cfg, params, x0, kc, kc.clone(), p, sin, cos, 0)


# ---------------------------------------------------------------------------
# The paged flash-decode kernel (csrc/paged_attention.cu) against its plain
# version. The normalised output acc / l is held relative to max|plain|: fp32
# pools 1e-6; bf16 pools 1e-3 (p is rounded to bf16 before the pv product on
# both sides, and a last-bit difference of the score sums can round it to the
# neighbouring bf16 value). m to 1e-6 of max|m|, l to 1e-5. chip_smoke.py
# holds the kernel to the same limits.


def _paged_case(dev, dtype, hd, kv_mul, ps, lens, KH=2, L=2, seed=0):
    """q [B, H, hd] and stacked pools [L, P, ps, KH*hd] in `dtype`, a
    shuffled page table, and the work list on the card."""
    from kuiperllama_tpu_torch.ops.kernels import paged_attention as pa

    rng = np.random.default_rng(seed)
    B, H = len(lens), KH * kv_mul
    max_pages = -(-max(lens) // ps) + 1
    P = B * max_pages + 1
    pools = [torch.from_numpy(rng.standard_normal((L, P, ps, KH * hd))
                              .astype(np.float32)).to(dev, dtype) for _ in range(2)]
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32)).to(dev, dtype)
    pt = rng.permutation(np.arange(1, P)).reshape(B, max_pages).astype(np.int32)
    sl = np.asarray(lens, np.int32)
    work = [torch.from_numpy(a).to(dev) for a in pa.build_work_list(pt, sl, ps)]
    return q, pools, work, torch.from_numpy(sl).to(dev)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("kv_mul", [1, 4, 7, 8])
@pytest.mark.parametrize("ps", [8, 128])
def test_paged_attention_matches_plain(dev, dtype, hd, kv_mul, ps):
    from kuiperllama_tpu_torch.ops.kernels import paged_attention as pa

    # ragged rows: one token, exact page multiples, a row with no items, a
    # partly filled last page
    lens = [1, ps, 0, 2 * ps, 3 * ps + 5, ps - 1]
    q, (kp, vp), work, sl = _paged_case(dev, dtype, hd, kv_mul, ps, lens)
    before = pa.paged_attention_flat.launches
    acc, m, l = pa.paged_attention_flat(q, kp, vp, *work, sl, page_size=ps,
                                        layer_idx=1)
    torch.cuda.synchronize()
    assert pa.paged_attention_flat.launches == before + 1
    ra, rm, rl = pa.paged_attention_flat_ref(q, kp, vp, *work, sl, page_size=ps,
                                             layer_idx=1)
    rows = sl > 0
    out, ref = (a[rows] / l_[rows][..., None] for a, l_ in ((acc, l), (ra, rl)))
    assert torch.isfinite(out).all()
    assert _rel(out, ref) <= (1e-6 if dtype == torch.float32 else 1e-3)
    assert _rel(m[rows], rm[rows]) <= 1e-6
    assert _rel(l[rows], rl[rows]) <= 1e-5
    # a row with no items gets the flash identity
    empty = ~rows
    assert (acc[empty] == 0).all() and (l[empty] == 0).all()
    assert (m[empty] == pa.NEG_INF).all()
    # deterministic: fixed-order sums, no atomics
    again = pa.paged_attention_flat(q, kp, vp, *work, sl, page_size=ps, layer_idx=1)
    assert all(torch.equal(a, b) for a, b in zip(again, (acc, m, l)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kv_mul", [1, 7])
def test_paged_attention_long_rows(dev, dtype, kv_mul):
    """Rows of 0, 1 and 9 pages (the last partly filled) on 128-token pages;
    deterministic."""
    from kuiperllama_tpu_torch.ops.kernels import paged_attention as pa

    lens = [0, 1, 9 * 128 - 50, 128]
    q, (kp, vp), work, sl = _paged_case(dev, dtype, 128, kv_mul, 128, lens)
    acc, m, l = pa.paged_attention_flat(q, kp, vp, *work, sl, page_size=128,
                                        layer_idx=1)
    ra, rm, rl = pa.paged_attention_flat_ref(q, kp, vp, *work, sl, page_size=128,
                                             layer_idx=1)
    rows = sl > 0
    out, ref = (a[rows] / l_[rows][..., None] for a, l_ in ((acc, l), (ra, rl)))
    assert _rel(out, ref) <= (1e-6 if dtype == torch.float32 else 1e-3)
    assert _rel(m[rows], rm[rows]) <= 1e-6 and _rel(l[rows], rl[rows]) <= 1e-5
    assert (m[~rows] == pa.NEG_INF).all() and (l[~rows] == 0).all()
    again = pa.paged_attention_flat(q, kp, vp, *work, sl, page_size=128, layer_idx=1)
    assert all(torch.equal(a, b) for a, b in zip(again, (acc, m, l)))


def test_paged_attention_no_items(dev):
    """n_items 0 (every row empty): every row gets the flash identity, and
    the kernel reads n_items on the device."""
    from kuiperllama_tpu_torch.ops.kernels import paged_attention as pa

    q, (kp, vp), work, sl = _paged_case(dev, torch.bfloat16, 64, 4, 8, [0, 0, 0])
    assert int(work[3].item()) == 0
    before = pa.paged_attention_flat.launches
    acc, m, l = pa.paged_attention_flat(q, kp, vp, *work, sl, page_size=8, layer_idx=0)
    torch.cuda.synchronize()
    assert pa.paged_attention_flat.launches == before + 1
    assert (acc == 0).all() and (l == 0).all() and (m == pa.NEG_INF).all()


def test_paged_attention_one_layer_pool_and_mixed_dtypes(dev):
    """A one-layer [P, ps, KH*hd] pool, and a bf16 query against fp32 pools
    (the kernel rounds K to the query's dtype, as the TPU kernel does)."""
    from kuiperllama_tpu_torch.ops.kernels import paged_attention as pa

    q, (kp, vp), work, sl = _paged_case(dev, torch.float32, 64, 4, 16, [40, 3])
    for qq in (q, q.to(torch.bfloat16)):
        got = pa.paged_attention_flat(qq, kp[1].contiguous(), vp[1].contiguous(),
                                      *work, sl, page_size=16)
        want = pa.paged_attention_flat_ref(qq, kp, vp, *work, sl, page_size=16,
                                           layer_idx=1)
        assert _rel(got[0] / got[2][..., None], want[0] / want[2][..., None]) <= 1e-6


def test_paged_attention_rejects_bad_input(dev):
    from kuiperllama_tpu_torch.ops.kernels import paged_attention as pa

    q, (kp, vp), work, sl = _paged_case(dev, torch.bfloat16, 64, 2, 8, [9])
    with pytest.raises(ValueError):  # stacked pools without a layer
        pa.paged_attention_flat(q, kp, vp, *work, sl, page_size=8)
    with pytest.raises(TypeError):  # an int64 work list
        pa.paged_attention_flat(q, kp, vp, work[0].long(), *work[1:], sl,
                                page_size=8, layer_idx=0)
    with pytest.raises(ValueError):  # a pool on the CPU
        pa.paged_attention_flat(q, kp.cpu(), vp, *work, sl, page_size=8,
                                layer_idx=0)
    with pytest.raises(ValueError):  # kv_mul 16 is past the kernel's tile
        q16 = torch.zeros((1, 32, 64), device=dev, dtype=torch.bfloat16)
        pa.paged_attention_flat(q16, kp, vp, *work, sl, page_size=8, layer_idx=0)


# ---------------------------------------------------------------------------
# The measurement tools' kernels (csrc/exp_kernel.cu, csrc/exp_int8.cu)


@pytest.mark.parametrize("K,N,tk,tn", [
    (2048, 2560, 2048, 512), (2048, 2048, 512, 512), (5632, 2048, 512, 2048),
    (4096, 1024, 1024, 1024), (256, 48, 128, 16), (96, 40, 32, 8),  # scalar loads
])
def test_exp_stream_equals_plain(dev, K, N, tk, tn):
    from kuiperllama_tpu_torch.tools import exp_kernel as ek

    rng = np.random.default_rng(K + N)
    q = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8)).to(dev)
    before = ek.exp_stream.launches
    got = ek.exp_stream(q, tk, tn)
    torch.cuda.synchronize()
    assert ek.exp_stream.launches == before + 1
    assert got.shape == (1, 1) and got.dtype == torch.float32
    assert torch.equal(got, ek.stream_ref(q, tk, tn))
    assert torch.equal(got.cpu(), ek.stream_ref(q.cpu(), tk, tn))


@pytest.mark.parametrize("M", [1, 8])
@pytest.mark.parametrize("s_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N,tk,tn", [
    (2048, 2560, 2048, 512), (5632, 2048, 512, 512), (2048, 32000, 2048, 256),
    (1024, 256, 256, 128),
])
def test_exp_outscale_matches_plain(dev, M, s_dtype, K, N, tk, tn):
    from kuiperllama_tpu_torch.tools import exp_kernel as ek

    x, q, s = _operands(dev, M, K, N, 64, torch.bfloat16, s_dtype, seed=M + K)
    before = ek.exp_outscale.launches
    got = ek.exp_outscale(x, q, s, tk, tn)
    torch.cuda.synchronize()
    assert ek.exp_outscale.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert _rel(got, ek.outscale_ref(x, q, s, tk, tn)) <= BF16_ULP
    assert torch.equal(ek.exp_outscale(x, q, s, tk, tn), got)


def test_exp_outscale_rejects_what_the_kernel_does_not_take(dev):
    from kuiperllama_tpu_torch.tools import exp_kernel as ek

    x, q, s = _operands(dev, 17, 512, 256, 64, torch.bfloat16, torch.float32)
    with pytest.raises(ValueError, match="M <= 16"):
        ek.exp_outscale(x, q, s, 512, 256)
    with pytest.raises(ValueError, match="do not divide"):
        ek.exp_outscale(x[:8], q, s, 384, 256)


def _int8_stack(dev, L, K, N, g, seed=0):
    """w, s, x on the card; x (bf16) has a group of zeros (d = 1) and a
    group with max|x| = 127 (d = 1) holding the .5 ties 2.5, -3.5, 0.5."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.integers(-127, 128, (L, K, N)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(0.005, 0.02, (L, K // g, N)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((1, K)).astype(np.float32)).to(torch.bfloat16)
    x[0, g:2 * g] = 0
    x[0, 2 * g:2 * g + 5] = torch.tensor([127.0, 2.5, -3.5, 0.5, -1.5])
    return w.to(dev), s.to(dev), x.to(dev)


@pytest.mark.parametrize("g", [64, 128])
@pytest.mark.parametrize("mode,nsplit", [
    ("nodot", 1), ("nodot", 2), ("nodot", 4), ("bf16", 1), ("bf16", 4),
    ("split4", 1), ("split4", 4), ("int8", 1), ("int8", 4), ("int8_split4", 1),
    ("int8_split4", 4), ("plain8", 1),
])
def test_exp_int8_matches_plain(dev, mode, nsplit, g):
    from kuiperllama_tpu_torch.tools import exp_int8 as ei

    w, s, x = _int8_stack(dev, 3, 2048, 512, g, seed=g + nsplit)
    before = ei.exp_int8.launches
    got = ei.exp_int8(w, s, x, g, mode, nsplit)
    torch.cuda.synchronize()
    assert ei.exp_int8.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (1, 512)
    want = ei.exp_int8_ref(w, s, x, g, mode, nsplit)
    if mode == "nodot":
        assert torch.equal(got, want)
    else:
        assert _rel(got, want) <= 1e-5
        assert _rel(got.cpu(), ei.exp_int8_ref(w.cpu(), s.cpu(), x.cpu(), g, mode,
                                               nsplit)) <= 1e-5
    assert torch.equal(ei.exp_int8(w, s, x, g, mode, nsplit), got)


def test_exp_int8_at_the_tool_shape(dev):
    from kuiperllama_tpu_torch.tools import exp_int8 as ei

    w, s, x = ei.make_stack(dev, 2, 4096, 2048, 64)
    for mode in ei.MODES:
        nsplit = ei.default_nsplit(mode)
        got = ei.exp_int8(w, s, x, 64, mode, nsplit)
        want = ei.exp_int8_ref(w, s, x, 64, mode, nsplit)
        if mode == "nodot":
            assert torch.equal(got, want)
        else:
            assert _rel(got, want) <= 1e-5, (mode, _rel(got, want))


def test_exp_int8_refuses_shapes(dev):
    from kuiperllama_tpu_torch.tools import exp_int8 as ei

    w, s, x = _int8_stack(dev, 1, 1536, 256, 64)
    with pytest.raises(ValueError, match="multiple of 1024"):
        ei.exp_int8(w, s, x, 64, "plain8")
    with pytest.raises(ValueError, match="nsplit 3"):
        ei.exp_int8(w, s, x, 64, "int8", 3)
    w2, s2, x2 = _int8_stack(dev, 1, 1024, 320, 64)
    with pytest.raises(ValueError, match="multiple of 256"):
        ei.exp_int8(w2, s2, x2, 64, "bf16")
