"""The plain versions of the port's int8 stream probe and output-scale
matmul (kuiperllama_tpu_torch/tools/exp_kernel.py) against the JAX tool's
Pallas kernels on the same numpy inputs, and the exp_kernel and
bench_kernels CLIs.

The JAX side is tools/exp_kernel.py itself, imported by path (its import
edits os.environ and sys.path, which `load_jax_tool` restores), with the
module's `pl` replaced by a namespace whose `pallas_call` runs the Pallas
interpreter; nothing in it is edited. Tolerances: `stream` sums integers,
so the plain version equals JAX exactly wherever every partial sum stays
below 2^24, and within 1e-6 relative above; `outscale` rounds once to bf16
on each side after fp32 sums in different orders, so one bf16 ulp, 2^-7 of
max|JAX|.
"""

import functools
import importlib.util
import json
import os
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from kuiperllama_tpu_torch.tools import bench_kernels as tb
from kuiperllama_tpu_torch.tools import exp_kernel as tk
from torch_threads import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def load_jax_tool(name: str):
    """tools/<name>.py as a module whose Pallas calls run interpreted; the
    import's edits of os.environ and sys.path are undone."""
    env, path = dict(os.environ), list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            f"_jax_tool_{name}", REPO / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path
    if hasattr(mod, "pl"):
        ns = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                      if not k.startswith("_")})
        ns.pallas_call = functools.partial(pl.pallas_call, interpret=True)
        mod.pl = ns
    return mod


@pytest.fixture(scope="module")
def jk():
    return load_jax_tool("exp_kernel")


def test_loader_restores_environment():
    env, path = dict(os.environ), list(sys.path)
    load_jax_tool("exp_kernel")
    assert dict(os.environ) == env and sys.path == path


@pytest.mark.parametrize("K,N,tk_,tn", [
    (256, 256, 256, 256),    # one column tile, one k tile
    (512, 256, 128, 256),    # one column tile, four k tiles
    (128, 1024, 128, 256),   # four column tiles, one k tile
    (256, 512, 128, 256),    # two of each
])
def test_stream_plain_equals_jax(jk, K, N, tk_, tn):
    q = np.random.default_rng(K + N).integers(-127, 128, (K, N)).astype(np.int8)
    want = np.asarray(jk.stream(jnp.asarray(q), tk_, tn))
    got = tk.exp_stream(torch.from_numpy(q), tk_, tn)
    assert got.shape == (1, 1) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the value is the last column tile's sum, not the whole matrix's
    assert got.item() == q[:, N - tn:].astype(np.int64).sum()


def test_stream_plain_above_2_24(jk):
    q = np.random.default_rng(3).integers(100, 128, (1024, 512)).astype(np.int8)
    want = np.asarray(jk.stream(jnp.asarray(q), 512, 512))
    got = tk.exp_stream(torch.from_numpy(q), 512, 512).numpy()
    assert abs(want[0, 0]) > 2 ** 24
    assert abs(got[0, 0] - want[0, 0]) <= 1e-6 * abs(want[0, 0])


@pytest.mark.parametrize("M,K,N,tk_,tn,s_bf16", [
    (8, 512, 512, 256, 256, False),    # two k tiles, two column tiles
    (8, 256, 256, 2048, 512, True),    # JAX's clamps: tk = K, tn = N
    (1, 512, 256, 512, 128, False),
    (1, 1024, 256, 256, 256, True),
])
def test_outscale_plain_matches_jax(jk, M, K, N, tk_, tn, s_bf16):
    rng = np.random.default_rng(M * K + N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    q = rng.integers(-127, 128, (K, N)).astype(np.int8)
    s = rng.uniform(0.005, 0.02, (K // 64, N)).astype(np.float32)
    sdt_j, sdt_t = (jnp.bfloat16, torch.bfloat16) if s_bf16 else (jnp.float32, torch.float32)
    want = np.asarray(jk.outscale(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q),
                                  jnp.asarray(s, sdt_j), tk_, tn).astype(jnp.float32))
    got = tk.exp_outscale(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(q),
                          torch.from_numpy(s).to(sdt_t), tk_, tn)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= 2.0 ** -7, err


def test_refused_tiles():
    q = torch.zeros((512, 640), dtype=torch.int8)
    with pytest.raises(ValueError, match="do not divide"):
        tk.exp_stream(q, 512, 512)
    with pytest.raises(ValueError, match="do not divide"):
        tk.exp_outscale(torch.zeros((8, 512)), q, torch.ones((8, 640)), 512, 512)


def test_sweep_tiles_divide_every_shape():
    assert tk.sweep_tiles(2048, 2560) == (2048, 512)
    assert tk.sweep_tiles(5632, 2048) == (512, 512)
    assert tk.sweep_tiles(2048, 32000) == (2048, 256)
    # the JAX tool's stream tiles leave lm_head out
    assert not [t for t in tk.STREAM_TILES if 2048 % t[0] == 0 and 32000 % t[1] == 0]


def test_exp_kernel_main_on_cpu(capsys):
    rows = tk.main(["--device", "cpu", "--shapes", "a=1024x1024,512x2048"])
    by = [(r["shape"], r["variant"], r["tk"], r["tn"]) for r in rows]
    assert by == [("a", "stream", 1024, 512), ("a", "stream", 512, 512),
                  ("a", "stream", 1024, 1024), ("a", "current", None, None),
                  ("a", "outscale", 1024, 512),
                  ("512x2048", "stream", 512, 512), ("512x2048", "stream", 512, 2048),
                  ("512x2048", "current", None, None),
                  ("512x2048", "outscale", 512, 512)]
    for r in rows:
        assert r["us"] > 0 and r["GBps"] > 0 and r["M"] == 8 and r["device"] == "cpu"
    out = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line)["variant"] for line in out] == [r["variant"] for r in rows]


def test_bench_kernels_keys_are_jax_s(monkeypatch, capsys):
    jb = load_jax_tool("bench_kernels")
    monkeypatch.setattr(jb, "bench_quant_shape", lambda *a, **k: (1.0, 1e-6))
    monkeypatch.setattr(sys, "argv", ["bench_kernels.py", "--model", "stories15m",
                                      "--group-size", "32"])
    jb.main()
    want = json.loads(capsys.readouterr().out)
    got = tb.main(["--device", "cpu", "--model", "stories15m", "--group-size", "32"])
    assert set(got) == set(want) - {"block_out", "block_in"} | {"device"}
    assert got["device"] == "cpu"
    for name in ("wqkv", "wo", "w13", "w2", "lm_head"):
        assert set(got[name]) == set(want[name])
        assert (got[name]["K"], got[name]["N"]) == (want[name]["K"], want[name]["N"])
        assert got[name]["us"] > 0
    assert got["matmuls_only_ms_per_token"] > 0


@pytest.mark.parametrize("variant", ["kernel-layered", "torch"])
def test_bench_kernels_variants_on_cpu(variant):
    out = tb.main(["--device", "cpu", "--model", "stories15m", "--group-size", "32",
                   "--variant", variant, "--m", "8", "--layers", "2",
                   "--shapes", "wo,w2"])
    assert set(out) == {"model", "M", "variant", "scales_dtype", "device", "wo", "w2"}
    assert out["wo"]["GBps"] > 0 and out["w2"]["us"] > 0


@pytest.mark.parametrize("rows,groups", [(1, 64), (1, 65), (3, 64)])
def test_kernel_variant_routes_like_linear(rows, groups):
    """The kernel variant calls ops/linear.py's `quant_kernel`, the branch
    that `linear` takes below 256 rows (GEMV at one row with <= 64 groups,
    else GEMM)."""
    from kuiperllama_tpu_torch.ops import linear as tlin
    from kuiperllama_tpu_torch.quant import QuantTensor

    g, N = 32, 96
    gen = torch.Generator().manual_seed(rows * groups)
    q = torch.randint(-127, 128, (groups * g, N), generator=gen, dtype=torch.int8)
    s = torch.rand((groups, N), generator=gen) + 0.5
    x = torch.randn((rows, groups * g), generator=gen)
    assert tb.quant_kernel is tlin.quant_kernel
    assert torch.equal(tlin.quant_kernel(x, q, s, g),
                       tlin.linear(x, QuantTensor(q, s, g)))
    routed = tlin.quant_gemv if rows == 1 and groups <= 64 else tlin.quant_gemm
    assert torch.equal(tlin.quant_kernel(x, q, s, g), routed(x, q, s, g))


@pytest.mark.parametrize("main", [tk.main, tb.main])
def test_main_without_a_card_exits_nonzero(main):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would measure")
    with pytest.raises(SystemExit) as e:
        main([])
    assert e.value.code not in (0, None)
