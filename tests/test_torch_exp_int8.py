"""The plain version of the port's stacked int8 GEMV probe
(kuiperllama_tpu_torch/tools/exp_int8.py) against the JAX tool's Pallas
kernel on the same numpy inputs, and the tool's CLI.

The JAX tool's `run` returns its fori_loop carry, not the kernel's output,
so the test builds the `pallas_call` of `tools/exp_int8.py` `_kernel`
itself, as `run` does (without its TPU compiler parameters), and runs it
under the Pallas interpreter. Tolerances, max-abs error relative to
max|JAX|: `nodot` sums small integers and must be equal; the other modes
1e-5 (the products are exact in fp32 on both sides, only fp32 summation
order differs; the int8 modes' quantization of x is the same IEEE division
and half-to-even rounding on both sides).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from test_torch_exp_kernel import load_jax_tool
from kuiperllama_tpu_torch.tools import exp_int8 as tx
from torch_threads import one_thread  # noqa: F401

L, K, N = 2, 2048, 256


def _jax_exp_int8(jt, w, s, x, g, mode, nsplit):
    """The pallas_call of `run` (tools/exp_int8.py:133-151), interpreted."""
    Lw, Kw, Nw = w.shape
    TN = Nw // nsplit
    in_specs = [
        pl.BlockSpec((1, Kw, TN), functools.partial(lambda l, j=j: (l, 0, j)))
        for j in range(nsplit)
    ] + [
        pl.BlockSpec((1, Kw // g, Nw), lambda l: (l, 0, 0)),
        pl.BlockSpec((1, Kw), lambda l: (0, 0)),
    ]
    return pl.pallas_call(
        functools.partial(jt._kernel, g=g, mode=mode, nsplit=nsplit),
        grid=(Lw,),
        in_specs=in_specs,
        out_specs=pl.BlockSpec((1, Nw), lambda l: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((1, Nw), jnp.float32),
        scratch_shapes=[pltpu.VMEM((1, Nw), jnp.float32)],
        interpret=True,
    )(*([w] * nsplit), s, x)


def _inputs(g, seed=0):
    """w, s, x as numpy; x (bf16 values) has a group of zeros (d = 1) and a
    group with max|x| = 127 (d = 1), whose 2.5, -3.5 and 0.5 are exact .5
    ties of x / d."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-127, 128, (L, K, N)).astype(np.int8)
    s = rng.uniform(0.005, 0.02, (L, K // g, N)).astype(np.float32)
    x = rng.standard_normal((1, K)).astype(np.float32)
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    x[0, g:2 * g] = 0.0
    x[0, 2 * g:2 * g + 5] = [127.0, 2.5, -3.5, 0.5, -1.5]
    return w, s, x


@pytest.fixture(scope="module")
def jt():
    return load_jax_tool("exp_int8")


CASES = [(m, tx.default_nsplit(m)) for m in tx.MODES] + [("nodot", 2)]


@pytest.mark.parametrize("g", [64, 128])
@pytest.mark.parametrize("mode,nsplit", CASES)
def test_plain_matches_jax_kernel(jt, mode, nsplit, g):
    w, s, x = _inputs(g, seed=g)
    want = np.asarray(_jax_exp_int8(jt, jnp.asarray(w), jnp.asarray(s),
                                    jnp.asarray(x, jnp.bfloat16), g, mode, nsplit))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = tx.exp_int8(torch.from_numpy(w), torch.from_numpy(s), xt, g, mode, nsplit)
    assert got.dtype == torch.float32 and got.shape == (1, N)
    got = got.numpy()
    if mode == "nodot":
        np.testing.assert_array_equal(got, want)
        assert not got[0, N // nsplit:].any()
    else:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-5, err


def test_int8_mode_rounds_ties_to_even():
    """The zero group quantizes with d = 1 and contributes nothing; the tie
    group's 2.5, -3.5, 0.5 and -1.5 land on 2, -4, 0 and -2."""
    g = 64
    w, s, x = _inputs(g)
    w[:] = 0
    w[:, 2 * g:2 * g + 5, :] = 1
    s[:] = 1.0
    got = tx.exp_int8_ref(torch.from_numpy(w), torch.from_numpy(s),
                          torch.from_numpy(x), g, "int8")
    # d = 127 / 127 = 1: 127 + 2 - 4 + 0 - 2 = 123 per layer
    np.testing.assert_array_equal(got.numpy(), np.full((1, N), 2 * 123.0, np.float32))


def test_refused_shapes():
    w = torch.zeros((1, 512, 256), dtype=torch.int8)
    s = torch.ones((1, 512 // 64, 256))
    x = torch.ones((1, 512), dtype=torch.bfloat16)
    for mode in ("bf16", "split4", "plain8"):
        with pytest.raises(ValueError, match="multiple of 1024"):
            tx.exp_int8(w, s, x, 64, mode)
    with pytest.raises(ValueError, match="does not divide K"):
        tx.exp_int8(w, s[:, :5], x, 100, "int8")
    with pytest.raises(ValueError, match="nsplit 3"):
        tx.exp_int8(w, s, x, 64, "int8", 3)
    with pytest.raises(ValueError, match="mode"):
        tx.exp_int8(w, s, x, 64, "fp8")


def test_main_on_cpu_prints_every_mode(capsys):
    rows = tx.main(["--device", "cpu", "--L", "2", "--K", "1024", "--N", "256",
                    "--modes", ",".join(tx.MODES)])
    assert [r["mode"] for r in rows] == list(tx.MODES)
    assert [r["nsplit"] for r in rows] == [1, 1, 4, 1, 4, 1]
    for r in rows:
        assert r["device"] == "cpu" and r["ms_per_pass"] > 0
        assert r["bytes"] == 2 * 1024 * 256 + 2 * 16 * 256 * 4
    assert len(capsys.readouterr().out.strip().splitlines()) == len(tx.MODES)


def test_main_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would measure")
    with pytest.raises(SystemExit) as e:
        tx.main([])
    assert e.value.code not in (0, None)
