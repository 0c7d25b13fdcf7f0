"""Q8_0 quantization of the port against the JAX package: bit-equal int8
values and scales, ties rounded half to even on both sides."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kuiperllama_tpu import quant as jq
from kuiperllama_tpu_torch import quant as tq


def test_torch_round_is_half_to_even():
    got = torch.round(torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]))
    assert got.tolist() == [0.0, 2.0, 2.0, -0.0, -2.0, -2.0, 4.0]
    assert np.asarray(jnp.round(jnp.asarray([0.5, 1.5, 2.5]))).tolist() == [0.0, 2.0, 2.0]


@pytest.mark.parametrize("g", [64, 256])
@pytest.mark.parametrize("shape", [(512, 384), (2, 512, 256)])
def test_quantize_bit_equal(g, shape):
    rng = np.random.default_rng(g)
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    # exact .5 ties: a group whose absmax is 127 has scale exactly 1.0, so
    # w / scale lands on x.5 and the rounding rule decides
    w[..., :g, 0] = 0.5 + np.arange(g, dtype=np.float32) % 7 - 3
    w[..., 0, 0] = 127.0
    j = jq.quantize_q80(w, g)
    t = tq.quantize_q80(torch.from_numpy(w), g)
    assert t.q.dtype == torch.int8 and t.s.dtype == torch.float32
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
    np.testing.assert_array_equal(t.s.numpy(), np.asarray(j.s))
    ties = w[..., 1:g, 0].ravel()
    np.testing.assert_array_equal(t.q.numpy()[..., 1:g, 0].ravel(),
                                  np.round(ties).astype(np.int8))


def test_quantize_zero_group_and_dequantize():
    w = np.zeros((128, 64), np.float32)
    w[64:] = np.linspace(-1, 1, 64 * 64, dtype=np.float32).reshape(64, 64)
    t = tq.quantize_q80(torch.from_numpy(w), 64)
    j = jq.quantize_q80(w, 64)
    assert (t.q[:64] == 0).all() and (t.s[0] == 0).all()
    np.testing.assert_array_equal(tq.dequantize(t).numpy(),
                                  np.asarray(jq.dequantize(j)))


def test_quantize_q80_np_equal():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((96, 256)).astype(np.float32)
    for a, b in zip(tq.quantize_q80_np(w, 64), jq.quantize_q80_np(w, 64)):
        np.testing.assert_array_equal(a, b)


def test_cast_scales_and_layer_views():
    t = tq.quantize_q80(torch.randn(3, 128, 32), 64)
    params = {"blocks": {"w": t, "attn_norm": torch.ones(3, 128)}, "x": t}
    out = tq.cast_scales(params)
    assert out["blocks"]["w"].s.dtype == torch.bfloat16
    assert out["x"].s.dtype == torch.bfloat16
    assert out["blocks"]["attn_norm"].dtype == torch.float32
    layer = t[1]
    assert layer.q.data_ptr() == t.q.data_ptr() + 128 * 32
    assert layer.q.is_contiguous() and layer.s.shape == (2, 32)
