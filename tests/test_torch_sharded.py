"""The port's tensor/data-parallel forward (parallel/sharded.py ShardedForward
over parallel/shardings.py's slices) against the JAX package, the
counterpart of tests/test_sharded.py.

The JAX side runs in this process on its single device with the Pallas
kernels off (XLA's INT8 matmul); JAX's own tests hold its sharded forward to
that. The port side runs on 4 gloo ranks on the CPU (one pool for the file,
tests/torch_rank_cases.py), fed the same numpy weights and tokens; the test
gathers the data rows and the kv heads. Tolerances as tests/test_sharded.py:
logits atol 2e-4 / rtol 1e-4, cache 1e-5.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import torch_rank_cases as rc
from kuiperllama_tpu.config import tiny_config as jtiny
from kuiperllama_tpu.models import decoder as jdec
from kuiperllama_tpu.ops.linear import set_use_pallas
from kuiperllama_tpu.params import random_params, to_device
from kuiperllama_tpu.quant import quantize_q80
from kuiperllama_tpu.serving.generate import Generator as JGenerator
from kuiperllama_tpu_torch.config import preset_config
from kuiperllama_tpu_torch.parallel.shardings import validate_tp
from torch_threads import one_thread  # noqa: F401

CFG = dict(family="llama2", n_heads=8, n_kv_heads=4, dim=128, hidden_dim=128,
           vocab_size=256, seq_len=64)


@pytest.fixture(autouse=True)
def _no_pallas():
    set_use_pallas(False)
    yield
    set_use_pallas(True)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with rc.open_pool(tmp_path_factory.mktemp("rdv"), 4) as p:
        yield p


def _quantize_tree(params, g=32):
    out = dict(params, blocks=dict(params["blocks"]))
    for name in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
        out["blocks"][name] = quantize_q80(jnp.asarray(params["blocks"][name]), g)
    return out


def _jparams(seed, quant):
    cfg = jtiny(**CFG)
    params = to_device(random_params(cfg, seed=seed), dtype=jnp.float32)
    return cfg, (_quantize_tree(params) if quant else params)


def _gather_cache(outs, dp, tp):
    """The global K cache [L, B, S, KH, hd] from every rank's part."""
    rows = []
    for d in range(dp):
        parts = sorted((o for o in outs if o and o["dp_rank"] == d),
                       key=lambda o: o["tp_rank"])
        rows.append(np.concatenate([o["k"] for o in parts], axis=3))
    return np.concatenate(rows, axis=1)


def _logits(outs):
    """Data rows gathered; every model rank of a row holds the same logits."""
    for o in outs:
        if o is not None:
            mate = rc.by_rank(outs)[o["dp_rank"]]
            np.testing.assert_array_equal(o["logits"], mate["logits"])
    return np.concatenate([o["logits"] for o in rc.by_rank(outs)])


@pytest.mark.parametrize("dp,tp", [(1, 2), (1, 4), (2, 2)])
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_sharded_matches_jax(pool, dp, tp, quant):
    cfg, params = _jparams(0, quant)
    B, T = 2 * dp, 6
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    positions = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T))
    cache = jdec.init_kv_cache(cfg, batch=B, max_len=32)
    want, want_cache = jdec.forward(cfg, params, jnp.asarray(tokens), positions, cache)

    outs = pool.run(rc.sharded_forward, CFG, rc.numpy_tree(params), tokens, dp, tp)
    np.testing.assert_allclose(_logits(outs), np.asarray(want), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(_gather_cache(outs, dp, tp), np.asarray(want_cache["k"]),
                               atol=1e-5, rtol=1e-5)


def test_padded_scale_rows_match_jax_single_device(pool):
    """INT8 leaves quantized BEFORE to_device, as a checkpoint loads: the JAX
    package pads each weight's scale rows to a multiple of 16, and its
    row-parallel sharding hands rank 1 of wo/w2 padding rows (its sharded
    logits are off by the logits' own size here). The port keeps exactly
    in // g scale rows and splits them with q: tp = 2 holds to JAX's
    single-device forward on the padded leaves."""
    from kuiperllama_tpu.quant import quantize_q80 as jq

    kw = dict(CFG, hidden_dim=256)
    cfg = jtiny(**kw)
    raw = random_params(cfg, seed=5)
    blocks = dict(raw["blocks"])
    for name in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
        qa = jq(jnp.asarray(blocks[name]), 32)
        blocks[name] = dict(q=np.asarray(qa.q), s=np.asarray(qa.s), group_size=32)
    params = to_device(dict(raw, blocks=blocks), dtype=jnp.float32)
    assert params["blocks"]["wo"].s.shape[-2] == 16  # 4 groups, padded
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    positions = jnp.broadcast_to(jnp.arange(5, dtype=jnp.int32), (2, 5))
    want, _ = jdec.forward(cfg, params, jnp.asarray(tokens), positions,
                           jdec.init_kv_cache(cfg, batch=2, max_len=32))
    outs = pool.run(rc.sharded_forward, kw, rc.numpy_tree(params), tokens, 1, 2)
    np.testing.assert_allclose(_logits(outs), np.asarray(want), atol=2e-4, rtol=1e-4)

    # the reference fault the port does not copy: JAX's own tp = 2 forward
    # on these leaves is far from its single-device one
    from kuiperllama_tpu.parallel.mesh import make_mesh
    from kuiperllama_tpu.parallel.sharded import ShardedForward
    from kuiperllama_tpu.parallel.shardings import shard_params

    mesh = make_mesh(dp=1, tp=2)
    fwd = ShardedForward(cfg, mesh, params)
    jax_tp, _ = fwd(cfg, shard_params(params, mesh, cfg), jnp.asarray(tokens),
                    positions, fwd.init_cache(batch=2, max_len=32))
    assert np.abs(np.asarray(jax_tp) - np.asarray(want)).max() > 0.1 * np.abs(
        np.asarray(want)).max()


def test_sharded_decode_steps_match_jax(pool):
    cfg, params = _jparams(1, False)
    tokens = np.asarray([[3, 7, 11, 2], [9, 1, 4, 8]], np.int32)
    tok, pos = np.asarray([5, 6], np.int32), np.asarray([4, 4], np.int32)
    outs = pool.run(rc.sharded_decode, CFG, rc.numpy_tree(params), tokens, tok, pos,
                    3, 2, 2)
    rows = rc.by_rank(outs)
    got = [np.concatenate([o["logits"][i] for o in rows]) for i in range(4)]
    # the prefill's lm_head and gather cover each row's last position only
    assert all(o["prefill_gather_bytes"] == cfg.vocab_size * 4 for o in outs if o)

    cache = jdec.init_kv_cache(cfg, batch=2, max_len=32)
    want, cache = jdec.prefill(cfg, params, jnp.asarray(tokens), cache)
    np.testing.assert_allclose(got[0], np.asarray(want), atol=2e-4, rtol=1e-4)
    jt, jp = jnp.asarray(tok), jnp.asarray(pos)
    for step in range(3):
        want, cache = jdec.decode_step(cfg, params, jt, jp, kv_cache=cache)
        np.testing.assert_allclose(got[step + 1], np.asarray(want), atol=2e-4,
                                   rtol=1e-4, err_msg=f"step {step}")
        jt = jnp.argmax(jnp.asarray(got[step + 1]), -1).astype(jnp.int32)
        jp = jp + 1


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_fused_after_sharding_matches_jax(pool, quant):
    """Shard first, fuse per rank (fuse.fuse_params on each rank's slices): logits match the
    unfused single-device forward."""
    cfg, params = _jparams(3, quant)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    positions = jnp.broadcast_to(jnp.arange(5, dtype=jnp.int32), (2, 5))
    want, _ = jdec.forward(cfg, params, jnp.asarray(tokens), positions,
                           jdec.init_kv_cache(cfg, batch=2, max_len=32))
    outs = pool.run(rc.sharded_forward, CFG, rc.numpy_tree(params), tokens, 1, 4, True)
    assert all(o["fused"] for o in outs)
    np.testing.assert_allclose(_logits(outs), np.asarray(want), atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("api", [False, True], ids=["generator", "api"])
def test_sharded_generator_matches_jax(pool, api):
    """Greedy tokens of the tp = 4 Generator (and of KuiperModel.init(mesh=))
    equal the JAX single-device Generator's exactly, the same on every rank;
    gloo's collectives cannot be captured, so the route is eager."""
    cfg, params = _jparams(2, False)
    prompts = [[3, 9, 1], [7, 2, 5, 5, 1]]
    want = [JGenerator(cfg, params, cache_len=64).generate_ids(p, max_new_tokens=10)[0]
            for p in prompts]
    outs = pool.run(rc.sharded_generate, CFG, rc.numpy_tree(params), prompts, 10, 4, api)
    for o in outs:
        assert o["ids"] == want and o["graphs"] is False
    if api:
        positions = jnp.arange(len(prompts[0]), dtype=jnp.int32)[None]
        logits, _ = jdec.forward(cfg, params, jnp.asarray([prompts[0]], jnp.int32),
                                 positions, jdec.init_kv_cache(cfg, 1, max_len=8))
        np.testing.assert_allclose(outs[0]["logits"], np.asarray(logits)[0],
                                   atol=2e-4, rtol=1e-4)


def test_validate_tp_group_divisibility():
    """Llama-2-7B at tp = 2: g 256 leaves wo 2048 rows (8 groups) but w2
    5504 rows, 21.5 groups, and is refused at setup; g 64 splits w2 into 86
    groups a rank and passes. Shape-only configs: no 7B weights."""
    cfg = preset_config("llama2-7b")
    with pytest.raises(ValueError, match="w2.*256-row scale groups"):
        validate_tp(cfg, 2, 256)
    validate_tp(cfg, 2, 64)
    validate_tp(cfg, 2)  # dense weights: no groups to split
    with pytest.raises(ValueError, match="n_kv_heads"):
        validate_tp(preset_config("llama3-8b"), 16)

