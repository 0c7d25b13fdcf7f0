"""The port's tensor-parallel paged serving (PagedEngine(mesh=) over
parallel/sharded_paged.py) against the JAX package's single-device
PagedEngine, the counterpart of tests/test_sharded_paged.py: greedy tokens
equal exactly at fp32, on 2 gloo ranks on the CPU (tests/torch_rank_cases.py),
the same on both ranks. The JAX side runs its paged kernel under the Pallas
interpreter with its INT8 matmuls in XLA; the ranks take the plain INT8
matmul."""

import jax.numpy as jnp
import pytest

import torch_rank_cases as rc
from kuiperllama_tpu.config import tiny_config as jtiny
from kuiperllama_tpu.ops.linear import set_use_pallas
from kuiperllama_tpu.params import random_params, to_device
from kuiperllama_tpu.quant import quantize_q80
from kuiperllama_tpu.serving.engine import PagedEngine, Request
from torch_threads import one_thread  # noqa: F401

PROMPTS = [[1, 5, 9], [2, 3], [7, 7, 7, 7], [4, 11]]
ENGINE = dict(max_batch=2, max_len=64, chunk=4, page_size=128)


@pytest.fixture(autouse=True)
def _xla_path():
    set_use_pallas(False)
    yield
    set_use_pallas(True)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with rc.open_pool(tmp_path_factory.mktemp("rdv"), 2) as p:
        yield p


def _quantized(params):
    blocks = dict(params["blocks"])
    for name in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
        blocks[name] = quantize_q80(params["blocks"][name], group_size=32)
    return dict(params, blocks=blocks)


def _jax_tokens(cfg, params):
    eng = PagedEngine(cfg, params, cache_dtype=jnp.float32, **ENGINE)
    reqs = [Request(prompt_ids=list(p), max_new_tokens=9) for p in PROMPTS]
    eng.run(reqs)
    return [r.out_ids for r in reqs]


@pytest.mark.parametrize("family,quant,seed", [
    ("llama2", False, 21), ("llama2", True, 21), ("qwen2", True, 31)],
    ids=["fp32", "int8", "qwen2-bias-fused"])
def test_sharded_paged_matches_jax(pool, family, quant, seed):
    """fp32, INT8 weights (BASELINE configs[3]'s combination) and Qwen2's qkv
    biases through the per-rank fused bqkv: tp = 2 tokens == the JAX
    single-device engine's; the pools hold each rank's half of the lanes."""
    kw = dict(family=family, seq_len=64)
    cfg = jtiny(**kw)
    params = to_device(random_params(cfg, seed=seed), dtype=jnp.float32)
    if quant:
        params = _quantized(params)
    assert cfg.qkv_bias == (family == "qwen2")
    want = _jax_tokens(cfg, params)
    outs = pool.run(rc.paged_engine, kw, rc.numpy_tree(params), PROMPTS, 9, 2, ENGINE)
    for o in outs:
        assert o["out_ids"] == want
        assert o["pool_shape"][-1] == cfg.n_kv_heads * cfg.head_dim // 2
        assert o["graphs"] is False  # gloo: the eager route


@pytest.mark.parametrize("seqpar", [False, True], ids=["tp", "seqpar"])
def test_paged_step_entry_points_match_jax(pool, seqpar):
    """ShardedPagedStep (tp = 2, lanes) and SeqParPagedStep (sp = 2, pages)
    called directly with JAX's signatures: shard_pages, prefill, then one
    decode_chunk of 6 greedy steps equal JAX's single-device prefill_paged
    and decode_chunk_paged on the same page table (pages spread over both
    ranks' blocks; 0 and 8 are the garbage pages)."""
    import jax
    import numpy as np

    from kuiperllama_tpu.kvcache import init_paged_cache
    from kuiperllama_tpu.models.paged import decode_chunk_paged, prefill_paged
    from kuiperllama_tpu.ops.pallas.paged_attention import build_work_list

    kw = dict(family="llama2", seq_len=64)
    cfg = jtiny(**kw)
    params = to_device(random_params(cfg, seed=13), dtype=jnp.float32)
    ps, n_pages, steps = 8, 16, 6
    lens = np.asarray([5, 11], np.int32)
    tokens = np.zeros((2, 16), np.int32)
    tokens[0, :5] = [3, 1, 4, 1, 5]
    tokens[1, :11] = np.arange(7, 18)
    pt = np.zeros((2, 8), np.int32)
    pt[0, :3], pt[1, :3] = [1, 9, 2], [10, 3, 11]

    cache = init_paged_cache(cfg, n_pages=n_pages, page_size=ps, dtype=jnp.float32)
    token_pages = np.full((2, 16), 2 ** 30, np.int32)
    for b in range(2):
        token_pages[b, :lens[b]] = pt[b, np.arange(lens[b]) // ps]
    last, kp, vp = prefill_paged(cfg, params, jnp.asarray(tokens), jnp.asarray(lens),
                                 cache.k_pages, cache.v_pages, jnp.asarray(token_pages),
                                 jnp.zeros_like(jnp.asarray(token_pages)))
    first = jnp.argmax(last, -1).astype(jnp.int32)
    sl = np.minimum(lens + steps + 1, 64).astype(np.int32)
    fb, fp, ft, ni = build_work_list(pt, sl, ps)
    want = decode_chunk_paged(cfg, params, first, jnp.asarray(lens), kp, vp,
                              jnp.zeros((2,), bool), jax.random.PRNGKey(0),
                              jnp.full((8,), -1, jnp.int32), jnp.asarray(pt),
                              jnp.asarray(fb), jnp.asarray(fp), jnp.asarray(ft),
                              jnp.asarray(ni), steps=steps, page_size=ps)[0]
    outs = pool.run(rc.paged_step, kw, rc.numpy_tree(params), tokens, lens, pt,
                    n_pages, ps, steps, 2, seqpar)
    for o in outs:
        assert o["first"] == np.asarray(first).tolist()
        assert o["toks"] == np.asarray(want).tolist()
