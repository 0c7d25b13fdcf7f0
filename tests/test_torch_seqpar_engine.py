"""The port's sequence-parallel paged serving (PagedEngine(mesh=,
seqpar=True) over parallel/seqpar.py) against the JAX package's
single-device PagedEngine, the counterpart of tests/test_seqpar_engine.py:
greedy tokens equal exactly at fp32 on 2 and 4 gloo ranks on the CPU
(tests/torch_rank_cases.py), the same on every rank; the pools split over
pages; every rank's garbage page reserved; and the free pages at start
equal the single-device engine's (the JAX engine rounds its pool down by
the reserved pages; the port adds them on top). The JAX side runs its paged
kernel under the Pallas interpreter with its INT8 matmuls in XLA."""

import warnings

import jax.numpy as jnp
import pytest

import torch_rank_cases as rc
from kuiperllama_tpu.config import tiny_config as jtiny
from kuiperllama_tpu.ops.linear import set_use_pallas
from kuiperllama_tpu.params import random_params, to_device
from kuiperllama_tpu.quant import quantize_q80
from kuiperllama_tpu.serving.engine import PagedEngine, Request
from kuiperllama_tpu_torch.config import preset_config
from kuiperllama_tpu_torch.parallel.shardings import validate_seqpar, validate_tp
from torch_threads import one_thread  # noqa: F401

PROMPTS = [[1, 5, 9], [2, 3], [7, 7, 7, 7], [4, 11]]
ENGINE = dict(max_batch=2, max_len=64, chunk=4, page_size=8)
LLAMA = dict(family="llama2", seq_len=64)


@pytest.fixture(autouse=True)
def _xla_path():
    set_use_pallas(False)
    yield
    set_use_pallas(True)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with rc.open_pool(tmp_path_factory.mktemp("rdv"), 4) as p:
        yield p


@pytest.fixture(scope="module")
def llama():
    cfg = jtiny(**LLAMA)
    return cfg, to_device(random_params(cfg, seed=21), dtype=jnp.float32)


def _jax_run(cfg, params, prompts, max_new, **kw):
    eng = PagedEngine(cfg, params, cache_dtype=jnp.float32, **dict(ENGINE, **kw))
    free = eng.allocator.n_free_pages
    reqs = [Request(prompt_ids=list(p), max_new_tokens=max_new) for p in prompts]
    eng.run(reqs)
    return [r.out_ids for r in reqs], free


def _check(outs, sp, want, free, n_pages_single):
    for o in outs[:sp]:
        assert o["out_ids"] == want
        assert o["free_pages"] == free
        p_local = o["n_pages"] // sp
        assert o["n_pages"] % sp == 0 and o["pool_shape"][1] == p_local
        assert {s * p_local for s in range(sp)} <= set(o["reserved"])
        assert o["n_pages"] >= n_pages_single + sp - 1
    assert all(o is None for o in outs[sp:])


@pytest.mark.parametrize("sp", [2, 4])
def test_seqpar_matches_jax_single_device(pool, llama, sp):
    cfg, params = llama
    want, free = _jax_run(cfg, params, PROMPTS, 9)
    outs = pool.run(rc.paged_engine, LLAMA, rc.numpy_tree(params), PROMPTS, 9, sp,
                    ENGINE, True)
    _check(outs, sp, want, free, 2 * 8 + 1)


def test_seqpar_work_lists_split_page_reads(pool, llama):
    """Each rank's work list covers only its own pages: no rank walks the
    whole list, and every request still gets its 24 tokens."""
    cfg, params = llama
    prompts = [list(range(1, 33))] * 2
    want, _ = _jax_run(cfg, params, prompts, 24)
    outs = pool.run(rc.paged_engine, LLAMA, rc.numpy_tree(params), prompts, 24, 2,
                    ENGINE, True, True)
    items = outs[0]["items"]
    assert sum(items) >= 8 and all(n < sum(items) for n in items)
    assert outs[0]["out_ids"] == outs[1]["out_ids"] == want


def test_seqpar_quantized_fused(pool, llama):
    cfg, params = llama
    blocks = dict(params["blocks"])
    for name in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
        blocks[name] = quantize_q80(params["blocks"][name], group_size=32)
    qparams = dict(params, blocks=blocks)
    want, free = _jax_run(cfg, qparams, PROMPTS, 9)
    outs = pool.run(rc.paged_engine, LLAMA, rc.numpy_tree(qparams), PROMPTS, 9, 2,
                    ENGINE, True)
    _check(outs, 2, want, free, 17)


def test_seqpar_qwen_indivisible_heads(pool):
    """Qwen2.5-0.5B's head shape (H 14, KH 2, tiny hd): 14 heads do not
    split over 4 ranks, but seqpar replicates attention and splits pages."""
    kw = dict(family="qwen2", n_heads=14, n_kv_heads=2, dim=224, hidden_dim=192,
              vocab_size=512, seq_len=64)
    cfg = jtiny(**kw)
    assert cfg.qkv_bias and cfg.head_dim == 16
    params = to_device(random_params(cfg, seed=31), dtype=jnp.float32)
    want, free = _jax_run(cfg, params, PROMPTS, 9)
    outs = pool.run(rc.paged_engine, kw, rc.numpy_tree(params), PROMPTS, 9, 4,
                    ENGINE, True)
    _check(outs, 4, want, free, 17)
    with pytest.raises(ValueError, match="must divide n_kv_heads"):
        validate_tp(rc.tiny_config(**kw), 4)  # lane-split TP cannot


def test_seqpar_chunked_prefill_matches_jax(pool, llama):
    """seqpar and chunked prefill compose: each rank scores only the history
    pages it owns and the partials merge exactly."""
    cfg, params = llama
    prompts = [list(range(1, 25)), list(range(3, 21)), [2, 3, 5]]
    want, free = _jax_run(cfg, params, prompts, 8, prefill_chunk=8)
    outs = pool.run(rc.paged_engine, LLAMA, rc.numpy_tree(params), prompts, 8, 2,
                    dict(ENGINE, prefill_chunk=8), True)
    _check(outs, 2, want, free, 17)


def test_lane_rule_warns_never_raises():
    """The counterpart of test_lane_sharding_still_rejects_qwen_geometry:
    Qwen2.5-0.5B's KH * hd = 128 lanes split at tp = 2 give 64-lane blocks,
    which the JAX package's compiled kernels refuse; the port warns on the
    same geometry and runs it. Seqpar keeps whole lanes: no lane warning."""
    cfg = preset_config("qwen2.5-0.5b")
    with pytest.warns(UserWarning, match="KV lane dim of 64"):
        validate_tp(cfg, 2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        validate_seqpar(cfg, 2)
    assert not any("KV lane" in str(w.message) for w in caught)
