"""Seeded scheduler fuzz on the port's PagedEngine, a port of
tests/test_engine_fuzz.py: mixed prompt lengths, staggered submission, a
tight page pool (preemptions) and chunked prefill, held EXACTLY to an
unconstrained roomy run; the roomy run's greedy outputs also equal the JAX
PagedEngine's on the same weights (carried over by convert.from_jax_params,
fp32 params and caches; the JAX side runs its paged Pallas kernel in
interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuiperllama_tpu.config import tiny_config as jtiny
from kuiperllama_tpu.ops.linear import set_use_pallas
from kuiperllama_tpu.params import random_params as jrandom, to_device as jto
from kuiperllama_tpu.serving import engine as jeng
from kuiperllama_tpu_torch.config import tiny_config
from kuiperllama_tpu_torch.convert import from_jax_params
from kuiperllama_tpu_torch.serving.engine import PagedEngine, Request
from torch_threads import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def model():
    jcfg = jtiny("llama2", seq_len=64)
    jp = jto(jrandom(jcfg, seed=13), dtype=jnp.float32)
    return jcfg, jp, tiny_config("llama2", seq_len=64), from_jax_params(jp, device="cpu")


def _mk_requests(rng, n):
    reqs = []
    for _ in range(n):
        plen = int(rng.integers(1, 24))
        ids = [int(t) for t in rng.integers(1, 50, plen)]
        reqs.append((ids, int(rng.integers(2, 14))))
    return reqs


def _outputs(done):
    return sorted((tuple(r.prompt_ids), r.max_new_tokens, tuple(r.out_ids))
                  for r in done)


@pytest.mark.parametrize("seed", [0, 1])
def test_fuzz_stressed_matches_roomy(model, seed):
    jcfg, jp, cfg, params = model
    spec = _mk_requests(np.random.default_rng(seed), 7)

    # oracle: roomy pool, all submitted at once, no chunked prefill
    roomy_kw = dict(max_batch=2, max_len=64, chunk=4, page_size=8, n_pages=40)
    roomy = PagedEngine(cfg, params, cache_dtype=torch.float32, **roomy_kw)
    want = _outputs(roomy.run(
        [Request(prompt_ids=list(p), max_new_tokens=m) for p, m in spec]))

    # the same roomy run on the JAX package
    set_use_pallas(False)
    try:
        jroomy = jeng.PagedEngine(jcfg, jp, cache_dtype=jnp.float32, **roomy_kw)
        jwant = _outputs(jroomy.run(
            [jeng.Request(prompt_ids=list(p), max_new_tokens=m) for p, m in spec]))
    finally:
        set_use_pallas(True)
    assert want == jwant

    # stressed: tight over-committed pool + chunked prefill + staggered
    # submission (a new request lands between every engine step)
    eng = PagedEngine(cfg, params, max_batch=2, max_len=64, chunk=4,
                      cache_dtype=torch.float32, page_size=8, n_pages=7,
                      reserve_growth=False, prefill_chunk=8)
    pending = [Request(prompt_ids=list(p), max_new_tokens=m) for p, m in spec]
    done = []
    while pending or eng.has_work:
        if pending:
            eng.submit(pending.pop(0))
        if eng.has_work:
            done.extend(eng.step())
    assert _outputs(done) == want
    assert eng.allocator.n_free_pages == 6  # every page returned
