"""Multi-process bring-up of the port (parallel/mesh.py initialize_distributed,
parallel/launch.py RankPool), the counterpart of tests/test_distributed.py:
(1) one process forms a group of one, (2) two spawned ranks (gloo, CPU)
run one tensor-parallel decode step whose collectives cross the process
boundary, each rank's logits equal to the JAX package's single-device
decode step, and (3) a rank that raises fails the call with its traceback.
The ranks meet through a file under the test's temporary directory, not a
TCP port, since several test files run at once."""

import numpy as np
import pytest

import jax.numpy as jnp

import torch_rank_cases as rc
from kuiperllama_tpu.config import tiny_config as jtiny
from kuiperllama_tpu.models import decoder as jdec
from kuiperllama_tpu.ops.linear import set_use_pallas
from kuiperllama_tpu.params import random_params, to_device
from torch_threads import one_thread  # noqa: F401


def test_single_process_group(tmp_path):
    with rc.open_pool(tmp_path, 1) as pool:
        assert pool.run(rc.world_info) == [dict(rank=0, world=1, backend="gloo")]


def test_two_process_sharded_decode_step(tmp_path):
    """A prefill of 4 tokens and one decode step at tp = 2 across two
    processes: both ranks' logits equal JAX's single-device ones (and each
    other's)."""
    kw = dict(family="llama2", n_heads=8, n_kv_heads=4, dim=128, hidden_dim=256,
              vocab_size=512, seq_len=64)
    cfg = jtiny(**kw)
    params = to_device(random_params(cfg, seed=3), dtype=jnp.float32)
    tokens = np.random.default_rng(0).integers(0, 512, (2, 4)).astype(np.int32)
    tok, pos = np.asarray([5, 6], np.int32), np.asarray([4, 4], np.int32)
    set_use_pallas(False)
    try:
        cache = jdec.init_kv_cache(cfg, batch=2, max_len=32)
        _, cache = jdec.prefill(cfg, params, jnp.asarray(tokens), cache)
        want, _ = jdec.decode_step(cfg, params, jnp.asarray(tok), jnp.asarray(pos),
                                   kv_cache=cache)
    finally:
        set_use_pallas(True)
    with rc.open_pool(tmp_path, 2) as pool:
        outs = pool.run(rc.sharded_decode, kw, rc.numpy_tree(params), tokens, tok,
                        pos, 1, 1, 2)
    assert [o["tp_rank"] for o in outs] == [0, 1]
    np.testing.assert_array_equal(outs[0]["logits"][1], outs[1]["logits"][1])
    np.testing.assert_allclose(outs[0]["logits"][1], np.asarray(want), atol=1e-4)


def test_failing_rank_reports_its_traceback(tmp_path):
    with rc.open_pool(tmp_path, 2) as pool:
        with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
            pool.run(rc.fail_on, 1)
        assert pool.run(rc.fail_on, 5) == [0, 1]  # the pool still serves
