"""The port's collective accounting (parallel/collectives.py), the
counterpart of tests/test_hlo_bill.py: a sharded decode step issues exactly
the analytic bill, 2 L all-reduces of [B, 1, dim] and one [B, 1, vocab]
logits all-gather (no combiner: counts are exact, where the JAX bill allows
1 to 2 all-reduces per compiled layer body), with the same payload bytes as
the bill the JAX package reads from its compiled HLO; the data axis adds no
collective; every op of the wrapper is counted. Ranks: 4 gloo processes on
the CPU (tests/torch_rank_cases.py)."""

import numpy as np
import pytest

import torch_rank_cases as rc
from kuiperllama_tpu.config import tiny_config as jtiny
from kuiperllama_tpu.params import random_params
from kuiperllama_tpu.parallel.hlo import decode_step_bill as jbill
from kuiperllama_tpu.parallel.mesh import make_mesh as jmesh
from torch_threads import one_thread  # noqa: F401

CFG = dict(family="llama2", n_heads=8, n_kv_heads=4, dim=128, hidden_dim=256,
           vocab_size=512, seq_len=64)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with rc.open_pool(tmp_path_factory.mktemp("rdv"), 4) as p:
        yield p


@pytest.fixture(scope="module")
def tree():
    return random_params(jtiny(**CFG), seed=0)


def _bills(pool, tree, dp, tp, batch):
    return [o for o in pool.run(rc.decode_bill, CFG, tree, dp, tp, batch) if o]


def test_decode_step_bill_is_exact_and_matches_jax(pool, tree):
    cfg = jtiny(**CFG)
    want = jbill(cfg, jmesh(dp=1, tp=4), tree, batch=2, cache_len=32)
    for b in _bills(pool, tree, 1, 4, 2):
        em, an = b["emitted"], b["analytic"]
        assert set(em) == {"all-reduce", "all-gather"}
        assert em["all-reduce"]["count"] == 2 * cfg.n_layers == an["all-reduce"]["count"]
        assert em["all-reduce"]["bytes"] == an["all-reduce"]["bytes"]
        assert em["all-gather"]["count"] == 1
        assert em["all-gather"]["bytes"] == an["all-gather"]["bytes"]
        # the JAX package's compiled bill: the same payloads
        assert (em["all-reduce"]["bytes"]
                == want["analytic"]["all_reduce_bytes_per_step"]
                == want["emitted"]["all-reduce"]["bytes"] * cfg.n_layers)
        assert em["all-gather"]["bytes"] == want["emitted"]["all-gather"]["bytes"]
        assert an["bodies_per_step"] == want["analytic"]["bodies_per_step"]


@pytest.mark.parametrize("dp,tp", [(2, 2), (4, 1)])
def test_data_axis_adds_no_collectives(pool, tree, dp, tp):
    """dp ranks hold the weights whole along the data axis and their own
    rows: the same collectives as dp = 1, each carrying B / dp rows."""
    base = _bills(pool, tree, 1, tp, 4)[0]["emitted"]
    for b in _bills(pool, tree, dp, tp, 4):
        for op in ("all-reduce", "all-gather"):
            assert b["emitted"][op]["count"] == base[op]["count"]
            assert b["emitted"][op]["bytes"] * dp == base[op]["bytes"]


def test_every_op_is_counted(pool):
    outs = pool.run(rc.counted_ops, 4)
    x = [np.full((2, 3), r + 1.0, np.float32) for r in range(4)]
    for o in outs:
        bill = o["bill"]
        assert (bill["all-reduce"]["count"], bill["all-reduce"]["bytes"]) == (1, 24)
        # bf16 [2, 12] and fp32 [4, 2, 3]
        assert (bill["all-gather"]["count"], bill["all-gather"]["bytes"]) == (2, 48 + 96)
        assert all(bill[op]["seconds"] > 0 for op in bill)
        np.testing.assert_array_equal(o["reduced"], sum(x))
        assert o["in_place"]  # the fresh product is reduced where it lies
        np.testing.assert_array_equal(o["gathered"], np.concatenate(x, axis=-1))
        np.testing.assert_array_equal(o["stacked"], np.stack(x))
        assert o["none"]  # no group: the identity, nothing counted
