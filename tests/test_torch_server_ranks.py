"""The port's InferenceServer in front of a multi-rank PagedEngine(mesh=),
the counterpart of the JAX package's InferenceServer(PagedEngine(mesh=)):
on 2 gloo ranks on the CPU (tests/torch_rank_cases.py), rank 0 serves and
rank 1 follows its control messages; the pool's 3 s timeout bounds every
collective of the meshes. Requests queued on rank 0 before it
starts answer exactly the tokens of JAX's server over a tp = 2 (or seqpar
sp = 2) engine on the CPU's virtual devices, queued the same way, and every
rank runs the same requests under the same ids to the same tokens. Each
trouble spot of serving across ranks has its test: a timed-out request's
pages come back on both ranks; an invalid request gets a 400 and never
reaches rank 1; an idle server outlives the group's 3 s timeout; a fault on
rank 1 fails every waiting request on rank 0 with EngineFailed within that
timeout; stop() ends every rank. The JAX side runs its paged kernel under
the Pallas interpreter with its INT8 matmuls in XLA; the ranks take the
plain INT8 matmul."""

import threading
import time

import jax.numpy as jnp
import pytest

import torch_rank_cases as rc
from kuiperllama_tpu.config import tiny_config as jtiny
from kuiperllama_tpu.ops.linear import set_use_pallas
from kuiperllama_tpu.params import random_params, to_device
from kuiperllama_tpu.parallel.mesh import make_mesh
from kuiperllama_tpu.quant import quantize_q80
from kuiperllama_tpu.serving.engine import PagedEngine
from kuiperllama_tpu.serving.server import InferenceServer
from torch_threads import one_thread  # noqa: F401

PROMPTS = [[1, 5, 9], [2, 3], [7, 7, 7, 7], [4, 11]]
NEW = 9
CFG = dict(family="llama2", seq_len=64)
ENGINE = dict(max_batch=2, max_len=64, chunk=4, page_size=128)
# seqpar's pages split over the ranks: small pages, so both ranks own some
SEQPAR_ENGINE = dict(ENGINE, page_size=8)
# a pool of 7 free 8-token pages: a request of 2 + 60 tokens can never fit
SMALL_POOL = dict(ENGINE, page_size=8, n_pages=8)
# the pool's group timeout, which every group of its meshes takes (every
# collective of the engine and the control broadcasts)
GROUP_TIMEOUT_S = rc.SERVER_GROUP_TIMEOUT_S


@pytest.fixture(autouse=True)
def _xla_path():
    set_use_pallas(False)
    yield
    set_use_pallas(True)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with rc.open_pool(tmp_path_factory.mktemp("rdv"), 2, GROUP_TIMEOUT_S) as p:
        yield p


@pytest.fixture(scope="module")
def tree():
    cfg = jtiny(**CFG)
    return cfg, to_device(random_params(cfg, seed=21), dtype=jnp.float32)


def _quantized(params):
    blocks = dict(params["blocks"])
    for name in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
        blocks[name] = quantize_q80(params["blocks"][name], group_size=32)
    return dict(params, blocks=blocks)


def _jax_served(cfg, params, engine_kw, seqpar):
    """JAX's InferenceServer over PagedEngine(mesh=make_mesh(tp=2)), the
    requests queued in order before it starts."""
    eng = PagedEngine(cfg, params, cache_dtype=jnp.float32, mesh=make_mesh(dp=1, tp=2),
                      seqpar=seqpar, **engine_kw)
    srv = InferenceServer(eng)
    answers = [None] * len(PROMPTS)

    def client(i):
        answers[i] = srv.submit(prompt_ids=PROMPTS[i], max_new_tokens=NEW)["ids"]

    threads = []
    for i in range(len(PROMPTS)):
        threads.append(threading.Thread(target=client, args=(i,), daemon=True))
        threads[-1].start()
        while srv._q.qsize() < i + 1:
            time.sleep(0.001)
    srv.start()
    for t in threads:
        t.join(120)
    srv.stop()
    return answers


def _same_on_both_ranks(outs):
    """Both ranks ran the same requests, under the same ids, to the same
    tokens, and gave back every page."""
    lead, follow = outs
    assert lead["leader"] and not follow["leader"]
    assert lead["ended"] and follow["ended"]
    assert lead["error"] is None and follow["error"] is None
    assert follow["submitted"] == lead["submitted"]
    for o in outs:
        assert o["free_end"] == o["free_start"] and not o["has_work"]


@pytest.mark.parametrize("quant,seqpar", [(False, False), (True, False), (False, True)],
                         ids=["fp32", "int8", "seqpar"])
def test_served_tokens_match_jax_server(pool, tree, quant, seqpar):
    cfg, params = tree
    if quant:
        params = _quantized(params)
    engine_kw = SEQPAR_ENGINE if seqpar else ENGINE
    want = _jax_served(cfg, params, engine_kw, seqpar)
    outs = pool.run(rc.serve_queued, CFG, rc.numpy_tree(params), PROMPTS, NEW, 2,
                    engine_kw, seqpar)
    assert outs[0]["answers"] == want
    assert [ids for _, ids, _ in outs[0]["submitted"]] == want
    _same_on_both_ranks(outs)
    assert outs[0]["control_messages"] == outs[1]["control_messages"] > 0


def test_concurrent_http_requests_and_a_400_never_reach_rank_1(pool, tree):
    """Six requests posted at once, then two refused by rank 0's
    validation (an empty prompt; one the pool can never hold), then one
    more: every answer 200 and the same on both ranks; rank 1 was given
    the seven valid requests only; rank 1 serves no HTTP."""
    cfg, params = tree
    prompts = PROMPTS + [[9, 8, 7], [3]]
    bad = [{"prompt_ids": []}, {"prompt_ids": [1, 2], "max_new_tokens": 60}]
    outs = pool.run(rc.serve_http, CFG, rc.numpy_tree(params), prompts, NEW, 2,
                    SMALL_POOL, bad)
    lead, follow = outs
    assert [code for code, _ in lead["results"]] == [200] * len(prompts)
    assert [code for code, _ in lead["refused"]] == [400, 400]
    assert "KV pages" in lead["refused"][1][1]["error"]
    assert lead["after"][0] == 200
    _same_on_both_ranks(outs)
    assert len(follow["submitted"]) == len(prompts) + 1
    served = {tuple(ids) for _, ids, _ in follow["submitted"]}
    assert {tuple(body["ids"]) for _, body in lead["results"]} <= served
    assert follow["http_refused"]
    assert lead["health"][0] == 200 and lead["metrics"]["served"] == len(prompts) + 1


def test_timed_out_request_frees_its_pages_on_both_ranks(pool, tree):
    """Rank 0 times out a request mid-decode; the cancel reaches rank 1
    under rank 0's id (rank 1's own counter ran ahead), both ranks stop it
    at the same step and free its pages; the next request is served."""
    cfg, params = tree
    outs = pool.run(rc.serve_timeout, CFG, rc.numpy_tree(params), PROMPTS[0], 40, 2,
                    SEQPAR_ENGINE, 0.3, 0.1)
    lead, follow = outs
    assert lead["timed_out"]
    assert lead["free_after_cancel"] == lead["free_start"]
    _same_on_both_ranks(outs)
    (rid, ids, finished), (_, after, _) = follow["submitted"]
    assert not finished and 0 < len(ids) < 40
    assert lead["after"] == after
    # rank 1 minted no id while following (its counter ran ahead of rank
    # 0's ids): the ids it served and cancelled by are rank 0's
    own = follow["next_own_id"]
    assert own == follow["skewed"][-1] + 1
    assert all(r < follow["skewed"][-1] for r, _, _ in follow["submitted"])


def test_idle_server_outlives_the_group_timeout(pool, tree):
    cfg, params = tree
    idle_s = GROUP_TIMEOUT_S + 1.5
    outs = pool.run(rc.serve_after_idle, CFG, rc.numpy_tree(params), PROMPTS[2], NEW, 2,
                    ENGINE, idle_s)
    lead, follow = outs
    assert lead["alive_after_idle"]
    _same_on_both_ranks(outs)
    assert [ids for _, ids, _ in follow["submitted"]] == [lead["answer"]]
    # one control message per idle poll, at least
    assert follow["control_messages"] > idle_s / 0.05


def test_stop_ends_every_rank(pool, tree):
    cfg, params = tree
    outs = pool.run(rc.serve_stop, CFG, rc.numpy_tree(params), 2, ENGINE)
    _same_on_both_ranks(outs)
    assert outs[0]["seconds"] < 5 and outs[1]["seconds"] < 20
    assert outs[1]["submitted"] == []


def test_control_group_is_gloo_and_absent_at_one_model_rank(pool):
    """The control messages travel on a gloo group of the model group's
    ranks; a one-rank model axis has none. Every group of the mesh takes
    the timeout the pool's ranks were initialized with (new_group's own
    default is 30 minutes)."""
    outs = pool.run(rc.control_groups)
    for o in outs:
        assert o["tp2"] == ("gloo", 2, "gloo")
        assert o["tp1"] is None
        assert o["timeouts"] == [GROUP_TIMEOUT_S] * 3


def test_rank_1_fault_fails_every_waiting_request_within_the_timeout(pool, tree):
    """Rank 1's second step raises: its loop ends; rank 0's step meets no
    peer in its collective, fails within the group timeout, and every
    waiting request gets EngineFailed; /healthz answers 503 and a later
    submission fails at once. (Last in the file: the pool's model group is
    left behind after a failed collective.)"""
    cfg, params = tree
    outs = pool.run(rc.serve_with_fault, CFG, rc.numpy_tree(params), PROMPTS[:3], NEW, 2,
                    ENGINE, 2)
    lead, follow = outs
    assert lead["outcomes"] == ["EngineFailed"] * 3
    assert lead["seconds"] < GROUP_TIMEOUT_S + 10
    assert lead["health"][0] == 503 and lead["health"][1]["ok"] is False
    assert lead["later"] == "EngineFailed" and lead["later_s"] < 1
    assert not lead["alive"] and lead["ended"]
    assert follow["ended"] and "rank 1 fails on purpose" in follow["error"]
