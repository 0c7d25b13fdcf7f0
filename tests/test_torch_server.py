"""The port's HTTP front end (serving/server.py) over its PagedEngine, on the
CPU: concurrent clients and a real localhost round trip give the tokens of
direct engine runs, which equal the JAX Generator's; an invalid request
gets a 400 before it reaches the engine thread, which keeps serving."""

import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import pytest
import torch

from kuiperllama_tpu.config import tiny_config as jtiny
from kuiperllama_tpu.params import random_params as jrandom, to_device as jto
from kuiperllama_tpu.serving.generate import Generator as JGenerator
from kuiperllama_tpu_torch.config import tiny_config
from kuiperllama_tpu_torch.convert import from_jax_params
from kuiperllama_tpu_torch.errors import InvalidArgument
from kuiperllama_tpu_torch.serving.engine import PagedEngine, Request
from kuiperllama_tpu_torch.serving.server import InferenceServer, make_http_server
from torch_threads import one_thread  # noqa: F401

PROMPTS = [[1, 5, 9], [2, 3, 4, 4], [7, 7], [11, 2, 3, 5]]
NEW = 6


def _engine(cfg, params):
    return PagedEngine(cfg, params, max_batch=2, max_len=64, chunk=4,
                       cache_dtype=torch.float32, page_size=8)


@pytest.fixture(scope="module")
def jax_model():
    jcfg = jtiny("llama2", seq_len=64)
    return jcfg, jto(jrandom(jcfg, seed=17), dtype=jnp.float32)


@pytest.fixture(scope="module")
def served(jax_model):
    cfg = tiny_config("llama2", seq_len=64)
    params = from_jax_params(jax_model[1], device="cpu")
    srv = InferenceServer(_engine(cfg, params))
    srv.start()
    httpd = make_http_server(srv, "127.0.0.1", 0)  # an ephemeral port
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield cfg, params, srv, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    srv.stop()


@pytest.fixture(scope="module")
def want(served, jax_model):
    """Each prompt's tokens from a direct engine run, checked against the
    JAX Generator on the same weights."""
    cfg, params = served[:2]
    reqs = [Request(prompt_ids=p, max_new_tokens=NEW) for p in PROMPTS]
    _engine(cfg, params).run(reqs)
    jgen = JGenerator(*jax_model, cache_len=64)
    for r in reqs:
        assert r.out_ids == jgen.generate_ids(r.prompt_ids, max_new_tokens=NEW)[0]
    return {tuple(r.prompt_ids): r.out_ids for r in reqs}


def _post(base, body: bytes):
    req = urllib.request.Request(f"{base}/generate", data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as resp:
        return json.loads(resp.read())


def test_concurrent_submissions_match_direct_runs(served, want):
    srv = served[2]
    results = [None] * len(PROMPTS)

    def client(i):
        results[i] = srv.submit(prompt_ids=PROMPTS[i], max_new_tokens=NEW)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for p, r in zip(PROMPTS, results):
        assert r is not None and r["ids"] == want[tuple(p)]
        assert r["tokens"] == NEW and r["ttft_ms"] >= 0


def test_http_round_trip(served, want):
    base = served[3]
    code, out = _post(base, json.dumps({"prompt_ids": PROMPTS[1],
                                        "max_new_tokens": NEW}).encode())
    assert code == 200 and out["ids"] == want[tuple(PROMPTS[1])]
    assert _get(base, "/healthz") == {"ok": True, "active": 0, "queued": 0}
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base, "/nowhere")
    assert e.value.code == 404


@pytest.mark.parametrize("body", [
    {"prompt_ids": []},                          # empty prompt
    {"prompt_ids": list(range(1, 65))},          # not shorter than max_len
    {"prompt_ids": [1, 512]},                    # id past the vocabulary
    {"prompt_ids": [1, -3]},                     # negative id
    {"prompt_ids": [1, 2.5]},                    # not an int
    {"prompt_ids": [1, 2], "max_new_tokens": 0},
    {"prompt_ids": [1, 2], "max_new_tokens": "4"},
    {"prompt": "hi"},                            # no tokenizer configured
    {},                                          # no prompt at all
    [1, 2, 3],                                   # not a JSON object
])
def test_invalid_request_gets_400_and_serving_continues(served, want, body):
    srv, base = served[2], served[3]
    served_before = srv.n_served
    code, out = _post(base, json.dumps(body).encode())
    assert code == 400 and out["error"]
    # the request never reached the engine thread, which still serves
    assert srv.n_served == served_before
    code, out = _post(base, json.dumps({"prompt_ids": PROMPTS[2],
                                        "max_new_tokens": NEW}).encode())
    assert code == 200 and out["ids"] == want[tuple(PROMPTS[2])]


def test_malformed_json_gets_400(served):
    code, out = _post(served[3], b"{not json")
    assert code == 400 and "JSONDecodeError" in out["error"]


def test_validate_raises_invalid_argument(served):
    srv = served[2]
    with pytest.raises(InvalidArgument, match="max_len"):
        srv.validate(list(range(1, 100)), 4)
    req = srv.validate((3, 4), 5)
    assert req.prompt_ids == [3, 4] and req.max_new_tokens == 5


def test_metrics_endpoint(served):
    srv, base = served[2], served[3]
    srv.submit(prompt_ids=[5, 2], max_new_tokens=4)
    m = _get(base, "/metrics")
    assert m["served"] >= 1 and m["tokens"] >= 4 and m["preemptions"] == 0
    assert m["ttft_s_p99"] >= m["ttft_s_p50"] >= 0
    assert m["latency_s_p99"] >= m["latency_s_p50"] >= 0
