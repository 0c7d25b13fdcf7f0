"""The port's server under faults, on the CPU: a request that times out is
cancelled and answered 504; one the paged pool can never hold is refused
with a 400 before it reaches the engine; an engine that raises fails the
waiting requests with a 500 and /healthz answers 503. `cancel` frees the
slot and pages of a queued, active or mid-admission request on Engine and
PagedEngine, and the requests that stay generate what they would alone,
which is what the JAX engine generates."""

import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import pytest
import torch

from kuiperllama_tpu.config import tiny_config as jtiny
from kuiperllama_tpu.params import random_params as jrandom, to_device as jto
from kuiperllama_tpu.serving import engine as jeng
from kuiperllama_tpu_torch.config import tiny_config
from kuiperllama_tpu_torch.convert import from_jax_params
from kuiperllama_tpu_torch.errors import InvalidArgument
from kuiperllama_tpu_torch.serving.engine import Engine, PagedEngine, Request
from kuiperllama_tpu_torch.serving.server import (EngineFailed, InferenceServer,
                                                  make_http_server)
from torch_threads import one_thread  # noqa: F401


class _StubEngine:
    """The engine surface the server uses. Admitted requests never finish;
    with `fail`, step raises."""

    def __init__(self, fail=False):
        self.device = torch.device("cpu")
        self.cfg = tiny_config("llama2", seq_len=64)
        self.max_len, self.tokenizer, self.n_preemptions = 64, None, 0
        self.queue, self.active, self.cancelled = [], [], []
        self.fail = fail

    n_active = property(lambda self: len(self.active))
    has_work = property(lambda self: bool(self.queue or self.active))

    def can_hold(self, req):
        return True

    def submit(self, req):
        self.queue.append(req)

    def step(self):
        if self.fail:
            raise RuntimeError("device lost")
        self.active += self.queue
        self.queue = []
        return []

    def cancel(self, request_id):
        for reqs in (self.queue, self.active):
            for r in reqs:
                if r.request_id == request_id:
                    reqs.remove(r)
                    self.cancelled.append(request_id)
                    return True
        return False


@pytest.fixture
def serve():
    """serve(engine, **kw) -> (InferenceServer, base URL), stopped after the
    test."""
    started = []

    def run(engine, **kw):
        srv = InferenceServer(engine, poll_idle_s=0.001, **kw)
        srv.start()
        httpd = make_http_server(srv, "127.0.0.1", 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        started.append((srv, httpd))
        return srv, f"http://127.0.0.1:{httpd.server_address[1]}"

    yield run
    for srv, httpd in started:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()


def _post(base, body):
    req = urllib.request.Request(f"{base}/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _until(cond, seconds=10.0):
    end = time.monotonic() + seconds
    while not cond() and time.monotonic() < end:
        time.sleep(0.005)
    return cond()


def test_timeout_answers_504_and_cancels(serve):
    eng = _StubEngine()
    srv, base = serve(eng, timeout_s=0.2)
    code, out = _post(base, {"prompt_ids": [1, 2, 3], "max_new_tokens": 4})
    assert code == 504 and "TimeoutError" in out["error"]
    # the engine thread retires the request: nothing stays queued or active
    assert _until(lambda: len(eng.cancelled) == 1 and not eng.has_work)
    with pytest.raises(TimeoutError, match="cancelled"):
        srv.submit(prompt_ids=[4, 5], timeout_s=0.05)
    assert _until(lambda: len(eng.cancelled) == 2 and not eng.has_work)
    assert srv._events == {}
    assert _get(base, "/healthz") == (200, {"ok": True, "active": 0, "queued": 0})


def test_engine_failure_answers_500_and_healthz_503(serve):
    srv, base = serve(_StubEngine(fail=True))
    code, out = _post(base, {"prompt_ids": [1, 2, 3], "max_new_tokens": 4})
    assert code == 500 and "device lost" in out["error"]
    assert not srv.alive and isinstance(srv.error, RuntimeError)
    code, health = _get(base, "/healthz")
    assert code == 503 and health["ok"] is False and "device lost" in health["error"]
    # later requests fail at once rather than waiting out the timeout
    t0 = time.monotonic()
    code, out = _post(base, {"prompt_ids": [1, 2], "max_new_tokens": 4})
    assert code == 500 and "EngineFailed" in out["error"]
    assert time.monotonic() - t0 < 5
    with pytest.raises(EngineFailed):
        srv.submit(prompt_ids=[3])


def test_healthz_503_before_start():
    srv = InferenceServer(_StubEngine())
    httpd = make_http_server(srv, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        code, health = _get(f"http://127.0.0.1:{httpd.server_address[1]}", "/healthz")
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert code == 503 and "not running" in health["error"]


# ---------------------------------------------------------------------------
# Real engines on the CPU


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = jtiny("llama2", seq_len=64), tiny_config("llama2", seq_len=64)
    jp = jto(jrandom(jcfg, seed=23), dtype=jnp.float32)
    return jcfg, jp, cfg, from_jax_params(jp, device="cpu")


def _paged(model, **kw):
    base = dict(max_batch=2, max_len=64, chunk=4, page_size=8,
                cache_dtype=torch.float32)
    base.update(kw)
    return PagedEngine(model[2], model[3], **base)


def test_pool_too_small_gets_400_from_validate(model, serve):
    # 5 pages of 8 tokens: 40 tokens at most; page 0 is the garbage sink
    eng = _paged(model, n_pages=6)
    assert eng.can_hold(Request(prompt_ids=[1] * 20, max_new_tokens=19))
    assert not eng.can_hold(Request(prompt_ids=[1] * 20, max_new_tokens=20))
    srv, base = serve(eng)
    with pytest.raises(InvalidArgument, match="KV pages"):
        srv.validate([1] * 30, 30)
    code, out = _post(base, {"prompt_ids": [1] * 30, "max_new_tokens": 30})
    assert code == 400 and "KV pages" in out["error"]
    # the engine thread was never reached and still serves what fits
    assert srv.alive and srv.n_served == 0
    code, out = _post(base, {"prompt_ids": [3, 4], "max_new_tokens": 5})
    assert code == 200 and out["tokens"] == 5
    assert _get(base, "/healthz")[0] == 200


@pytest.mark.parametrize("cls", ["Engine", "PagedEngine"])
def test_cancel_frees_slots_and_pages(model, cls):
    _, _, cfg, tp = model
    eng = (_paged(model) if cls == "PagedEngine" else
           Engine(cfg, tp, max_batch=2, max_len=64, chunk=4, cache_dtype=torch.float32))
    free0 = eng.allocator.n_free_pages if cls == "PagedEngine" else None
    reqs = [Request(prompt_ids=[1 + i, 5, 9], max_new_tokens=40) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.step()  # two admitted, one queued
    assert eng.n_active == 2 and eng.queue == [reqs[2]]
    assert eng.cancel(reqs[2].request_id) and eng.queue == []
    assert eng.cancel(reqs[0].request_id) and eng.n_active == 1
    assert not eng.cancel(reqs[0].request_id)  # already gone
    assert eng.cancel(reqs[1].request_id)
    assert eng.n_active == 0 and not eng.has_work
    assert not any(r.finished for r in reqs)
    if cls == "PagedEngine":
        assert eng.allocator.n_free_pages == free0
        assert not eng.allocator.owned and not eng._reserved_caps
    # the freed slots serve the next requests as a fresh engine would
    again = [Request(prompt_ids=[7, 7, 2], max_new_tokens=6),
             Request(prompt_ids=[3], max_new_tokens=6)]
    eng.run(again)
    jcfg, jp = model[:2]
    je = getattr(jeng, cls)(jcfg, jp, max_batch=2, max_len=64, chunk=4,
                            cache_dtype=jnp.float32,
                            **(dict(page_size=8) if cls == "PagedEngine" else {}))
    jreqs = [jeng.Request(prompt_ids=list(r.prompt_ids), max_new_tokens=6) for r in again]
    je.run(jreqs)
    assert [r.out_ids for r in again] == [r.out_ids for r in jreqs]
    if cls == "PagedEngine":
        assert eng.allocator.n_free_pages == free0


def test_cancel_during_chunked_admission(model):
    """A request cancelled while its admission wave prefills gives up its
    slot and pages when the wave activates; the other row of the wave
    finishes with the tokens it gets alone."""
    eng = _paged(model, prefill_chunk=16, admit_chunk=2)
    free0 = eng.allocator.n_free_pages
    a = Request(prompt_ids=list(range(1, 41)), max_new_tokens=6)
    b = Request(prompt_ids=list(range(5, 30)), max_new_tokens=6)
    eng.submit(a)
    eng.submit(b)
    eng.step()  # the wave's first chunk
    assert eng._wave is not None
    assert eng.cancel(a.request_id)
    eng.run([])
    assert not a.finished and b.finished and len(b.out_ids) == 6
    assert eng.allocator.n_free_pages == free0 and not eng._cancel_after_wave
    alone = Request(prompt_ids=list(b.prompt_ids), max_new_tokens=6)
    _paged(model, prefill_chunk=16, admit_chunk=2).run([alone])
    assert b.out_ids == alone.out_ids
