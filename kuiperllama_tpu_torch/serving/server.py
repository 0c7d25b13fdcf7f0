"""Minimal HTTP serving front end over the continuous-batching engine, a
port of kuiperllama_tpu/serving/server.py.

Standard library only: a ThreadingHTTPServer accepting JSON POSTs, ONE
engine thread that owns the device (every request thread only validates,
enqueues and waits), and the PagedEngine doing the continuous batching.

Endpoints:
  POST /generate   {"prompt": str | "prompt_ids": [int],
                    "max_new_tokens": int=128}
      -> {"text": str?, "ids": [int], "ttft_ms": float, "tokens": int}
         400 {"error": ...} for a request that fails validation or is not
             JSON; 504 when it times out (it is cancelled and its slot and
             pages freed); 500 when the engine thread fails
  GET  /healthz    -> {"ok": true, "active": n, "queued": n}, or 503 with
                      the error once the engine thread has died
  GET  /metrics    -> served-request counters and TTFT/latency percentiles
                      over the last 512 completions

Usage:
  python -m kuiperllama_tpu_torch.serving.server --model m.q8.bin \
      --tokenizer tok.model --family llama2 --port 8000 [--device cpu]
or in-process:
  srv = InferenceServer(engine, tokenizer); srv.start(); srv.submit(...)

Across ranks: the JAX package's one controller drives a sharded engine from
one server thread. Here every rank of a PagedEngine(mesh=) is a process, so
every rank wraps its engine in an InferenceServer. Rank 0 of the model
group (the leader) is the server above; on every other rank (a follower)
start() runs a loop that takes no submissions. On each turn of its loop the
leader broadcasts one control message on the mesh's gloo control group,
whether it has work or is idle: the requests it took from its queue, in
order, the request ids to cancel, and a stop flag. Every rank then applies
the same submissions, then the same cancels, and steps if it has work, so
every rank runs the same schedule and meets its peers in the same
collectives. Where trouble lies:
  1. request ids: a follower submits the leader's requests under the
     leader's ids (Request.request_id counts per process), so a cancel
     names the same request on every rank;
  2. the channel: the messages travel on Mesh.control_group (gloo, made by
     make_mesh on every rank at one point), never on an NCCL model group,
     whose object broadcast would sync the device beside the captured
     graphs; a one-rank model axis has no such group and sends nothing;
  3. an idle server: the group's timeout bounds every collective, so the
     leader sends a message on every idle poll (poll_idle_s), and a
     follower never waits longer than that plus a step;
  4. the clock: a timeout is decided on the leader alone and reaches the
     followers as a cancel; validation (engine.can_hold included) runs on
     the leader before queueing; the engine's schedule reads no clock (it
     records submit, first-token and finish times, and Request.finished
     asks only whether a finish was recorded);
  5. failure and stop: a step that raises ends that rank's loop. Over a
     gloo model group its peers fail in their next collective within the
     group timeout, and the leader then fails every waiting request with
     EngineFailed. Over an NCCL model group this is untested (no run has
     had NCCL ranks on two cards): NCCL's watchdog ends a process whose
     collective times out rather than raising, and a collective replayed
     in a CUDA graph is not bounded by the timeout. stop() on the leader
     sends the stop flag, and the followers return.
"""

from __future__ import annotations

import collections
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..errors import InvalidArgument, check
from .engine import Engine, Request


class EngineFailed(RuntimeError):
    """The engine thread died; every waiting and later request fails."""


class _Control:
    """The leader's control messages to the followers of its model group:
    one broadcast_object_list on the gloo control group per turn. Counts the
    messages and the host seconds inside the broadcasts."""

    def __init__(self, group):
        import torch.distributed as dist

        self.group = group
        self.src = dist.get_global_rank(group, 0)
        self.messages = 0
        self.seconds = 0.0

    def exchange(self, msg=None):
        """The leader's `msg`, on every rank (the leader passes it)."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        box = [msg]
        dist.broadcast_object_list(box, src=self.src, group=self.group)
        self.messages += 1
        self.seconds += time.perf_counter() - t0
        return box[0]


class InferenceServer:
    """Engine-thread wrapper: HTTP (or any) threads submit requests and
    block on a per-request event; one loop thread owns the engine and the
    device. Over an engine with a mesh of two or more model ranks, every
    rank builds one: rank 0's serves, the others follow it (module
    docstring)."""

    def __init__(self, engine: Engine, tokenizer=None,
                 poll_idle_s: float = 0.005, timeout_s: float = 600.0):
        self.engine = engine
        mesh = getattr(engine, "mesh", None)
        group = None if mesh is None else mesh.control_group
        self.control = None if group is None else _Control(group)
        self.leader = mesh is None or mesh.tp_rank == 0
        self.timeout_s = timeout_s  # a request's wait before it is cancelled
        self.tokenizer = tokenizer if tokenizer is not None \
            else engine.tokenizer
        self._q: "queue.Queue[tuple[Request, threading.Event]]" = queue.Queue()
        self._cancel_q: "queue.Queue[int]" = queue.Queue()
        self._events = {}
        # the exception that ended the engine thread, once it has
        self.error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._poll = poll_idle_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # lifetime counters and a window of the last 512 completions
        self.n_served = 0
        self.n_tokens = 0
        self.started_unix = time.time()
        self._window = collections.deque(maxlen=512)

    # -- engine thread

    def _loop(self):
        try:
            self._serve()
        except Exception as e:  # noqa: BLE001 (reported to every request)
            self._fail(e)

    def _fail(self, err: BaseException):
        """Record the engine thread as dead and wake every waiting request,
        queued or submitted; submit() then raises EngineFailed."""
        with self._lock:
            self.error = err
            events = list(self._events.values())
            self._events.clear()
            while True:
                try:
                    events.append(self._q.get_nowait()[1])
                except queue.Empty:
                    break
        for ev in events:
            ev.set()

    def _set_device(self):
        if self.engine.device.type == "cuda":
            # kernel wrappers launch on the current device's current stream
            import torch

            torch.cuda.set_device(self.engine.device)

    def _take(self):
        """The requests and cancels queued since the last turn. Cancels come
        after the submissions: a request that timed out before it reached
        the engine is in its queue by then."""
        reqs, cancels = [], []
        while True:
            try:
                req, ev = self._q.get_nowait()
            except queue.Empty:
                break
            with self._lock:
                self._events[req.request_id] = ev
            reqs.append(req)
        while True:
            try:
                cancels.append(self._cancel_q.get_nowait())
            except queue.Empty:
                break
        return reqs, cancels

    def _serve(self):
        """One turn: the leader takes its queued submissions and cancels;
        with a control group every rank meets in the leader's message; every
        rank then submits, cancels and steps alike. A follower submits the
        leader's requests under the leader's ids, and no one waits on its
        finished requests."""
        eng = self.engine
        self._set_device()
        while True:
            if self.leader:
                stop = self._stop.is_set()
                # at stop, queued requests stay queued (their submit times out)
                reqs, cancels = ([], []) if stop else self._take()
                msg = ([(r.request_id, r.prompt_ids, r.max_new_tokens) for r in reqs],
                       cancels, stop)
            if self.control is not None:
                # every turn, idle ones too: a follower waits in this
                # broadcast, bounded by the group's timeout
                msg = self.control.exchange(msg if self.leader else None)
            wanted, cancels, stop = msg
            if stop:
                return
            if not self.leader:
                reqs = [Request(prompt_ids=p, max_new_tokens=n, request_id=i)
                        for i, p, n in wanted]
            for req in reqs:
                eng.submit(req)
            for request_id in cancels:
                eng.cancel(request_id)
            moved = bool(reqs or cancels)
            if eng.has_work:
                for fin in eng.step():
                    with self._lock:
                        ev = self._events.pop(fin.request_id, None)
                        self.n_served += 1
                        self.n_tokens += len(fin.out_ids)
                        self._window.append(
                            (fin.ttft_s, fin.finish_time - fin.submit_time,
                             len(fin.out_ids)))
                    if ev is not None:
                        ev.set()
                moved = True
            if self.leader and not moved:
                time.sleep(self._poll)

    @property
    def alive(self) -> bool:
        """The engine thread is running and has not failed."""
        return (self.error is None and self._thread is not None
                and self._thread.is_alive())

    def start(self):
        """Start the engine thread (on a follower rank it follows the
        leader's control messages)."""
        if self._thread is not None:
            raise RuntimeError("the server is already started")
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the engine thread to end (a follower's ends at the
        leader's stop flag, or when a collective fails); whether it has."""
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                return False
            self._thread = None
        return True

    def stop(self):
        """Stop the engine thread. On the leader the last control message
        carries the stop flag; a follower's stop waits for it."""
        if self.leader:
            self._stop.set()
        self.join(timeout=30)

    # -- request surface (thread-safe)

    def validate(self, prompt_ids, max_new_tokens) -> Request:
        """The Request for a submission, or InvalidArgument: the prompt is
        non-empty and shorter than the engine's max_len, every id lies in
        the vocabulary, max_new_tokens >= 1, and an idle engine could admit
        it (a PagedEngine's pool holds its pages). Nothing invalid reaches
        the engine thread."""
        eng = self.engine
        check(isinstance(prompt_ids, (list, tuple)),
              "prompt_ids must be a list of ints")
        check(all(isinstance(i, int) and not isinstance(i, bool)
                  for i in prompt_ids), "prompt_ids must be a list of ints")
        check(len(prompt_ids) >= 1, "the prompt is empty")
        check(len(prompt_ids) < eng.max_len,
              f"the prompt has {len(prompt_ids)} tokens; max_len is {eng.max_len}")
        vocab = eng.cfg.vocab_size
        check(all(0 <= i < vocab for i in prompt_ids),
              f"prompt ids must lie in [0, {vocab})")
        check(isinstance(max_new_tokens, int) and not isinstance(max_new_tokens, bool)
              and max_new_tokens >= 1, "max_new_tokens must be an int >= 1")
        req = Request(prompt_ids=list(prompt_ids), max_new_tokens=max_new_tokens)
        check(eng.can_hold(req),
              f"{len(prompt_ids)} prompt + {max_new_tokens} new tokens need more "
              "KV pages than the engine's pool holds")
        return req

    def submit(self, prompt: Optional[str] = None, prompt_ids=None,
               max_new_tokens: int = 128,
               timeout_s: Optional[float] = None) -> dict:
        """Generate for one request and wait for it (timeout_s, default the
        server's): TimeoutError after cancelling it on timeout, EngineFailed
        if the engine thread has died."""
        if not self.leader:
            raise RuntimeError("a follower rank takes no submissions: submit "
                               "to rank 0 of the model group")
        timeout_s = self.timeout_s if timeout_s is None else timeout_s
        if prompt_ids is None:
            check(prompt is not None, "prompt or prompt_ids required")
            check(self.tokenizer is not None, "no tokenizer configured")
            prompt_ids = self.tokenizer.encode(prompt)
        req = self.validate(prompt_ids, max_new_tokens)
        req.submit_time = time.perf_counter()  # TTFT includes the queue wait
        ev = threading.Event()
        with self._lock:  # _fail drains the queue under the same lock
            if self.error is not None:
                raise EngineFailed(f"the engine thread failed: {self.error!r}")
            self._q.put((req, ev))
        if not ev.wait(timeout_s):
            with self._lock:
                self._events.pop(req.request_id, None)
            self._cancel_q.put(req.request_id)
            raise TimeoutError(f"request {req.request_id} timed out after "
                               f"{timeout_s} s and was cancelled")
        if self.error is not None and not req.finished:
            raise EngineFailed(f"the engine thread failed: {self.error!r}")
        out = dict(ids=list(req.out_ids), tokens=len(req.out_ids),
                   ttft_ms=round(req.ttft_s * 1e3, 1),
                   wall_ms=round((req.finish_time - req.submit_time) * 1e3, 1))
        if self.tokenizer is not None:
            out["text"] = self.tokenizer.decode(req.out_ids)
        return out

    def metrics(self) -> dict:
        eng = self.engine
        with self._lock:
            win = list(self._window)
        out = dict(uptime_s=round(time.time() - self.started_unix, 1),
                   served=self.n_served, tokens=self.n_tokens,
                   active=eng.n_active, queued=len(eng.queue),
                   preemptions=eng.n_preemptions)
        if win:
            def pct(vals, p):
                v = sorted(vals)
                return round(v[min(len(v) - 1, int(len(v) * p / 100))], 4)

            ttfts = [w[0] for w in win]
            walls = [w[1] for w in win]
            out.update(window=len(win),
                       ttft_s_p50=pct(ttfts, 50), ttft_s_p99=pct(ttfts, 99),
                       latency_s_p50=pct(walls, 50), latency_s_p99=pct(walls, 99),
                       window_tokens=sum(w[2] for w in win))
        return out


def make_http_server(inference: InferenceServer, host: str = "127.0.0.1",
                     port: int = 8000) -> ThreadingHTTPServer:
    if not inference.leader:
        raise ValueError("only rank 0 of the model group serves HTTP")

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                eng = inference.engine
                if inference.alive:
                    self._json(200, {"ok": True, "active": eng.n_active,
                                     "queued": len(eng.queue)})
                else:
                    err = inference.error
                    self._json(503, {"ok": False, "error": (
                        f"{type(err).__name__}: {err}" if err is not None
                        else "the engine thread is not running")})
            elif self.path == "/metrics":
                self._json(200, inference.metrics())
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(n) or b"{}")
                check(isinstance(payload, dict), "the body must be a JSON object")
                out = inference.submit(
                    prompt=payload.get("prompt"),
                    prompt_ids=payload.get("prompt_ids"),
                    max_new_tokens=payload.get("max_new_tokens", 128))
                self._json(200, out)
            except Exception as e:  # noqa: BLE001 (reported to the client)
                if isinstance(e, (InvalidArgument, json.JSONDecodeError)):
                    code = 400
                elif isinstance(e, TimeoutError):
                    code = 504
                else:
                    code = 500
                self._json(code, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    import argparse

    import torch

    from ..api import KuiperModel
    from .engine import PagedEngine

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--tokenizer")
    ap.add_argument("--family", default="llama2")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--prefill-chunk", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model = KuiperModel.from_checkpoint(args.model, args.tokenizer,
                                        family=args.family)
    model.init(dtype=torch.bfloat16, device=args.device)
    eng = PagedEngine(model.cfg, model.params, tokenizer=model.tokenizer,
                      max_batch=args.slots, max_len=args.max_len,
                      cache_dtype=torch.bfloat16,
                      prefill_chunk=args.prefill_chunk)
    srv = InferenceServer(eng)
    srv.start()
    httpd = make_http_server(srv, args.host, args.port)
    print(f"[server] listening on {args.host}:{httpd.server_address[1]} "
          f"({args.slots} slots, max_len {args.max_len}, {args.device})",
          flush=True)
    try:
        httpd.serve_forever()
    finally:
        srv.stop()


if __name__ == "__main__":
    main()
