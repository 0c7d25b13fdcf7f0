"""Driver of the port's continuous-batching `PagedEngine`
(`serving/engine.py`), in an open loop (requests due at the traffic's
arrival times, whether or not earlier ones are done) or a closed loop
(`clients` callers, each sending its next request when its last is
answered).

Traffic keys: "engine": {"slots", "page_size", "max_len", "chunk",
"prefill_chunk"}; "drain_s"; "lead_in_s" (default 0); "warm_packed_tokens"
(default 0), the longest stream of prompts admitted together that the
warm-up prefills (below). The harness calls
`step()` and submits between steps: a request due during a step is
submitted after it, but its submit time is stamped with its due time, so
its time to first token counts the wait. The engine stamps the first token
when its prefill's tokens reach the host, and the finish when the chunk
that completes it does.

The traffic starts `lead_in_s` before the window: the window opens at the
first step boundary after that, on an engine already loaded, and closes at
the first step boundary `--seconds` later. Requests due before it opens are
served but not counted; the window counts every output token that reaches
the host inside it, of whichever request. After the window, requests due in
it are drained (bounded by `drain_s`); the tokens of the drain do not count
toward the window's rate.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from benchmark.harness import program
from benchmark.harness.record import Req, Run, Step
from kuiperllama_tpu_torch.serving.engine import PagedEngine, Request


def packed_plan(top: int, up_to: int, slots: int, longest: int) -> list:
    """Prompt lengths of the warm-up calls that admit several prompts
    together: one call for each bucket of the packed stream above `top`
    (the largest that one prompt fills) up to `up_to`, largest first, of as
    few prompts of at most `longest` tokens as fill the bucket exactly (at
    most `slots` of them)."""
    out, b = [], 2 * top
    while b <= up_to and -(-b // longest) <= slots:
        k = -(-b // longest)
        out.append([b // k + (j < b % k) for j in range(k)])
        b *= 2
    return out[::-1]


def warm_plan(pairs, max_len: int) -> list:
    """Schedule indices of the warm-up requests, one a prefill bucket that
    the pairs [(index, P, N)] use: the smallest bucket twice (its first
    decode chunk sizes the workspaces after its prefill was captured, so the
    second call captures that prefill again), then the others, largest
    first."""
    buckets = {}
    for i, P, _ in pairs:
        b = program.prompt_bucket(P, max_len)
        if P >= buckets.get(b, (0, 0))[1]:
            buckets[b] = (i, P)
    order = sorted(buckets)
    seq = [order[0], order[0]] + sorted(order[1:], reverse=True)
    return [buckets[b][0] for b in seq]


@dataclass
class System:
    eng: PagedEngine
    device: torch.device
    drain_s: float
    clients: int
    open_loop: bool
    lead_in_s: float
    warm_packed_tokens: int


def build(cell, raw, device) -> System:
    t = cell.traffic
    e = t["engine"]
    cfg = program.model_config(cell.config, seq_len=e["max_len"])
    eng = PagedEngine(cfg, program.params(raw), max_batch=e["slots"],
                      max_len=e["max_len"], chunk=e["chunk"],
                      page_size=e["page_size"],
                      prefill_chunk=e.get("prefill_chunk", 0),
                      cache_dtype=torch.bfloat16)
    return System(eng, device, float(t["drain_s"]), int(t.get("clients", 0)),
                  t["loop"] == "open", float(t.get("lead_in_s", 0)),
                  int(t.get("warm_packed_tokens", 0)))


def graph_cache(system):
    return system.eng.graph_cache


def _stream(schedule, n: int) -> list:
    """n token ids: the schedule's prompts back to back."""
    out, i = [], 0
    while len(out) < n:
        out += schedule.prompt(i)
        i += 1
    return out[:n]


def warm(system, schedule, n_requests: int):
    """One call a prefill bucket the traffic's prompts use, alone, and then
    together: a packed stream of each bucket above those up to the
    traffic's `warm_packed_tokens`, after the smallest bucket's two calls
    and before the larger single buckets, largest first (warm_plan)."""
    eng = system.eng
    pairs = [(i, *schedule.lengths(i)) for i in range(n_requests)]
    singles = [[list(schedule.prompt(i))] for i in warm_plan(pairs, eng.max_len)]
    top = max(program.prompt_bucket(P, eng.max_len) for _, P, _ in pairs)
    longest = min(max(P for _, P, _ in pairs), eng.max_len - 3)
    packed = packed_plan(top, system.warm_packed_tokens, eng.max_batch, longest)
    ids = _stream(schedule, sum(packed[0])) if packed else []
    together = [[ids[sum(lens[:j]):sum(lens[:j + 1])] for j in range(len(lens))]
                for lens in packed]
    for prompts in singles[:2] + together + singles[2:]:
        eng.run([Request(prompt_ids=p, max_new_tokens=2) for p in prompts])
    program.sync(system.device)


class _Book:
    """The requests in flight: the engine's Request beside the harness's
    record."""

    def __init__(self, eng, t0):
        self.eng, self.t0 = eng, t0
        self.live = {}   # id -> (Request, Req)
        self.reqs = []

    def submit(self, schedule, i, due, now):
        rec = Req(index=i, prompt=schedule.prompt(i), max_new=schedule.max_new(i),
                  due=due, sent=now)
        r = Request(prompt_ids=list(rec.prompt), max_new_tokens=rec.max_new)
        r.submit_time = self.t0 + due
        self.eng.submit(r)
        self.live[r.request_id] = (r, rec)
        self.reqs.append(rec)

    def step(self) -> tuple:
        """One engine step; returns (Step, requests finished in it)."""
        before = {k: (len(r.out_ids), r.first_token_time > 0)
                  for k, (r, _) in self.live.items()}
        calls0, dsteps0 = self.eng.n_prefill_calls, self.eng.n_decode_steps
        t0 = time.perf_counter() - self.t0
        finished = self.eng.step()
        t1 = time.perf_counter() - self.t0
        st = Step(t0=t0, t1=t1, prefill_calls=self.eng.n_prefill_calls - calls0,
                  decode_steps=self.eng.n_decode_steps - dsteps0)
        done_ids = {r.request_id for r in finished}
        for k, (r, rec) in list(self.live.items()):
            n0, had_first = before[k]
            n1 = len(r.out_ids)
            if r.first_token_time > 0 and not had_first:
                st.prefill_lens.append(len(r.prompt_ids))
                n0 = 1  # the prefill's token; the rest were decoded
            dec = max(n1 - n0, 0)
            if dec:
                P = len(r.prompt_ids)
                st.decode_tokens += dec
                st.decode_ctx += dec * (P + n0) + dec * (dec - 1) / 2
                st.active += 1
            if k in done_ids:
                self._close(k)
        return st, finished

    def _close(self, k):
        r, rec = self.live.pop(k)
        rec.first = r.first_token_time - self.t0 if r.first_token_time else None
        rec.finish = r.finish_time - self.t0
        rec.out = list(r.out_ids)

    def delivered(self) -> int:
        live = sum(len(r.out_ids) for r, _ in self.live.values())
        return live + sum(len(rec.out) for rec in self.reqs if rec.finish is not None)


def _shifted(rec, w0: float):
    rec.due -= w0
    rec.sent -= w0
    rec.first = None if rec.first is None else rec.first - w0
    rec.finish = None if rec.finish is None else rec.finish - w0
    return rec


def drive(system, schedule, seconds: float, tracer) -> Run:
    eng, sync = system.eng, lambda: program.sync(system.device)
    steps = []  # the window's
    t0 = time.perf_counter()
    book = _Book(eng, t0)
    nxt = 0  # next schedule index
    # the window's start, from the traffic's, and the counters there
    w0 = c0 = g0 = d0 = None

    def open_window(now):
        nonlocal w0, c0, g0, d0
        w0, c0 = now, program.counters()
        g0, d0 = program.graph_captures(graph_cache(system)), book.delivered()

    if system.lead_in_s <= 0:
        open_window(0.0)
    if not system.open_loop:
        for _ in range(system.clients):
            book.submit(schedule, nxt, 0.0, 0.0)
            nxt += 1
    now = 0.0
    while w0 is None or now < w0 + seconds:
        if w0 is None and now >= system.lead_in_s:
            open_window(now)
        horizon = system.lead_in_s if w0 is None else w0 + seconds
        if system.open_loop:
            while schedule.due(nxt) <= now:
                book.submit(schedule, nxt, schedule.due(nxt), now)
                nxt += 1
        if not eng.has_work:
            time.sleep(max(0.0, min(schedule.due(nxt), horizon) - now))
            now = time.perf_counter() - t0
            continue
        if w0 is not None:
            tracer.boundary(now - w0, len(steps), sync)
        st, finished = book.step()
        if w0 is not None:
            steps.append(st)
        now = st.t1
        if not system.open_loop and (w0 is None or now < horizon):
            for _ in finished:
                book.submit(schedule, nxt, now, now)
                nxt += 1
    tracer.boundary(now - w0, len(steps), sync, final=True)
    delivered = book.delivered() - d0
    counters = program.delta(program.counters(), c0)
    captures = program.graph_captures(graph_cache(system)) - g0
    completed = sum(1 for rec in book.reqs
                    if rec.finish is not None and w0 <= rec.finish <= now)
    if system.open_loop:  # due before the window closed, not yet sent
        while schedule.due(nxt) < now:
            book.submit(schedule, nxt, schedule.due(nxt), now)
            nxt += 1
    end = time.perf_counter() + system.drain_s
    while book.live and time.perf_counter() < end:
        book.step()
    for r, rec in book.live.values():  # unfinished after the drain: misses
        rec.first = r.first_token_time - t0 if r.first_token_time else None
        rec.out = list(r.out_ids)
    for st in steps:
        st.t0 -= w0
        st.t1 -= w0
    every = [_shifted(rec, w0) for rec in book.reqs]
    return Run(reqs=[r for r in every if r.due >= 0], steps=steps, window_s=now - w0,
               delivered=delivered, counters=counters,
               extra={"graph_captures": captures, "unfinished": len(book.live),
                      "completed": completed,
                      "lead_in": [r for r in every if r.due < 0]})
