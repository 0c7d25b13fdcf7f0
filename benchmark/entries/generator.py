"""Driver of the port's B = 1 Generator (`serving/generate.py`): one client
in a closed loop sends a request as soon as the last one is answered.

Traffic keys: "generator": {"cache_len", "chunk"}. A request's first token
is on the host when the Generator hands over its first chunk (the prefill's
token, `on_chunk`); it finishes when `generate_batch_ids` returns.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from benchmark.harness import program
from benchmark.harness.record import Req, Run, Step
from kuiperllama_tpu_torch.serving.generate import Generator


def windows(P: int, N: int, chunk: int, cache_len: int) -> list:
    """The attention windows of the decode chunks of a P-token prompt
    answered with N tokens, in order."""
    out, max_pos, budget = [], P, min(N, cache_len - P) - 1
    while budget > 0:
        steps = min(chunk, budget)
        out.append(program.attention_window(max_pos + steps + 1, cache_len))
        max_pos += steps
        budget -= steps
    return out


def warm_plan(pairs, chunk: int, cache_len: int) -> list:
    """(schedule index, tokens to ask) of the warm-up requests: each prompt
    bucket the pairs use, largest first, answered with 2 tokens; then, for
    each attention window not yet reached, the pair that reaches it with the
    fewest tokens, cut after that chunk; then the largest bucket again, so a
    workspace that grew after its capture is captured again here and not
    inside the window. pairs: [(index, P, N)]."""
    buckets = {}
    for i, P, _ in pairs:
        b = program.prompt_bucket(P, cache_len)
        if P >= buckets.get(b, (0, 0))[1]:
            buckets[b] = (i, P)
    plan, reached = [], set()
    for b in sorted(buckets, reverse=True):
        i, P = buckets[b]
        plan.append((i, 2))
        reached |= set(windows(P, 2, chunk, cache_len))
    need = set()
    for _, P, N in pairs:
        need |= set(windows(P, N, chunk, cache_len))
    for w in sorted(need - reached):
        if w in reached:
            continue
        best = None
        for i, P, N in pairs:
            ws = windows(P, N, chunk, cache_len)
            if w in ws:
                k = ws.index(w)
                n = 1 + sum(min(chunk, N - 1 - chunk * j) for j in range(k + 1))
                if best is None or n < best[1]:
                    best = (i, n, P)
        plan.append(best[:2])
        reached |= set(windows(best[2], best[1], chunk, cache_len))
    plan.append(plan[0])
    return plan


@dataclass
class System:
    gen: Generator
    device: torch.device
    chunk: int
    cache_len: int


def build(cell, raw, device) -> System:
    g = cell.traffic["generator"]
    cfg = program.model_config(cell.config, seq_len=g["cache_len"])
    gen = Generator(cfg, program.params(raw), cache_len=g["cache_len"],
                    cache_dtype=torch.bfloat16, chunk=g["chunk"])
    return System(gen, device, g["chunk"], g["cache_len"])


def graph_cache(system):
    return system.gen.graph_cache if system.gen.graphs_on() else None


def warm(system, schedule, n_requests: int):
    pairs = [(i, *schedule.lengths(i)) for i in range(n_requests)]
    for i, n in warm_plan(pairs, system.chunk, system.cache_len):
        system.gen.generate_batch_ids([schedule.prompt(i)], max_new_tokens=n)
    program.sync(system.device)


def drive(system, schedule, seconds: float, tracer) -> Run:
    gen, sync = system.gen, lambda: program.sync(system.device)
    reqs, steps = [], []
    c0 = program.counters()
    g0 = program.graph_captures(graph_cache(system))
    t0 = time.perf_counter()
    now = 0.0
    while now < seconds:
        tracer.boundary(now, len(steps), sync)
        i = len(reqs)
        prompt = schedule.prompt(i)
        req = Req(index=i, prompt=prompt, max_new=schedule.max_new(i), due=now,
                  sent=now)
        chunks = []
        rows, _, _ = gen.generate_batch_ids(
            [prompt], max_new_tokens=req.max_new,
            on_chunk=lambda block: chunks.append(time.perf_counter() - t0))
        req.finish = time.perf_counter() - t0
        req.first, req.out = chunks[0], rows[0]
        reqs.append(req)
        P, n = len(prompt), len(req.out) - 1
        steps.append(Step(t0=req.sent, t1=req.finish, prefill_lens=[P],
                          prefill_calls=1, decode_tokens=n,
                          decode_ctx=n * P + n * (n + 1) / 2, decode_steps=n,
                          active=1))
        now = req.finish
    tracer.boundary(now, len(steps), sync, final=True)
    return Run(reqs=reqs, steps=steps, window_s=now,
               delivered=sum(len(r.out) for r in reqs),
               counters=program.delta(program.counters(), c0),
               extra={"graph_captures": program.graph_captures(graph_cache(system)) - g0})
