"""What each rank runs in the parallel tests (tests/test_torch_sharded.py,
test_torch_sharded_paged.py, test_torch_seqpar*.py, test_torch_distributed.py,
test_torch_collectives.py).

These functions run inside the RankPool workers (kuiperllama_tpu_torch/
parallel/launch.py), which import only torch, numpy and the port: no JAX.
The INT8 projections take quant_matmul_plain (set_use_kernels(False)), as
the JAX side runs with its Pallas kernels off. Weights arrive as the JAX
package's params in numpy ({q, s, group_size}
dicts for INT8 leaves) and are carried across with `convert.from_jax_params`
on every rank; inputs are numpy arrays. Each case builds its mesh (every
rank of the pool takes part in the group creation; a rank outside the mesh
returns None) and returns numpy results with its mesh coordinates.
"""

from __future__ import annotations

import numpy as np
import torch

from kuiperllama_tpu_torch.config import tiny_config
from kuiperllama_tpu_torch.convert import from_jax_params
from kuiperllama_tpu_torch.fuse import fuse_params
from kuiperllama_tpu_torch.models import decoder
from kuiperllama_tpu_torch.ops.linear import set_use_kernels
from kuiperllama_tpu_torch.parallel import collectives
from kuiperllama_tpu_torch.parallel.mesh import make_mesh
from kuiperllama_tpu_torch.parallel.sharded import ShardedForward
from kuiperllama_tpu_torch.parallel.shardings import shard_params


def _setup(cfg_kw, tree, dp, tp):
    # the INT8 projections take quant_matmul_plain, the counterpart of the
    # JAX side's XLA matmul (set_use_pallas(False))
    set_use_kernels(False)
    mesh = make_mesh(dp, tp)
    if mesh is None:
        return None, None, None
    return mesh, tiny_config(**cfg_kw), from_jax_params(tree, device="cpu")


def _where(mesh):
    return dict(dp_rank=mesh.dp_rank, tp_rank=mesh.tp_rank)


def sharded_forward(cfg_kw, tree, tokens, dp, tp, fuse=False, cache_len=32):
    """One ShardedForward over global tokens [B, T] from position 0: this
    rank's logits rows and its part of the K cache."""
    mesh, cfg, params = _setup(cfg_kw, tree, dp, tp)
    if mesh is None:
        return None
    fwd = ShardedForward(cfg, mesh, params)
    sp = shard_params(params, mesh, cfg)
    if fuse:
        sp = fuse_params(sp)
    tokens = torch.from_numpy(tokens)
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32).expand(B, T)
    cache = fwd.init_cache(B, cache_len, device="cpu")
    logits, cache = fwd(cfg, sp, tokens, positions, cache)
    return dict(_where(mesh), fused="wqkv" in sp["blocks"], logits=logits.numpy(),
                k=cache["k"].numpy())


def sharded_decode(cfg_kw, tree, tokens, tok, pos, steps, dp, tp):
    """decoder.prefill then `steps` decode steps through ShardedForward, the
    next token each step the argmax of the gathered logits: this rank's
    logits rows of the prefill and of each step, and the prefill's
    all-gather bytes."""
    mesh, cfg, params = _setup(cfg_kw, tree, dp, tp)
    if mesh is None:
        return None
    fwd = ShardedForward(cfg, mesh, params)
    sp = shard_params(params, mesh, cfg)
    B = tokens.shape[0]
    cache = fwd.init_cache(B, 32, device="cpu")
    collectives.reset()
    last, cache = decoder.prefill(cfg, sp, torch.from_numpy(tokens), cache,
                                  forward_fn=fwd)
    gathered = collectives.bill()["all-gather"]["bytes"]
    out = [last.numpy()]
    tok, pos = torch.from_numpy(tok), torch.from_numpy(pos)
    for _ in range(steps):
        logits, cache = decoder.decode_step(cfg, sp, tok, pos, cache, forward_fn=fwd)
        out.append(logits.numpy())
        # every data rank needs the whole batch's next tokens: gather them
        # (a test-side exchange, outside the counted collectives)
        parts = [torch.empty_like(logits) for _ in range(mesh.dp)]
        torch.distributed.all_gather(parts, logits.contiguous(), group=mesh.data_group)
        tok = torch.cat(parts).argmax(-1).to(torch.int32)
        pos = pos + 1
    return dict(_where(mesh), logits=out, prefill_gather_bytes=gathered)


def sharded_generate(cfg_kw, tree, prompts, new, tp, api=False):
    """Greedy tokens of a tp-rank Generator (forward_fn=ShardedForward), or
    of KuiperModel.init(mesh=) when `api`."""
    from kuiperllama_tpu_torch.api import KuiperModel
    from kuiperllama_tpu_torch.serving.generate import Generator

    mesh, cfg, params = _setup(cfg_kw, tree, 1, tp)
    if mesh is None:
        return None
    if api:
        model = KuiperModel(cfg, params).init(dtype=torch.float32, device="cpu",
                                              cache_len=64, mesh=mesh)
        return dict(_where(mesh), ids=[model.generate_ids(p, new) for p in prompts],
                    logits=model.forward(prompts[0]).numpy(),
                    graphs=model._generator.graphs_on())
    gen = Generator(cfg, fuse_params(shard_params(params, mesh, cfg)),
                    cache_len=64, forward_fn=ShardedForward(cfg, mesh, params))
    rows, _, _ = gen.generate_batch_ids(prompts, max_new_tokens=new)
    return dict(_where(mesh), ids=rows, graphs=gen.graphs_on())


def paged_engine(cfg_kw, tree, prompts, max_new, tp, engine_kw, seqpar=False,
                 steps_then_lists=False):
    """A PagedEngine(mesh=, seqpar=) run of `prompts`: each request's
    tokens, the engine's free pages at start, its reserved pages and the
    pools' local shape (and with `steps_then_lists`, every rank's items of
    the work lists after one step)."""
    from kuiperllama_tpu_torch.serving.engine import PagedEngine, Request

    mesh, cfg, params = _setup(cfg_kw, tree, 1, tp)
    if mesh is None:
        return None
    eng = PagedEngine(cfg, params, mesh=mesh, seqpar=seqpar,
                      cache_dtype=torch.float32, **engine_kw)
    free0 = eng.allocator.n_free_pages
    reqs = [Request(prompt_ids=list(p), max_new_tokens=max_new) for p in prompts]
    out = dict(_where(mesh), free_pages=free0, n_pages=eng._n_pages,
               reserved=sorted(eng.allocator.reserved),
               pool_shape=tuple(eng.k_pages.shape), graphs=eng.graph_cache is not None)
    if steps_then_lists:
        for r in reqs:
            eng.submit(r)
        eng.step()
        *_, ni, _ = eng._sharded.build_lists(eng.allocator.page_table,
                                             eng.allocator.seq_lens, eng.page_size,
                                             eng._n_pages)
        out["items"] = ni[:, 0].tolist()
        eng.run([])
    else:
        done = eng.run(reqs)
        assert {r.request_id for r in done} == {r.request_id for r in reqs}
    out["out_ids"] = [r.out_ids for r in reqs]
    return out


def seqpar_attention(q, kp, vp, pt, lens, ps, sp):
    """SeqParAttention over `sp` ranks on full pools [P, ps, KH*hd]."""
    from kuiperllama_tpu_torch.parallel.seqpar import SeqParAttention

    mesh = make_mesh(1, sp)
    if mesh is None:
        return None
    att = SeqParAttention(mesh, page_size=ps)
    kps, vps = att.shard_pages(torch.from_numpy(kp), torch.from_numpy(vp))
    return att(torch.from_numpy(q), kps, vps, pt, lens).numpy()


def decode_bill(cfg_kw, tree, dp, tp, batch):
    """collectives.decode_step_bill on this rank."""
    mesh, cfg, params = _setup(cfg_kw, tree, dp, tp)
    if mesh is None:
        return None
    return dict(_where(mesh), **collectives.decode_step_bill(cfg, mesh, params,
                                                             batch=batch,
                                                             cache_len=32))


def counted_ops(tp):
    """Each collective of the wrapper once, on fp32 and bf16 tensors: the
    counters before and after, and the results."""
    mesh = make_mesh(1, tp)
    if mesh is None:
        return None
    g, r = mesh.model_group, mesh.tp_rank
    collectives.reset()
    x = torch.full((2, 3), float(r + 1))
    red = x.clone()
    in_place = collectives.all_reduce(red, g) is red
    gat = collectives.all_gather(x.to(torch.bfloat16), g, dim=-1)
    stk = collectives.all_gather(x[None], g, dim=0)
    return dict(_where(mesh), bill=collectives.bill(), x=x.numpy(),
                reduced=red.numpy(), gathered=gat.float().numpy(),
                stacked=stk.numpy(), none=collectives.all_reduce(x, None) is x,
                in_place=in_place)


def world_info():
    """This rank's view of the default group."""
    import torch.distributed as dist

    return dict(rank=dist.get_rank(), world=dist.get_world_size(),
                backend=dist.get_backend())


def open_pool(tmp_dir, world: int, timeout_s: float = 60):
    """A RankPool of `world` gloo ranks on the CPU, meeting through a file
    under `tmp_dir` (no TCP port: several test files run at once); each
    collective gives up after `timeout_s`, so a hung group fails its test."""
    from kuiperllama_tpu_torch.parallel.launch import RankPool

    return RankPool(world, backend="gloo", init_method=f"file://{tmp_dir}/rendezvous",
                    timeout_s=timeout_s)


def numpy_tree(params):
    """A JAX params tree as numpy, INT8 leaves as {q, s, group_size} dicts
    (what the ranks take)."""
    def leaf(x):
        if all(hasattr(x, k) for k in ("q", "s", "group_size")):
            return dict(q=np.asarray(x.q), s=np.asarray(x.s),
                        group_size=int(x.group_size))
        return np.asarray(x)

    out = {k: leaf(v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = {k: leaf(v) for k, v in params["blocks"].items()}
    return out


def by_rank(outs, tp_rank=0):
    """The outputs of the ranks at `tp_rank`, in data-rank order."""
    rows = [o for o in outs if o is not None and o["tp_rank"] == tp_rank]
    return sorted(rows, key=lambda o: o["dp_rank"])


def fail_on(rank: int):
    """Raise on `rank`, return the rank elsewhere."""
    import torch.distributed as dist

    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return dist.get_rank()


def paged_step(cfg_kw, tree, tokens, lens, pt, n_pages, ps, steps, tp, seqpar):
    """ShardedPagedStep / SeqParPagedStep called directly, as the JAX
    entry points are: shard_pages of full zero pools, prefill of `tokens`
    into the pages of `pt`, then one decode_chunk of `steps` greedy steps
    over work lists that cover them. Returns every row's first token and
    the chunk's tokens."""
    from kuiperllama_tpu_torch.kvcache import init_paged_cache
    from kuiperllama_tpu_torch.ops.kernels.paged_attention import build_work_list
    from kuiperllama_tpu_torch.parallel.seqpar import SeqParPagedStep
    from kuiperllama_tpu_torch.parallel.sharded_paged import ShardedPagedStep

    mesh, cfg, params = _setup(cfg_kw, tree, 1, tp)
    if mesh is None:
        return None
    sp = fuse_params(shard_params(params, mesh, cfg, seqpar=seqpar))
    step = (SeqParPagedStep if seqpar else ShardedPagedStep)(cfg, mesh, sp)
    full = init_paged_cache(cfg, n_pages, ps, torch.float32, device="cpu")
    kp, vp = step.shard_pages(full.k_pages, full.v_pages)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    B, T = tokens.shape
    token_pages = np.full((B, T), 2 ** 30, np.int32)
    for b in range(B):
        token_pages[b, :lens[b]] = pt[b, np.arange(lens[b]) // ps]
    last, kp, vp = step.prefill(cfg, sp, t(tokens), t(lens), kp, vp, t(token_pages))
    first = last.argmax(-1).to(torch.int32)
    sl = np.minimum(lens + steps + 1, pt.shape[1] * ps).astype(np.int32)
    covered = None
    if seqpar:
        fb, fp, ft, ni, cov = step.build_lists(pt, sl, ps, n_pages)
        r = mesh.tp_rank
        fb, fp, ft, ni, covered = fb[r], fp[r], ft[r], ni[r], t(cov[r])
    else:
        fb, fp, ft, ni = build_work_list(pt, sl, ps)
    stop = torch.full((8,), -1, dtype=torch.int32)
    toks = step.decode_chunk(cfg, sp, first, t(lens), kp, vp,
                             torch.zeros(B, dtype=torch.bool), None, stop, t(pt), t(fb),
                             t(fp), t(ft), t(ni), steps, page_size=ps, covered=covered)[0]
    return dict(_where(mesh), first=first.tolist(), toks=toks.tolist())


# ---------------------------------------------------------------------------
# The server across ranks (tests/test_torch_server_ranks.py): every rank
# builds PagedEngine(mesh=) and InferenceServer; rank 0 serves, rank 1
# follows. Each case returns, on every rank, the requests its engine was
# given (id, tokens, finished), in order, and its free pages.


# the server cases' pool's timeout: every collective of their meshes, the
# control broadcasts too
SERVER_GROUP_TIMEOUT_S = 3


def _served_engine(cfg_kw, tree, tp, engine_kw, seqpar=False, timeout_s=30.0):
    """This rank's mesh, PagedEngine(mesh=), InferenceServer and the list
    its engine's submissions are recorded into."""
    from kuiperllama_tpu_torch.serving.engine import PagedEngine
    from kuiperllama_tpu_torch.serving.server import InferenceServer

    set_use_kernels(False)
    mesh = make_mesh(1, tp)
    cfg, params = tiny_config(**cfg_kw), from_jax_params(tree, device="cpu")
    eng = PagedEngine(cfg, params, mesh=mesh, seqpar=seqpar, cache_dtype=torch.float32,
                      **engine_kw)
    submitted, submit = [], eng.submit

    def record(req):
        submitted.append(req)
        submit(req)

    eng.submit = record
    srv = InferenceServer(eng, timeout_s=timeout_s, poll_idle_s=0.002)
    return mesh, eng, srv, submitted


def _report(mesh, eng, srv, submitted, free0, **extra):
    return dict(_where(mesh), leader=srv.leader, free_start=free0,
                free_end=eng.allocator.n_free_pages, has_work=eng.has_work,
                error=None if srv.error is None else repr(srv.error),
                control_messages=srv.control.messages,
                submitted=[(r.request_id, list(r.out_ids), r.finished) for r in submitted],
                **extra)


def _follow(srv, seconds=60.0):
    """A follower's part: follow until the leader's stop flag (or a failed
    collective) ends the loop; whether it ended."""
    srv.start()
    return srv.join(seconds)


def _queue_then_start(srv, prompts, max_new):
    """Submit `prompts` from one client thread each, queued in order before
    the server starts (one turn takes them all, as JAX's server queued the
    same way does), then start it and wait: the answers' ids."""
    import threading
    import time

    answers = [None] * len(prompts)

    def client(i):
        try:
            answers[i] = srv.submit(prompt_ids=list(prompts[i]), max_new_tokens=max_new)
        except Exception as e:  # noqa: BLE001 (returned to the test)
            answers[i] = e

    threads = []
    for i in range(len(prompts)):
        threads.append(threading.Thread(target=client, args=(i,), daemon=True))
        threads[-1].start()
        end = time.monotonic() + 10
        while srv._q.qsize() < i + 1 and time.monotonic() < end:
            time.sleep(0.001)
    srv.start()
    for t in threads:
        t.join(60)
    return [a["ids"] if isinstance(a, dict) else repr(a) for a in answers]


def serve_queued(cfg_kw, tree, prompts, max_new, tp, engine_kw, seqpar=False):
    """Requests queued on rank 0's server before it starts, then served."""
    mesh, eng, srv, submitted = _served_engine(cfg_kw, tree, tp, engine_kw, seqpar)
    free0 = eng.allocator.n_free_pages
    if not srv.leader:
        ended = _follow(srv)
        return _report(mesh, eng, srv, submitted, free0, ended=ended)
    answers = _queue_then_start(srv, prompts, max_new)
    srv.stop()
    return _report(mesh, eng, srv, submitted, free0, answers=answers, ended=srv.join(0))


def _http(base, path, body=None):
    """(status, JSON) of a GET, or of a POST of `body`."""
    import json
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    try:
        with urllib.request.urlopen(urllib.request.Request(base + path, data=data),
                                    timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def serve_http(cfg_kw, tree, prompts, max_new, tp, engine_kw, bad=()):
    """Rank 0's HTTP front: every prompt posted at once from its own
    thread, then each body of `bad` (each must be refused), then one more
    valid request; the statuses and answers."""
    import threading

    from kuiperllama_tpu_torch.serving.server import make_http_server

    mesh, eng, srv, submitted = _served_engine(cfg_kw, tree, tp, engine_kw)
    free0 = eng.allocator.n_free_pages
    if not srv.leader:
        try:
            make_http_server(srv, "127.0.0.1", 0)
            refused = False
        except ValueError:
            refused = True
        ended = _follow(srv)
        return _report(mesh, eng, srv, submitted, free0, ended=ended,
                       http_refused=refused)
    srv.start()
    httpd = make_http_server(srv, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        results = [None] * len(prompts)

        def client(i):
            results[i] = _http(base, "/generate", {"prompt_ids": list(prompts[i]),
                                                   "max_new_tokens": max_new})

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        refused = [_http(base, "/generate", b) for b in bad]
        after = _http(base, "/generate", {"prompt_ids": list(prompts[0]),
                                          "max_new_tokens": max_new})
        health = _http(base, "/healthz")
        metrics = _http(base, "/metrics")[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
    return _report(mesh, eng, srv, submitted, free0, results=results, refused=refused,
                   after=after, health=health, metrics=metrics, ended=srv.join(0))


def serve_timeout(cfg_kw, tree, prompt, max_new, tp, engine_kw, timeout_s, step_delay):
    """A request that times out on rank 0 mid-decode (rank 0's steps are
    slowed by `step_delay` s), then one that is served. Rank 1 first makes
    100 requests of its own, so its id counter runs ahead of rank 0's, and
    reads its counter again at the end."""
    import time

    from kuiperllama_tpu_torch.serving.engine import Request

    mesh, eng, srv, submitted = _served_engine(cfg_kw, tree, tp, engine_kw)
    free0 = eng.allocator.n_free_pages
    if not srv.leader:
        skewed = [Request(prompt_ids=[1]).request_id for _ in range(100)]
        ended = _follow(srv)
        return _report(mesh, eng, srv, submitted, free0, ended=ended, skewed=skewed,
                       next_own_id=Request(prompt_ids=[1]).request_id)
    step = eng.step

    def slow():
        out = step()
        time.sleep(step_delay)
        return out

    eng.step = slow
    srv.start()
    try:
        srv.submit(prompt_ids=list(prompt), max_new_tokens=max_new, timeout_s=timeout_s)
        timed_out = False
    except TimeoutError:
        timed_out = True
    end = time.monotonic() + 30
    while eng.has_work and time.monotonic() < end:
        time.sleep(0.01)
    free_after_cancel = eng.allocator.n_free_pages
    eng.step = step
    after = srv.submit(prompt_ids=list(prompt), max_new_tokens=4)["ids"]
    srv.stop()
    return _report(mesh, eng, srv, submitted, free0, timed_out=timed_out,
                   free_after_cancel=free_after_cancel, after=after, ended=srv.join(0))


def serve_after_idle(cfg_kw, tree, prompt, max_new, tp, engine_kw, idle_s):
    """Rank 0's server idles `idle_s` seconds (longer than the group's
    timeout), then serves one request."""
    import time

    mesh, eng, srv, submitted = _served_engine(cfg_kw, tree, tp, engine_kw)
    free0 = eng.allocator.n_free_pages
    if not srv.leader:
        ended = _follow(srv)
        return _report(mesh, eng, srv, submitted, free0, ended=ended)
    srv.start()
    time.sleep(idle_s)
    alive = srv.alive
    ids = srv.submit(prompt_ids=list(prompt), max_new_tokens=max_new)["ids"]
    srv.stop()
    return _report(mesh, eng, srv, submitted, free0, alive_after_idle=alive, answer=ids,
                   ended=srv.join(0))


def serve_with_fault(cfg_kw, tree, prompts, max_new, tp, engine_kw, fault_step):
    """Rank 1's engine raises in its `fault_step`-th step; rank 0 has
    `prompts` waiting. Rank 0 returns how each request ended, the seconds
    from start to the last answer, /healthz and whether a later submission
    fails at once."""
    import threading
    import time

    from kuiperllama_tpu_torch.serving.server import EngineFailed, make_http_server

    mesh, eng, srv, submitted = _served_engine(cfg_kw, tree, tp, engine_kw)
    free0 = eng.allocator.n_free_pages
    if not srv.leader:
        step, calls = eng.step, [0]

        def faulty():
            calls[0] += 1
            if calls[0] == fault_step:
                raise RuntimeError("rank 1 fails on purpose")
            return step()

        eng.step = faulty
        ended = _follow(srv)
        return _report(mesh, eng, srv, submitted, free0, ended=ended)
    outcomes = [None] * len(prompts)

    def client(i):
        try:
            srv.submit(prompt_ids=list(prompts[i]), max_new_tokens=max_new)
            outcomes[i] = "answered"
        except EngineFailed:
            outcomes[i] = "EngineFailed"
        except Exception as e:  # noqa: BLE001 (returned to the test)
            outcomes[i] = repr(e)

    t0 = time.monotonic()
    srv.start()
    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    seconds = time.monotonic() - t0
    httpd = make_http_server(srv, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        health = _http(f"http://127.0.0.1:{httpd.server_address[1]}", "/healthz")
    finally:
        httpd.shutdown()
        httpd.server_close()
    t1 = time.monotonic()
    try:
        srv.submit(prompt_ids=list(prompts[0]), max_new_tokens=max_new)
        later = "answered"
    except EngineFailed:
        later = "EngineFailed"
    later_s = time.monotonic() - t1
    srv.stop()
    return _report(mesh, eng, srv, submitted, free0, outcomes=outcomes, seconds=seconds,
                   health=health, later=later, later_s=later_s, alive=srv.alive,
                   ended=srv.join(0))


def serve_stop(cfg_kw, tree, tp, engine_kw):
    """start() then stop() on rank 0: the seconds each rank's loop took to
    end after rank 0's stop (rank 1: from its start)."""
    import time

    mesh, eng, srv, submitted = _served_engine(cfg_kw, tree, tp, engine_kw)
    free0 = eng.allocator.n_free_pages
    t0 = time.monotonic()
    if not srv.leader:
        ended = _follow(srv, seconds=20)
        return _report(mesh, eng, srv, submitted, free0, ended=ended,
                       seconds=time.monotonic() - t0)
    srv.start()
    time.sleep(0.2)
    t0 = time.monotonic()
    srv.stop()
    return _report(mesh, eng, srv, submitted, free0, ended=srv.join(0),
                   seconds=time.monotonic() - t0)


def control_groups():
    """The control group at tp = 2 (its backend and size) and at tp = 1, and
    the timeout (s) of each group of a tp = 2 mesh."""
    import torch.distributed as dist

    two, one = make_mesh(1, 2), make_mesh(1, 1)
    g = two.control_group
    cpu = torch.device("cpu")
    return dict(tp2=(dist.get_backend(g), dist.get_world_size(g),
                     dist.get_backend(two.model_group)),
                tp1=None if one is None else one.control_group,
                timeouts=[x._get_backend(cpu).options._timeout.total_seconds()
                          for x in (two.model_group, two.data_group, two.control_group)])
