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


def open_pool(tmp_dir, world: int):
    """A RankPool of `world` gloo ranks on the CPU, meeting through a file
    under `tmp_dir` (no TCP port: several test files run at once); each
    collective gives up after 60 s, so a hung group fails its test."""
    from kuiperllama_tpu_torch.parallel.launch import RankPool

    return RankPool(world, backend="gloo", init_method=f"file://{tmp_dir}/rendezvous",
                    timeout_s=60)


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
