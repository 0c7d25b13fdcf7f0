#!/usr/bin/env python
"""Tensor-parallel scaling, a port of tools/scaling.py.

Runs the sharded decode step at each (dp, tp) that the ranks allow, on a
pool of ranks (parallel/launch.py RankPool): gloo ranks on the CPU, two gloo
ranks on one card (their collectives pass through the host), or a world of
one NCCL rank. Per (dp, tp) it reports:

  * the measured ms per decode step (the slowest rank's best of 3 runs of
    `--steps` steps; a CPU or gloo time is relative only);
  * the analytic per-step collective bill of the projection model
    (parallel/collectives.analytic_decode_bill: 2 L all-reduces of the fp32
    [B, dim] partials after the row-parallel wo and w2, one all-gather of
    the [B, vocab] fp32 logits) and its weight bytes per rank;
  * a projected step time and scaling efficiency on H100s joined by NVLink:
    the weight stream over the card's HBM rate, plus the ring wire bytes
    over the link rate and one latency per collective (no overlap), with a
    stressed bound (70% of the link rate, 3x the latency) and a full-overlap
    one. The HBM rate is `--hbm-gbps`, else the port's roofline.probe_read
    on the card (on the CPU: the data sheet's, labelled so); the link rate
    is an argument whose default is the data sheet's, and the latency a
    constant; both are labelled assumptions.

The counted bill (collectives.decode_step_bill, one sharded step at tp =
min(4, world) on the pool) takes the place of the JAX tool's HLO bill and
is held to the analytic one (`verified`).

    python -m kuiperllama_tpu_torch.tools.scaling [--device cuda|cpu]
        [--backend gloo|nccl] [--world N] [--model preset] [--json-out f]

Prints one JSON dict (each row also on stderr); `--json-out` also writes it
to that path and nowhere else.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

import torch

from . import HBM_SHEET_GBPS, HBM_SHEET_SOURCE, add_device_arg, device_name, resolve_device

# NVLink 4 on the H100 SXM data sheet: 900 GB/s a GPU, both directions
LINK_GBPS = 450.0
LINK_SOURCE = "H100 SXM data sheet: NVLink 900 GB/s per GPU bidirectional, 450 each way"
# a per-collective latency: an assumption, not a measurement
COLL_US = 10.0
COLL_SOURCE = "assumed per collective, not measured"
MESHES = ((1, 1), (1, 2), (1, 4), (1, 8), (2, 1), (2, 2), (2, 4), (4, 2), (8, 1))


def tiny_cfg():
    """The measured model when no preset is named (the JAX tool's)."""
    from ..config import tiny_config

    return tiny_config("llama2", n_heads=8, n_kv_heads=8, dim=128, hidden_dim=256,
                       vocab_size=512, seq_len=64)


def _params(cfg, seed, device):
    from ..params import random_params, to_device

    return to_device(random_params(cfg, seed=seed), device=device, dtype=torch.float32)


def measure_rank(cfg, seed, dp, tp, steps, device):
    """On every rank of the pool: this rank's best ms per decode step of
    2 dp rows at (dp, tp) (dp = tp = 1: rank 0 alone, unsharded), None off
    the mesh. Tokens stay 0, positions advance: the step's work does not
    depend on the token values."""
    import torch.distributed as dist

    from ..models import decoder
    from ..parallel.mesh import make_mesh
    from ..parallel.sharded import ShardedForward
    from ..parallel.shardings import shard_params

    dev = torch.device(device)
    if dp == tp == 1:
        if dist.get_rank():
            return None
        fwd, mesh = None, None
    else:
        mesh = make_mesh(dp, tp)
        if mesh is None:
            return None
    params = _params(cfg, seed, dev)
    B = 2 * dp
    if mesh is None:
        sp = params
        cache = decoder.init_kv_cache(cfg, batch=B, max_len=32, device=dev)
    else:
        fwd = ShardedForward(cfg, mesh, params)
        sp = shard_params(params, mesh, cfg)
        cache = fwd.init_cache(batch=B, max_len=32, device=dev)
    tok = torch.zeros((B,), dtype=torch.int32, device=dev)

    def run():
        nonlocal cache
        for i in range(steps):
            pos = torch.full((B,), 3 + i, dtype=torch.int32, device=dev)
            logits, cache = decoder.decode_step(cfg, sp, tok, pos, cache, forward_fn=fwd)
        logits.cpu()  # the last step's logits on the host: every step is done

    run()  # warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best / steps * 1e3


def bill_rank(cfg, seed, tp, device):
    """collectives.decode_step_bill at (1, tp) on this rank (None off the
    mesh)."""
    from ..parallel import collectives
    from ..parallel.mesh import make_mesh

    mesh = make_mesh(1, tp)
    if mesh is None:
        return None
    return collectives.decode_step_bill(cfg, mesh, _params(cfg, seed, torch.device(device)),
                                        batch=2, cache_len=32)


def weight_bytes(cfg, group: int = 64) -> int:
    """INT8 projection and lm_head bytes plus fp32 group scales (the JAX
    tool's count)."""
    d, h, kv, V, L = cfg.dim, cfg.hidden_dim, cfg.kv_dim, cfg.vocab_size, cfg.n_layers
    mats = L * (2 * d * d + 2 * d * kv + 3 * d * h) + d * V
    return mats + (mats // group) * 4


def analytic(cfg, tp, B, weight_bytes, hbm_gbps, link_gbps) -> dict:
    """The per-step bill of `cfg` at tp for B rows (fp32 partials: the INT8
    kernels' exchange) and the projection on H100s over NVLink. No overlap
    in the headline efficiency; eff_stress_worst takes 70% of the link rate
    and 3x the latency; eff_full_overlap hides every collective behind the
    weight stream. The data axis exchanges nothing at inference."""
    from ..parallel.collectives import analytic_decode_bill

    bill = analytic_decode_bill(cfg, B, 4)
    psum, gather = bill["all-reduce"]["bytes"], bill["all-gather"]["bytes"]
    n_coll = bill["all-reduce"]["count"] + bill["all-gather"]["count"]

    def coll_s(gbps, us):
        # a ring all-reduce moves 2 (tp - 1) / tp of its payload a rank, an
        # all-gather (tp - 1) / tp
        wire = psum * 2 * (tp - 1) / tp + gather * (tp - 1) / tp
        return wire / (gbps * 1e9) + n_coll * us * 1e-6

    stream_s = weight_bytes / tp / (hbm_gbps * 1e9)
    coll = coll_s(link_gbps, COLL_US) if tp > 1 else 0.0
    worst = coll_s(link_gbps * 0.7, COLL_US * 3) if tp > 1 else 0.0
    return dict(collectives_per_step=n_coll if tp > 1 else 0, psum_bytes=psum,
                all_gather_bytes=gather, weight_bytes_per_rank=weight_bytes // tp,
                projected_step_ms=round((stream_s + coll) * 1e3, 4),
                projected_scaling_eff=round(stream_s / (stream_s + coll), 4),
                eff_stress_worst=round(stream_s / (stream_s + worst), 4),
                eff_full_overlap=round(stream_s / max(stream_s, coll), 4),
                dp_bytes_per_step=0)


def meshes(cfg, world):
    return [(dp, tp) for dp, tp in MESHES
            if not (cfg.n_kv_heads % tp or cfg.vocab_size % tp or dp * tp > world)]


def run(pool, device, cfg, hbm_gbps, hbm_source, proj_name="llama2-7b", steps=8, seed=0,
        link_gbps=LINK_GBPS, backend="gloo",
        measured_model="tiny") -> dict:
    """Every (dp, tp) the pool's ranks allow, measured on `cfg` and
    projected on the preset `proj_name`, and the counted bill at tp =
    min(4, world)."""
    from ..config import preset_config

    proj_cfg = preset_config(proj_name)
    w = weight_bytes(proj_cfg)
    rows, base = [], None
    for dp, tp in meshes(cfg, pool.world):
        step_ms = max(ms for ms in pool.run(measure_rank, cfg, seed, dp, tp, steps,
                                            str(device)) if ms is not None)
        row = dict(dp=dp, tp=tp, batch=2 * dp, measured_step_ms=round(step_ms, 4))
        row.update(analytic(proj_cfg, tp, 2, w, hbm_gbps, link_gbps))
        base = base or step_ms
        # dp multiplies the rows served at about one step time
        row["measured_rel_speedup"] = round(dp * base / step_ms, 3)
        rows.append(row)
        print(json.dumps(row), file=sys.stderr)
    bill = pool.run(bill_rank, cfg, seed, min(4, pool.world), str(device))[0]
    em, an = bill["emitted"], bill["analytic"]
    ar, ag = em.get("all-reduce", {}), em.get("all-gather", {})
    verified = (ar.get("count") == 2 * cfg.n_layers
                and ar.get("bytes") == an["all_reduce_bytes_per_step"]
                and ag.get("count") == 1 and ag.get("bytes") == an["all_gather_bytes"])
    return dict(device=device_name(device), world=pool.world, backend=backend,
                measured_model=measured_model, projection_model=f"{proj_name} int8 g 64",
                link_GBps=link_gbps,
                link_source=LINK_SOURCE if link_gbps == LINK_GBPS else "--link-gbps",
                hbm_GBps=hbm_gbps, hbm_source=hbm_source, coll_latency_us=COLL_US,
                coll_latency_source=COLL_SOURCE,
                counted_collectives=dict(emitted=em, analytic=an, verified=bool(verified)),
                rows=rows)


def main(argv=None) -> dict:
    from ..config import preset_config
    from ..parallel.launch import RankPool
    from ..utils.profiling import nvidia_smi_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(ap)
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    ap.add_argument("--world", type=int, default=2, help="ranks in the pool")
    ap.add_argument("--model", help="measured preset; default a tiny config")
    ap.add_argument("--proj-model", help="preset of the projection (default: --model, "
                                         "else llama2-7b)")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--hbm-gbps", type=float, help="the card's HBM rate (default: probed)")
    ap.add_argument("--link-gbps", type=float, default=LINK_GBPS)
    ap.add_argument("--json-out", help="also write the dict to this path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.backend == "nccl" and (dev.type != "cuda" or args.world != 1):
        raise SystemExit("--backend nccl runs a world of one rank on the card: the "
                         "pool puts every rank on one device, which NCCL refuses")
    cfg = preset_config(args.model, seq_len=64) if args.model else tiny_cfg()
    if args.hbm_gbps is not None:
        hbm, hbm_source = args.hbm_gbps, "--hbm-gbps"
    elif dev.type == "cuda":
        from .roofline import probe_read

        hbm, hbm_source = probe_read(dev), "roofline.probe_read on this card"
    else:
        hbm, hbm_source = HBM_SHEET_GBPS, f"{HBM_SHEET_SOURCE} (no card in this run)"
    rdv = tempfile.mkdtemp(prefix="kt_scaling_")
    try:
        with RankPool(args.world, backend=args.backend, init_method=f"file://{rdv}/rdv",
                      device=str(dev) if dev.type == "cuda" else None) as pool:
            out = run(pool, dev, cfg, hbm, hbm_source,
                      proj_name=args.proj_model or args.model or "llama2-7b",
                      steps=args.steps, link_gbps=args.link_gbps,
                      backend=args.backend, measured_model=args.model or "tiny")
    finally:
        shutil.rmtree(rdv, ignore_errors=True)
    out["nvidia_smi"] = nvidia_smi_line() if dev.type == "cuda" else None
    s = json.dumps(out, indent=2)
    print(s, flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(s + "\n")
    return out


if __name__ == "__main__":
    main()
