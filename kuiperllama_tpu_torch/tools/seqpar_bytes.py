#!/usr/bin/env python
"""Sequence-parallel page-read bytes, a port of tools/seqpar_bytes.py: each
rank's page-READ bytes per decode step at the Llama-2-7B geometry and a
long context, counted exactly from the work lists the paged kernel walks
(parallel/seqpar.build_work_lists_sharded), so they need no second card;
and the host milliseconds of building those lists at this scale (the
machine's own: a per-decode-chunk scheduler cost).

    python -m kuiperllama_tpu_torch.tools.seqpar_bytes [--batch 8] [--ctx 2048]
        [--page-size 128] [--json-out f]

Prints one JSON dict (and each sp's row on stderr); `--json-out` also
writes it to that path and nowhere else.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..config import preset_config
from ..parallel.seqpar import build_work_lists_sharded

SHARDS = (1, 2, 4, 8)
REPS = 20  # work-list builds timed per sp


def page_table(batch: int, max_pages: int, n_pages: int, sp: int) -> np.ndarray:
    """The serving state: `batch` sequences of `max_pages` pages handed out
    in order from a shared pool (ownership interleaves across sequences as
    the allocator's does), skipping each rank's garbage page s * P_local."""
    ids = [p for p in range(n_pages) if p % (n_pages // sp) != 0]
    return np.asarray([[ids[(b * max_pages + i) % len(ids)] for i in range(max_pages)]
                       for b in range(batch)], np.int32)


def run(batch: int = 8, ctx: int = 2048, page_size: int = 128) -> dict:
    cfg = preset_config("llama2-7b")
    kv_lane = cfg.n_kv_heads * cfg.head_dim
    page_bytes = page_size * kv_lane * 2 * 2  # k and v, bf16
    max_pages = -(-ctx // page_size)
    rows = []
    for sp in SHARDS:
        n_pages = -(-(batch * max_pages + 1) // sp) * sp
        pt = page_table(batch, max_pages, n_pages, sp)
        sl = np.full((batch,), ctx, np.int32)
        t0 = time.perf_counter()
        for _ in range(REPS):
            *_, ni, _ = build_work_lists_sharded(pt, sl, page_size, sp, n_pages)
        host_ms = (time.perf_counter() - t0) / REPS * 1e3
        pages = ni[:, 0].tolist()
        per_shard = [int(n) * page_bytes * cfg.n_layers for n in pages]
        total = sum(per_shard)
        rows.append(dict(sp=sp, pages_per_shard=pages,
                         page_read_bytes_per_shard_per_step=per_shard,
                         max_shard_bytes=max(per_shard), total_bytes=total,
                         max_shard_fraction=round(max(per_shard) / total, 4),
                         build_work_lists_host_ms=round(host_ms, 3)))
        print(json.dumps(rows[-1]), file=sys.stderr)
    return dict(model="llama2-7b", batch=batch, ctx=ctx, page_size=page_size,
                kv_lane=kv_lane, n_layers=cfg.n_layers, page_bytes_per_layer=page_bytes,
                note="bytes are exact from the per-rank work lists the paged kernel "
                     "walks (parallel/seqpar.build_work_lists_sharded); host_ms is the "
                     "per-decode-chunk scheduler cost on this machine's CPU",
                rows=rows)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json-out", help="also write the dict to this path")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ctx", type=int, default=2048)
    ap.add_argument("--page-size", type=int, default=128)
    args = ap.parse_args(argv)
    out = run(args.batch, args.ctx, args.page_size)
    s = json.dumps(out, indent=2)
    print(s, flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(s + "\n")
    return out


if __name__ == "__main__":
    main()
