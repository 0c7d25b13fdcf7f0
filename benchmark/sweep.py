#!/usr/bin/env python3
"""The knee of an open-loop cell, found once on the card: the cell's
traffic at each of a list of arrival rates, one process, one set-up.

    python3 benchmark/sweep.py --workload <cell> --seed <n> --seconds <s> --rates 1,2,3

Each rate runs as a run of the cell does, its lead-in first (the traffic's
`lead_in_s`), so the window sees the loaded state. For each rate: requests
due in the window, requests completed in it (any, lead-in ones too) and
their rate, the backlog (requests due without a first token, lead-in ones
too) at the window's start, a third, two thirds and its end, and the 50th
and 95th percentile time to first token. The knee is the highest rate
whose completions keep up with its arrivals and whose backlog does not grow
over the window. The benchmark's own runs never run this.
"""

import json
import os
import sys


def backlog(reqs, t: float) -> int:
    return sum(1 for r in reqs if r.due <= t and (r.first is None or r.first > t))


def main(argv=None, device=None, root=None) -> int:
    import argparse

    import torch

    from benchmark.harness import spec, stats, trace
    from benchmark.harness.main import Setup
    from benchmark.harness.traffic import Schedule

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload, root or spec.ROOT)
    if device is None:
        if not torch.cuda.is_available():
            print("sweep.py needs a CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    rates = [float(r) for r in args.rates.split(",")]
    cell.traffic = dict(cell.traffic, rate_per_s=max(rates))
    tracer = trace.Tracer(False, args.seconds)
    su = Setup(cell, args.seed, args.seconds, device, tracer)
    for rate in rates:
        su.schedule = Schedule(dict(cell.traffic, rate_per_s=rate),
                               cell.config["vocab_size"], args.seed)
        run = su.drive(args.seconds, tracer)
        W = run.window_s
        done = run.extra["completed"]
        every = run.reqs + run.extra["lead_in"]
        ttft = [(r.first - r.due) * 1e3 for r in run.reqs if r.first is not None]
        print(json.dumps({
            "rate_per_s": rate, "window_s": W, "due": len(run.reqs),
            "completed": done, "completed_per_s": done / W,
            "output_tokens_per_s": run.delivered / W,
            "backlog": [backlog(every, W * k / 3) for k in (0, 1, 2, 3)],
            "ttft_p50_ms": stats.percentile(ttft, 50) if ttft else None,
            "ttft_p95_ms": stats.percentile(ttft, 95) if ttft else None,
            "unfinished": run.extra.get("unfinished")}), flush=True)
    return 0


if __name__ == "__main__":
    HERE = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(HERE))
    from benchmark.run import CACHE, CACHE_VARS

    for var, sub in CACHE_VARS.items():
        os.environ[var] = os.path.join(CACHE, sub)
    sys.exit(main())
