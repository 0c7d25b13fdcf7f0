"""One run of one cell: set up, measure, check, print the result line.

  1. find the cell's configuration, traffic, limits and metrics by name;
  2. make the weights on the device from the seed and build the program's
     entry point from them;
  3. warm the graph keys the cell's traffic uses (set-up ends at the first
     due request);
  4. drive the traffic for the window; with --trace 1, profile a slice;
  5. check that no JAX module is loaded, read the memory peak, free the
     program, make the weights again and compare with the plain reference;
  6. print the compared numbers on stderr and the result as the last line
     of stdout.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

from benchmark.harness import check, purity, spec, stats, trace, weights
from benchmark.harness.readers import Context
from benchmark.harness.traffic import Schedule


def parse(argv):
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def end_to_end(run, setup_s: float) -> dict:
    """The four end-to-end quantities. Latencies are over every request due
    in the window; a request with no first token, or unfinished, is a miss.
    A metric of BENCHMARK.json named `<quantity>.<group>` (say,
    `ttft_p95_ms.engine`) reports its quantity under a bound of its own."""
    ttft, tpot = [], []
    for r in run.reqs:
        ttft.append((r.first - r.due) * 1e3 if r.first is not None else stats.MISS_MS)
        if r.finish is not None and r.first is not None and len(r.out) > 1:
            tpot.append((r.finish - r.first) * 1e3 / (len(r.out) - 1))
        else:
            tpot.append(stats.MISS_MS)
    return {"output_tokens_per_s": stats.rate(run.delivered, run.window_s),
            "ttft_p95_ms": stats.percentile(ttft, 95),
            "tpot_p95_ms": stats.percentile(tpot, 95),
            "setup_s": setup_s}


def power_limit_w():
    """The card's power limit in W by nvidia-smi, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _forbidden_loaded(when: str) -> bool:
    bad = purity.loaded()
    if bad:
        print(f"forbidden modules loaded {when}: {', '.join(bad)}", file=sys.stderr)
    return bool(bad)


class Setup:
    """One cell's set-up in this process: its files, the program's entry
    point built from the seed's weights and warmed, and the schedule."""

    def __init__(self, cell, seed: int, seconds: float, device, tracer):
        import torch

        from benchmark.harness import program

        self.cell, self.seed, self.device = cell, seed, device
        family = cell.config["benchmark"]["family"]
        self.entry = spec.load_entry(cell.traffic["entry"], cell.bench_dir)
        self.counts = spec.family_module("counts", family, cell.bench_dir)
        self.reference = spec.family_module("reference", family, cell.bench_dir)
        self.cuda = device.type == "cuda"
        self.sync = lambda: program.sync(device)
        self.schedule = Schedule(cell.traffic, cell.config["vocab_size"], seed)
        if self.cuda:
            torch.cuda.set_device(device)
            torch.cuda.init()
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        raw = weights.make(cell.config, seed, device, cell.bench_dir)
        self.sync()
        t1 = time.perf_counter()
        self.system = self.entry.build(cell, raw, device)
        del raw
        self.sync()
        t2 = time.perf_counter()
        lead = float(cell.traffic.get("lead_in_s", 0))
        self.entry.warm(self.system, self.schedule,
                        self.schedule.expected_requests(lead + seconds))
        tracer.warm(self.sync)
        self.sync()
        self.times = {"weights_s": t1 - t0, "build_s": t2 - t1,
                      "warm_s": time.perf_counter() - t2}

    def drive(self, seconds: float, tracer):
        run = self.entry.drive(self.system, self.schedule, seconds, tracer)
        run.slice = tracer.slice
        return run

    def pick(self, run) -> list:
        c = self.cell.traffic["check"]
        return check.pick(run.reqs, self.seed, c["served_tokens"], c["min_requests"],
                          c["max_requests"])

    def free(self):
        """Drop the program and its memory; the weights are made again for
        the reference."""
        import torch

        self.system = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()
        return weights.make(self.cell.config, self.seed, self.device,
                            self.cell.bench_dir)


def main(argv=None, t_start=None, device=None, root=spec.ROOT) -> int:
    """Exit code 0 with the result line printed; 2 without the card the
    cell asks for, 3 when the benchmark's own sources import JAX, 4 when a
    JAX module is loaded. `device` (tests only) skips the look for a card."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    found = purity.scan(root + "/benchmark")
    if found:
        print(f"benchmark sources import forbidden modules: {found}", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload, root)

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"{args.workload} needs {cell.chips} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    from benchmark.harness import program

    tracer = trace.Tracer(args.trace == 1, args.seconds, cell.traffic.get("trace"),
                          counters=program.counters)
    c = Setup(cell, args.seed, args.seconds, device, tracer)
    setup_s = time.perf_counter() - t_start
    print("set-up " + " ".join(f"{k} {v:.3f}" for k, v in c.times.items())
          + f" total {setup_s:.3f}", file=sys.stderr)
    run = c.drive(args.seconds, tracer)
    if _forbidden_loaded("after the window"):
        return 4
    cuda = c.cuda
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    misses = sum(1 for r in run.reqs if r.first is None or r.finish is None)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    out = {}
    if args.trace:
        ctx = Context(cell, run, c.counts)
        metrics = {}
        for m in cell.per_layer:
            v = m.reader.read(ctx)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
                if hasattr(m.reader, "detail"):
                    metrics[m.name].update(m.reader.detail(ctx))
        s = ctx.slice
        if s is not None:
            dev.update(busy_s=trace.busy_seconds(s), window_s=s.length_s,
                       slice_steps=s.last - s.first)
            out["breakdown"] = trace.breakdown(s)
        if cuda:
            dev["power_limit_w"] = power_limit_w()
    else:
        e2e = end_to_end(run, setup_s)
        metrics = {m.name: {"value": e2e[m.name.split(".")[0]], "unit": m.unit}
                   for m in cell.end_to_end}

    picked = c.pick(run)
    t_ref = time.perf_counter()
    raw = c.free()
    checks = check.compare(c.reference, cell.config, raw, picked, run.reqs,
                           run.extra.get("unfinished", 0), cell.limits)
    del raw
    if _forbidden_loaded("at the end"):
        return 4
    result = {"correct": check.passed(checks), "attempted": len(run.reqs),
              "failed": misses, "metrics": metrics, "device": dev, **out,
              "checks": checks}
    served = [t for r in picked for t in r.out]
    print(f"window {run.window_s:.3f} s, {len(run.steps)} steps, {len(run.reqs)} "
          f"requests, {run.delivered} tokens; reference: {len(picked)} requests, "
          f"{len(served)} served tokens ({len(set(served))} distinct), "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    for name, v in checks.items():
        print(f"check {name} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0
