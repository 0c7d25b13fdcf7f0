#!/usr/bin/env python3
"""The readings a cell's correctness limit is set from, on the card: the
program's widest served-token gap under the float32 reference over many
seeds (the lower reading), and the control's, the reference with its
weights one precision below the configuration's (reference/lower.py), on
the same prompts and served tokens (the upper reading). The benchmark's own
runs never run this.

    python3 benchmark/control.py --workload <cell> --seconds <s> \\
        --seeds 1,2,... [--control-seeds 1,2,3]

Each seed sets the cell up as a run does, drives its traffic at the cell's
own load for --seconds, samples the finished requests as a run does, frees
the program and makes the weights again. Both sides go through the
harness's own comparison (`check.judge`) against the cell's limits: the
program with its served tokens, and for a control seed the control in its
place, with the token it puts first at every served position. Prints one
JSON line per seed, then a summary line.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None, device=None, root=None) -> int:
    import argparse

    import torch

    from benchmark.harness import check, spec, trace
    from benchmark.harness.main import Setup
    from benchmark.reference import lower

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    cell = spec.load_cell(args.workload, root or spec.ROOT)
    if device is None:
        if not torch.cuda.is_available():
            print("control.py needs a CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    prog, ctrl = [], []
    for seed in sorted(set(seeds) | controls):
        t0 = time.perf_counter()
        tracer = trace.Tracer(False, args.seconds)
        su = Setup(cell, seed, args.seconds, device, tracer)
        run = su.drive(args.seconds, tracer)
        picked = su.pick(run)
        raw = su.free()
        ref = check.reference_logits(su.reference, cell.config, raw, picked)
        unfinished = run.extra.get("unfinished", 0)
        row = {"seed": seed, "requests": len(picked),
               "served_tokens": sum(len(r.out) for r in picked),
               "attempted": len(run.reqs)}
        if seed in seeds:
            got = check.judge(ref, [r.out for r in picked], run.reqs, unfinished,
                              cell.limits)
            row["program_gap"] = got["max_logit_gap"]["value"]
            row["program_correct"] = check.passed(got)
            prog.append(row)
        if seed in controls:
            low = su.reference.logits(cell.config, raw, check.sequences(picked),
                                      weight=lower.weight_fn(cell.config))
            got = check.judge(ref, [lo.argmax(dim=-1).tolist() for lo in low],
                              run.reqs, unfinished, cell.limits)
            row["control_gap"] = got["max_logit_gap"]["value"]
            row["control_correct"] = check.passed(got)
            ctrl.append(row)
            del low
        del raw, ref
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    pg = [r["program_gap"] for r in prog]
    cg = [r["control_gap"] for r in ctrl]
    print(json.dumps({"workload": args.workload,
                      "limit": cell.limits["max_logit_gap"]["limit"], "seeds": len(pg), "lower": max(pg) if pg else None,
                      "program_correct": sum(r["program_correct"] for r in prog),
                      "control_seeds": len(cg), "upper": min(cg) if cg else None,
                      "control_correct": sum(r["control_correct"] for r in ctrl),
                      "program_gaps": sorted(pg), "control_gaps": sorted(cg)}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))
    from benchmark.run import CACHE, CACHE_VARS

    for var, sub in CACHE_VARS.items():
        os.environ[var] = os.path.join(CACHE, sub)
    sys.exit(main())
