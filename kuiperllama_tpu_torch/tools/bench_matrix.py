#!/usr/bin/env python
"""The benchmark matrix: bench_torch.py over the JAX tool's 13
configurations, one artifact. Port of tools/bench_matrix.py.

Runs the repo-root `bench_torch.py` serially, one child process per
configuration (tags and argv as in the JAX tool; `--device` passed on),
collects each child's one-line JSON and writes them to --out, after every
row, merged into the rows the file already holds: `--only` re-runs some
tags and keeps the others. A failed row records its exit code and the tail
of its stderr. --out is required. The tool refuses a file named as the
committed matrices are (BENCH_MATRIX_r0*.json), one that git tracks, and
an existing file in the repository when git cannot say whether it tracks it
(no git, or a tree that is not a repository), so no committed matrix is
written over. The last line of
the output is one JSON dict: the count of rows without an error, the
device, and each kernel's launches summed over the rows' timed runs.

    python -m kuiperllama_tpu_torch.tools.bench_matrix --out FILE
        [--only tag,tag] [--timeout 900] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import os
import subprocess
import sys
import time

from . import add_device_arg, device_name, resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "bench_torch.py")
COMMITTED = "BENCH_MATRIX_r0*.json"

# tag -> bench_torch.py argv: the JAX tool's list, argv kept identical
CONFIGS = {
    "llama2-7b_int8_b1": ["--model", "llama2-7b"],
    "llama2-7b_int8_g64_b1": ["--model", "llama2-7b", "--group", "64",
                              "--no-selftest"],
    "llama2-7b_int8_b8": ["--model", "llama2-7b", "--batch", "8",
                          "--no-selftest"],
    "tinyllama_int8_b1": ["--model", "tinyllama-1.1b", "--no-selftest"],
    "tinyllama_fp_b1": ["--model", "tinyllama-1.1b", "--fp", "--no-selftest"],
    "llama3.2-1b_int8_b1": ["--model", "llama3.2-1b", "--no-selftest"],
    "llama3-8b_int8_b1": ["--model", "llama3-8b", "--no-selftest"],
    "qwen2.5-0.5b_fp_b1": ["--model", "qwen2.5-0.5b", "--fp",
                           "--no-selftest"],
    "engine_paged_8slots": ["--model", "llama2-7b", "--engine",
                            "--no-selftest"],
    "engine_paged_poisson": ["--model", "llama2-7b", "--engine",
                             "--arrival-rate", "4", "--requests", "24",
                             "--no-selftest"],
    "engine_paged_chunked_ragged": [
        "--model", "llama2-7b", "--engine", "--prefill-chunk", "128",
        "--long-prompt", "512", "--cache-len", "2048", "--batch", "4",
        "--requests", "8", "--no-selftest"],
    "engine_dense_longctx": [
        "--model", "llama2-7b", "--engine", "--engine-backend", "dense",
        "--prompt-len", "1500", "--long-prompt", "0", "--cache-len", "2048",
        "--steps", "64", "--requests", "8", "--batch", "4", "--no-selftest"],
    "engine_paged_longctx": [
        "--model", "llama2-7b", "--engine", "--engine-backend", "paged",
        "--prompt-len", "1500", "--long-prompt", "0", "--cache-len", "2048",
        "--steps", "64", "--requests", "8", "--batch", "4", "--no-selftest"],
}


def refusal(path: str):
    """Why --out may not be written, or None: its name is a committed
    matrix's, git tracks it, or git cannot answer for an existing file of
    the repository. A path outside the repository is never refused."""
    path = os.path.abspath(path)
    if fnmatch.fnmatch(os.path.basename(path), COMMITTED):
        return f"{path} is named as a committed matrix ({COMMITTED})"
    if os.path.commonpath([path, ROOT]) != ROOT:
        return None
    try:
        # exit 0: tracked; 1: not tracked; anything else: no answer
        rc = subprocess.run(["git", "-C", ROOT, "ls-files", "--error-unmatch", "--", path],
                            capture_output=True, text=True, timeout=60).returncode
    except (OSError, subprocess.TimeoutExpired):
        rc = None
    if rc == 0:
        return f"{path} is tracked by git"
    if rc != 1 and os.path.exists(path):
        return f"git cannot say whether it tracks {path}"
    return None


def run_row(argv, device: str, timeout: int) -> dict:
    """bench_torch.py with `argv` in a child: its JSON line, or (a failed
    row must be diagnosable from the artifact alone) the error, the exit
    code and the tail of its stderr."""
    try:
        proc = subprocess.run([sys.executable, BENCH, *argv, "--device", device],
                              capture_output=True, text=True, timeout=timeout,
                              cwd=ROOT)
    except subprocess.TimeoutExpired as e:
        stderr = e.stderr.decode(errors="replace") if isinstance(e.stderr, bytes) else e.stderr
        return {"error": repr(e)[:500], "stderr_tail": (stderr or "")[-2000:]}
    lines = proc.stdout.strip().splitlines()
    try:
        rec = json.loads(lines[-1]) if lines and proc.returncode == 0 else None
    except ValueError as e:
        rec, error = None, repr(e)[:500]
    else:
        error = f"exit code {proc.returncode}" if rec is None else None
    if rec is None:
        return {"error": error, "exit_code": proc.returncode,
                "stderr_tail": proc.stderr[-2000:]}
    return rec


def run(dev, out_path: str, only=None, timeout: int = 900) -> dict:
    why = refusal(out_path)
    if why:
        raise SystemExit(f"bench_matrix: {why}; write the matrix to a new file")
    results = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f).get("runs", {})
    tags = only or list(CONFIGS)
    unknown = [t for t in tags if t not in CONFIGS]
    if unknown:
        raise SystemExit(f"bench_matrix: unknown tags {unknown}; known: {list(CONFIGS)}")
    for tag in tags:
        argv = CONFIGS[tag]
        t0 = time.time()
        print(f"[matrix] {tag}: bench_torch.py {' '.join(argv)}", file=sys.stderr)
        rec = run_row(argv, dev.type, timeout)
        rec["_argv"] = argv
        rec["_wall_s"] = round(time.time() - t0, 1)
        results[tag] = rec
        print(f"[matrix] {tag}: " + json.dumps(
            {k: v for k, v in rec.items() if not k.startswith("_") and k != "probes"}),
            file=sys.stderr)
        # persist after each row, so a timeout keeps the earlier ones
        with open(out_path, "w") as f:
            json.dump({"generated_unix": int(time.time()), "runs": results}, f,
                      indent=1)
    launches = {}
    for tag in tags:
        for k, n in results[tag].get("launches_per_run", {}).items():
            launches[k] = launches.get(k, 0) + n
    out = {"metric": "bench matrix configs completed",
           "value": sum(1 for r in results.values() if "error" not in r),
           "unit": "configs", "vs_baseline": 0.0, "out": out_path,
           "rows": {t: "error" not in results[t] for t in tags},
           "device": device_name(dev), "launches": launches}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(ap)
    ap.add_argument("--out", required=True,
                    help="the matrix's JSON file (not a committed one)")
    ap.add_argument("--only", default=None, help="comma-separated tags to (re)run")
    ap.add_argument("--timeout", type=int, default=900)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    return run(dev, args.out, args.only.split(",") if args.only else None,
               args.timeout)


if __name__ == "__main__":
    main()
