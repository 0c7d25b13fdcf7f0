"""Fixtures of the benchmark's own tests: a copy of the benchmark in a
temporary root with tiny cells beside the real ones, so that a run goes end
to end on the CPU in seconds."""

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

# tiny cells beyond one for each cell of BENCHMARK.json: tiny cell ->
# (configuration, traffic, the real cell whose metrics it reports)
EXTRA_TINY_CELLS = {
    # the closed-loop engine mix of the left-out document-QA cell: it keeps
    # every slot full, which the half-batch fault needs
    "tiny-int8.rag": ("qwen2.5-7b-int8", "rag", "qwen2.5-7b-int8.serve"),
}
# the tiny cells' limit on the widest served-token gap: sound runs on the
# CPU read 0.028 to 0.150 over 8 seeds a cell, the controls (int4, fp8)
# 0.83 and more over 3
TINY_GAP_LIMIT = 0.4


def _load(path):
    with open(path) as f:
        return json.load(f)


def _dump(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def tiny_names(configs) -> dict:
    """{configuration: its tiny copy's name}: tiny-<the name's last part>
    (tiny-int8), or tiny-<the whole name> where an earlier configuration
    has that."""
    out = {}
    for c in configs:
        short = "tiny-" + c["name"].rsplit("-", 1)[-1]
        out[c["name"]] = "tiny-" + c["name"] if short in out.values() else short
    return out


def make_tiny_root(dst: str, src: str = ROOT) -> str:
    """A copy of `src`'s benchmark in `dst` with a tiny copy of each of its
    configurations, by its family's `tiny(config)` (layouts/<family>.py),
    and a tiny cell beside each of its cells (and EXTRA_TINY_CELLS)."""
    from benchmark.harness import spec

    src_bench = os.path.join(src, "benchmark")
    shutil.copytree(src_bench, os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("_cache", "__pycache__", "tests"))
    bench = _load(os.path.join(src, "BENCHMARK.json"))
    names = tiny_names(bench["configs"])
    for real, name in names.items():
        cfg = _load(os.path.join(src_bench, "configs", f"{real}.json"))
        layout = spec.family_module("layouts", cfg["benchmark"]["family"], src_bench)
        cfg = dict(layout.tiny(cfg), name=name)
        _dump(cfg, os.path.join(dst, "benchmark", "configs", f"{name}.json"))
        bench["configs"].append({"name": name, "source": cfg["source"],
                                 "file": f"benchmark/configs/{name}.json",
                                 "reduced": [], "why": "tiny, for tests"})
    cells = {f"{names[w['config']]}.{w['traffic']}": (w["config"], w["traffic"], w["name"])
             for w in bench["workloads"]}
    cells.update({k: v for k, v in EXTRA_TINY_CELLS.items() if v[0] in names})
    for cell, (real_cfg, traffic, real) in cells.items():
        tr = _load(os.path.join(src_bench, "traffic", f"{traffic}.json"))
        tr["prompt"].update(median=24, min=4, max=100)
        tr["output"].update(median=40, min=16, max=80)
        if "engine" in tr:
            tr["engine"].update(slots=4, max_len=256, chunk=8)
        if "generator" in tr:
            tr["generator"].update(cache_len=256, chunk=8)
        if "lead_in_s" in tr:
            tr["lead_in_s"] = 0.5
        if tr.get("rate_per_s"):
            tr["rate_per_s"] = 40.0  # enough to fill the tiny engine's slots
        tr["trace"] = {"start_share": 0.2, "slice_s": 0.3}
        tr["check"] = {"served_tokens": 200, "min_requests": 3, "max_requests": 6}
        tname = f"tiny-{traffic}"
        _dump(tr, os.path.join(dst, "benchmark", "traffic", f"{tname}.json"))
        bench["workloads"].append({"name": cell, "config": names[real_cfg],
                                   "traffic": tname, "chips": 1, "why": "tiny"})
        _dump({"max_logit_gap": {"limit": TINY_GAP_LIMIT}, "short_answers": {"limit": 0},
               "unfinished": {"limit": 0}},
              os.path.join(dst, "benchmark", "limits", f"{cell}.json"))
        for m in bench["per_layer"] + bench["end_to_end"]:
            if real in m.get("workloads", []):
                m["workloads"].append(cell)
    _dump(bench, os.path.join(dst, "BENCHMARK.json"))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture(autouse=True, scope="session")
def few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_cell(root, cell, seed=2 ** 31 + 11, seconds=1.5, trace=0):
    """main() on the CPU; returns (exit code, result dict or None)."""
    import contextlib
    import io

    import torch

    from benchmark.harness.main import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace)], device=torch.device("cpu"), root=root)
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
