"""Find one cell's pieces by name.

`BENCHMARK.json` (at the repository root) names the cell's configuration and
traffic mix; each lives in a file of its own under the benchmark folder:

  configs/<config>.json   the model configuration as it is run
  traffic/<traffic>.json  the traffic mix: entry point, loop, lengths
  limits/<cell>.json      the limits of the comparison that decides `correct`
  metrics/<metric>.py     one per-layer metric each (its reader)
  entries/<entry>.py      the driver of one entry point of the program
  layouts/<family>.py     what one model family's weights are and how they
                          are drawn from the seed
  adapters/<family>.py    the program's model configuration and weights of
                          one model family, built from the benchmark's own
  counts/<family>.py      the FLOP and byte arithmetic of one model family
  reference/<family>.py   the plain float32 reference of one model family

The family is the configuration's `benchmark.family`. A later cell,
configuration, model family or metric is a new file and a new entry in
`BENCHMARK.json`; no file here needs an edit for it.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Metric:
    """One metric of `BENCHMARK.json`, end to end or per layer; `reader` is
    the per-layer metric's module (None for an end-to-end one)."""

    name: str
    unit: str
    better: str
    source: str
    layer: Optional[str] = None
    moves: Optional[str] = None
    workloads: Optional[list] = None
    bound: Optional[float] = None
    reader: object = None


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    bench_dir: str = BENCH_DIR


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module of the benchmark loaded from its file (metric names carry
    dots, so they are not importable by name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up by name
    spec.loader.exec_module(mod)
    return mod


def family_module(kind: str, family: str, bench_dir: str = BENCH_DIR):
    """<kind>/<family>.py: kind is layouts, adapters, counts or reference."""
    return load_module(os.path.join(bench_dir, kind, f"{family}.py"),
                       f"bench_{kind}_{family.replace('.', '_')}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of `<root>/BENCHMARK.json` with its configuration,
    traffic, limits and the metrics it reports; the files lie in
    `<root>/benchmark/`."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    bench_dir = os.path.join(root, "benchmark")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"))
    limits = load_json(os.path.join(bench_dir, "limits", f"{name}.json"))
    e2e = [Metric(**m) for m in bench["end_to_end"] if _applies(m, name)]
    per_layer = []
    for m in bench["per_layer"]:
        if not _applies(m, name):
            continue
        reader = load_module(os.path.join(bench_dir, "metrics", f"{m['name']}.py"),
                             "bench_metric_" + m["name"].replace(".", "_"))
        per_layer.append(Metric(**m, reader=reader))
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer, bench_dir=bench_dir)


def load_entry(entry: str, bench_dir: str = BENCH_DIR):
    """entries/<entry>.py: the driver of one entry point of the program."""
    return load_module(os.path.join(bench_dir, "entries", f"{entry}.py"),
                       f"bench_entry_{entry}")
