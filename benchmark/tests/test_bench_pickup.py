"""A new configuration, traffic mix and per-layer metric are picked up from
new files and new entries alone: no file of the benchmark is edited."""

import hashlib
import json
import os

from benchmark.harness import spec

from conftest import TINY_GAP_LIMIT, run_cell


def _digests(d):
    out = {}
    for base, _, files in os.walk(d):
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tiny_root, tmp_path):
    import shutil

    root = str(tmp_path)
    shutil.copytree(os.path.join(tiny_root, "benchmark"), os.path.join(root, "benchmark"))
    before = _digests(os.path.join(root, "benchmark"))
    bdir = os.path.join(root, "benchmark")
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(bdir, "configs", "tiny-int8.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny-wide", intermediate_size=1536)
    with open(os.path.join(bdir, "configs", "tiny-wide.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bdir, "traffic", "tiny-chat-b1.json")) as f:
        tr = json.load(f)
    tr["prompt"]["median"] = 40
    with open(os.path.join(bdir, "traffic", "tiny-long.json"), "w") as f:
        json.dump(tr, f)
    with open(os.path.join(bdir, "limits", "tiny-wide.long.json"), "w") as f:
        json.dump({"max_logit_gap": {"limit": TINY_GAP_LIMIT}, "short_answers": {"limit": 0},
                   "unfinished": {"limit": 0}}, f)
    with open(os.path.join(bdir, "metrics", "requests_in_window.py"), "w") as f:
        f.write('LAYER = "load generator (benchmark/entries)"\nUNIT = "requests"\n'
                'MOVES = "output_tokens_per_s.b1"\nSOURCE = "host_clock"\n\n\n'
                'def read(ctx):\n    return len(ctx.run.reqs)\n')
    bench["configs"].append({"name": "tiny-wide", "source": "x", "reduced": [],
                             "file": "benchmark/configs/tiny-wide.json", "why": "x"})
    bench["workloads"].append({"name": "tiny-wide.long", "config": "tiny-wide",
                               "traffic": "tiny-long", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "requests_in_window", "unit": "requests",
                               "better": "higher", "source": "host_clock",
                               "layer": "load generator (benchmark/entries)",
                               "moves": "output_tokens_per_s.b1",
                               "workloads": ["tiny-wide.long"]})
    for m in bench["end_to_end"]:
        if m["name"].endswith(".b1"):
            m["workloads"].append("tiny-wide.long")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    cell = spec.load_cell("tiny-wide.long", root)
    assert cell.config["intermediate_size"] == 1536
    assert cell.traffic["prompt"]["median"] == 40
    assert [m.name for m in cell.per_layer][-1] == "requests_in_window"
    rc, res = run_cell(root, "tiny-wide.long", trace=1, seconds=1.0)
    assert rc == 0 and res["correct"]
    assert res["metrics"]["requests_in_window"]["value"] == res["attempted"]
    after = _digests(bdir)
    assert {k: v for k, v in after.items() if k in before} == before
