"""BENCHMARK.json against the rules every later check holds it to, and
each per-layer metric's file against its entry."""

import json
import os
import re

import pytest

from benchmark.harness import spec

with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
        "per_layer"}


def test_top_level_keys_and_size():
    assert set(BENCH) == KEYS
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(
            os.path.join(spec.ROOT, c["file"]))
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(spec.BENCH_DIR, "traffic", f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(spec.BENCH_DIR, "limits", f"{w['name']}.json"))
        names += [w["name"], w["config"], w["traffic"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names), names
    assert {w["config"] for w in BENCH["workloads"]} == {c["name"] for c in BENCH["configs"]}


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_file_matches_its_entry(m):
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    mod = spec.load_module(os.path.join(spec.BENCH_DIR, "metrics", f"{m['name']}.py"),
                           "t_" + m["name"].replace(".", "_"))
    assert (mod.LAYER, mod.UNIT, mod.MOVES, mod.SOURCE) == (
        m["layer"], m["unit"], m["moves"], m["source"])
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in m["workloads"]:
        assert w in cells
        assert "workloads" not in e2e[m["moves"]] or w in e2e[m["moves"]]["workloads"]


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        e2e = [m.name for m in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer


# keys that name a width, which a cut may never change
WIDTH = re.compile(r"(_dim|_rank)$|hidden_size|intermediate_size|latent|state_size|proj"
                   r"|head_size|expan|experts_per_tok")


def _holds_what_is_run(entry: dict, cfg: dict):
    """A configuration's file against its entry: the same name, source and
    `reduced`; each key in `reduced` no width, with its published value
    stated under `published` and run at another."""
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] and len(entry["reduced"]) <= 16
    published = cfg.get("published", {})
    for key in entry["reduced"]:
        assert NAME.match(key) and not WIDTH.search(key), key
        assert key in published and published[key] != cfg.get(key), key


def test_config_files_hold_what_is_run():
    for c in BENCH["configs"]:
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            cfg = json.load(f)
        _holds_what_is_run(c, cfg)
        for kind in ("layouts", "adapters", "counts", "reference"):
            assert os.path.exists(os.path.join(spec.BENCH_DIR, kind,
                                               cfg["benchmark"]["family"] + ".py")), kind


CUT = {"name": "m", "source": "s", "reduced": ["num_hidden_layers", "num_experts"],
       "num_hidden_layers": 8, "num_experts": 8, "hidden_size": 2304,
       "published": {"num_hidden_layers": 28, "num_experts": 64}}


@pytest.mark.parametrize("case,holds", [
    ("as published", True),
    ("listed in one place only", False),
    ("published value not stated", False),
    ("run at the published value", False),
    ("a width cut", False),
])
def test_a_cut_configuration_states_what_it_cut(case, holds):
    cfg = json.loads(json.dumps(CUT))
    entry = {k: cfg[k] for k in ("name", "source", "reduced")}
    if case == "listed in one place only":
        entry["reduced"] = ["num_hidden_layers"]
    elif case == "published value not stated":
        del cfg["published"]["num_experts"]
    elif case == "run at the published value":
        cfg["num_experts"] = 64
    elif case == "a width cut":
        for d in (cfg, entry):
            d["reduced"] = d["reduced"] + ["hidden_size"]
        cfg["published"]["hidden_size"], cfg["hidden_size"] = 2304, 1152
    if holds:
        _holds_what_is_run(entry, cfg)
    else:
        with pytest.raises(AssertionError):
            _holds_what_is_run(entry, cfg)
