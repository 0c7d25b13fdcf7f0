"""A new configuration, traffic mix, per-layer metric and model family are
picked up from new files and new entries alone: no file of the benchmark is
edited. And a stacked INT8 matrix (layers, experts) widens, and goes
through the control, as each of its matrices alone does."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from benchmark.harness import spec, weights
from benchmark.reference import lower

from conftest import BENCH, ROOT, TINY_GAP_LIMIT, make_tiny_root, run_cell


def _digests(d):
    out = {}
    for base, _, files in os.walk(d):
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tiny_root, tmp_path):
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


# A toy family: qwen2's decoder with each layer's two norm weights drawn as
# two factors each, which layouts/qwen2.py cannot draw. The adapter folds
# the factors into one weight for the program; the reference applies them
# one after the other.
TOY = {
    "layouts/toy.py": """
        import torch

        from benchmark.layouts import qwen2
        from benchmark.layouts.qwen2 import matrices, shapes, tiny  # noqa: F401

        NORMS = ("attn_norm", "ffn_norm")


        def draw(config, w):
            raw = qwen2.draw(config, w)
            s = shapes(config)
            for n in NORMS:
                del raw["layers"][n]
                for f in ("_a", "_b"):
                    raw["layers"][n + f] = w.normal((s["L"], s["d"]), 0.3,
                                                    torch.float32).add_(1.0)
            return raw
        """,
    "adapters/toy.py": """
        from benchmark.adapters import qwen2


        def model_config(config, seq_len):
            b = dict(config["benchmark"], family="qwen2")
            return qwen2.model_config(dict(config, benchmark=b), seq_len)


        def params(raw):
            Ly = raw["layers"]
            for n in ("attn_norm", "ffn_norm"):
                Ly[n] = Ly.pop(n + "_a") * Ly.pop(n + "_b")
            return qwen2.params(raw)
        """,
    "reference/toy.py": """
        import torch

        from benchmark.harness.weights import dequantize
        from benchmark.layouts.toy import shapes
        from benchmark.reference import qwen2 as q


        def norm(x, Ly, n, li, eps):
            return q.rmsnorm(x, Ly[n + "_a"][li].float(), eps) * Ly[n + "_b"][li].float()


        def layer(x, raw, li, s, cos, sin, weight):
            Ly = raw["layers"]
            w = {n: weight(Ly[n], li) for n in ("wq", "wk", "wv", "wo", "w1", "w3", "w2")}
            T, H, KH, hd = x.shape[0], s["H"], s["KH"], s["hd"]
            h = norm(x, Ly, "attn_norm", li, s["eps"])
            qv, k, v = h @ w["wq"], h @ w["wk"], h @ w["wv"]
            if s["bias"]:
                qv = qv + Ly["bq"][li].float()
                k = k + Ly["bk"][li].float()
                v = v + Ly["bv"][li].float()
            qv = q.rope(qv.view(T, H, hd), cos[:T], sin[:T])
            k = q.rope(k.view(T, KH, hd), cos[:T], sin[:T])
            x = x + q.attention(qv, k, v.view(T, KH, hd)).reshape(T, H * hd) @ w["wo"]
            h = norm(x, Ly, "ffn_norm", li, s["eps"])
            return x + (torch.nn.functional.silu(h @ w["w1"]) * (h @ w["w3"])) @ w["w2"]


        @torch.no_grad()
        def logits(config, raw, sequences, weight=dequantize):
            s = shapes(config)
            dev = raw["tok_emb"].device
            cos, sin = q.rope_tables(max(len(i) for i, _ in sequences), s["hd"],
                                     s["theta"], dev)
            out = []
            with q.exact_fp32():
                head = q.lm_head(raw, weight)
                for ids, pos in sequences:
                    x = raw["tok_emb"][torch.tensor(ids, device=dev)].float()
                    for li in range(s["L"]):
                        x = layer(x, raw, li, s, cos, sin, weight)
                    x = q.rmsnorm(x[torch.tensor(pos, device=dev)],
                                  raw["final_norm"].float(), s["eps"])
                    out.append(x @ head)
            return out
        """,
    "counts/toy.py": """
        from benchmark.counts.qwen2 import *  # noqa: F401,F403  the same work a step
        """,
}
TOY_CELL = "toy-bf16.chat-b1"


def _bench_files():
    """Digests of the benchmark's own files, as a copy of it holds them."""
    skip = ("tests" + os.sep, "_cache" + os.sep)
    return {k: v for k, v in _digests(BENCH).items()
            if not k.startswith(skip) and "__pycache__" not in k}


def _run_in(root, cell, seconds=1.0, trace=1):
    """main() of `root`'s own harness, in a process of its own on the CPU:
    what a checkout of `root` runs."""
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{root!r}, {ROOT!r}]
        import torch
        torch.set_num_threads(2)
        from benchmark.harness.main import main
        sys.exit(main(["--workload", {cell!r}, "--seed", "2147483659", "--seconds",
                       "{seconds}", "--trace", "{trace}"], device=torch.device("cpu"),
                      root={root!r}))
        """)
    p = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                       text=True, timeout=600)
    lines = p.stdout.strip().splitlines()
    return p, (json.loads(lines[-1]) if lines else None)


def test_a_new_family_runs_from_new_files_alone(tmp_path):
    src = str(tmp_path / "src")
    before = _bench_files()
    shutil.copytree(BENCH, os.path.join(src, "benchmark"),
                    ignore=shutil.ignore_patterns("_cache", "__pycache__", "tests"))
    bdir = os.path.join(src, "benchmark")
    for rel, body in TOY.items():
        with open(os.path.join(bdir, rel), "w") as f:
            f.write(textwrap.dedent(body).lstrip())
    with open(os.path.join(BENCH, "configs", "qwen2.5-0.5b-bf16.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "toy-bf16"
    cfg["benchmark"]["family"] = "toy"
    with open(os.path.join(bdir, "configs", "toy-bf16.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bdir, "limits", f"{TOY_CELL}.json"), "w") as f:
        json.dump({"max_logit_gap": {"limit": 2.6}, "short_answers": {"limit": 0},
                   "unfinished": {"limit": 0}}, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "toy-bf16", "source": cfg["source"], "reduced": [],
                             "file": "benchmark/configs/toy-bf16.json", "why": "toy"})
    bench["workloads"].append({"name": TOY_CELL, "config": "toy-bf16",
                               "traffic": "chat-b1", "chips": 1, "why": "toy"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "qwen2.5-0.5b-bf16.chat-b1" in m.get("workloads", []):
            m["workloads"].append(TOY_CELL)
    with open(os.path.join(src, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    root = make_tiny_root(str(tmp_path / "tiny"), src)
    tiny = spec.load_cell("tiny-toy-bf16.chat-b1", root)
    assert tiny.config["benchmark"]["family"] == "toy"
    assert tiny.config["hidden_size"] == 256
    p, res = _run_in(root, "tiny-toy-bf16.chat-b1")
    assert p.returncode == 0, p.stderr[-3000:]
    assert res["correct"], res["checks"]
    assert res["checks"]["max_logit_gap"]["value"] < TINY_GAP_LIMIT
    assert "mfu_pct.b1" in res["metrics"]  # counts/toy.py read
    after = _digests(os.path.join(root, "benchmark"))
    assert {k: after.get(k) for k in before} == before


def _stack(L=2, E=3, K=64, N=8, g=32, seed=5):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randint(-127, 128, (L, E, K, N), generator=gen, dtype=torch.int8)
    s = torch.rand((L, E, K // g, N), generator=gen).add_(0.5).to(torch.bfloat16)
    return {"q": q, "s": s, "g": g}


def test_a_stacked_int8_matrix_widens_expert_by_expert():
    w = _stack()
    L, E, K, N = w["q"].shape
    for li in range(L):
        got = weights.dequantize(w, li)
        assert got.shape == (E, K, N)
        for e in range(E):
            want = (w["q"][li, e].float()
                    * w["s"][li, e].float().repeat_interleave(w["g"], dim=0))
            assert torch.equal(got[e], want)
    assert torch.equal(weights.dequantize(w),
                       torch.stack([weights.dequantize(w, li) for li in range(L)]))


@pytest.mark.parametrize("stated", ["int8", "bfloat16"])
def test_the_control_of_a_stacked_matrix_is_that_of_each_expert(stated):
    w = _stack()
    if stated == "bfloat16":
        w = weights.dequantize(w).to(torch.bfloat16)
    config = {"benchmark": {"weights": stated, "group_size": 32}}
    low = lower.weight_fn(config)
    for li in range(w["q"].shape[0] if stated == "int8" else w.shape[0]):
        got = low(w, li)
        mats = weights.dequantize(w, li)
        for e in range(mats.shape[0]):
            want = (lower.int4_groups(mats[e], 32) if stated == "int8"
                    else lower.fp8_columns(mats[e]))
            assert torch.equal(got[e], want)
        assert not torch.equal(got, mats)
