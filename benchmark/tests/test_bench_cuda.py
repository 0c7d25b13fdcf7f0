"""Tests on the card (marker `cuda`; they skip without one):

    python -m pytest benchmark/tests -m cuda -q

A short run of the cheapest cell through the command as the driver calls
it, and the weights made twice from one seed on the card."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import spec, weights

CELL = "qwen2.5-0.5b-bf16.chat-b1"


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_a_run_prints_a_correct_line_on_the_card():
    _card()
    env = dict(os.environ, BENCH_RUN="ignored")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELL,
                        "--seed", str(2 ** 31 + 99), "--seconds", "3", "--trace", "0"],
                       cwd=spec.ROOT, capture_output=True, text=True, timeout=900, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert set(res["metrics"]) == {"output_tokens_per_s.b1", "ttft_p95_ms.b1",
                                   "tpot_p95_ms.b1", "setup_s"}
    assert list(res)[-1] == "checks"


@pytest.mark.cuda
def test_weights_are_the_same_bytes_twice_on_the_card():
    import torch

    dev = _card()
    cfg = spec.load_json(os.path.join(spec.BENCH_DIR, "configs", "qwen2.5-7b-int8.json"))
    cfg = dict(cfg, num_hidden_layers=2)
    a = weights.make(cfg, 2 ** 31 + 3, dev)
    b = weights.make(cfg, 2 ** 31 + 3, dev)
    for n in ("wq", "w2"):
        assert torch.equal(a["layers"][n]["q"], b["layers"][n]["q"])
        assert torch.equal(a["layers"][n]["s"], b["layers"][n]["s"])
    assert torch.equal(a["tok_emb"], b["tok_emb"])
