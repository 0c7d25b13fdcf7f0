"""The port's timing utilities (kuiperllama_tpu_torch/utils/profiling.py;
its spans are tests/test_torch_spans.py's), and the roofline probe's CLI
against the JAX tool's keys."""

import json
import os
import sys

import pytest
import torch

from test_torch_exp_kernel import load_jax_tool
from kuiperllama_tpu_torch.tools import roofline as tr
from kuiperllama_tpu_torch.utils import profiling as tp
from torch_threads import one_thread  # noqa: F401


def test_device_time_on_cpu_tensors_is_positive():
    a = torch.randn(64, 64)
    calls = []

    def fn(x):
        calls.append(x)
        return x @ x

    t = tp.device_time(fn, a, iters=5, reps=2)
    assert t > 0
    assert len(calls) == 1 + 10  # a warm-up call, then iters * reps


def test_device_time_rotates_variants():
    seen = []
    vs = [(torch.full((2,), float(i)),) for i in range(3)]
    tp.device_time(lambda v: seen.append(int(v[0])), variants=vs, iters=6)
    assert seen == [0, 0, 1, 2, 0, 1, 2]


def test_device_time_asked_for_the_card_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.device_time(lambda: None, device="cuda")


def test_l2_copies():
    assert tp.l2_copies(10, "cpu") == 1
    assert tp.l2_copies(65_536_000, "cuda") == 2
    assert tp.l2_copies(5_242_880, "cuda") == 20
    assert tp.l2_copies(10 ** 9, "cuda") == 1


def test_trace_writes_a_chrome_trace(tmp_path):
    with tp.trace(str(tmp_path)) as prof:
        torch.randn(32, 32) @ torch.randn(32, 32)
    assert any("mm" in e.key for e in prof.key_averages())
    with open(tmp_path / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_roofline_keys_are_jax_s(monkeypatch, capsys, tmp_path):
    jr = load_jax_tool("roofline")
    for probe in ("probe_read", "probe_gemv", "probe_mxu"):
        monkeypatch.setattr(jr, probe, lambda *a, **k: 1.0)
    monkeypatch.setattr(sys, "argv", ["roofline.py"])
    jr.main()
    want = json.loads(capsys.readouterr().out)
    out = tmp_path / "probe.json"
    got = tr.main(["--device", "cpu", "--read-mb", "2", "--gemv-k", "256",
                   "--gemv-n", "512", "--mxu-d", "64", "--json-out", str(out)])
    assert set(got) == set(want) | {"nvidia_smi"}
    assert got["device"] == "cpu" and got["nvidia_smi"] is None
    assert all(got[k] > 0 for k in want if k != "device")
    assert json.loads(capsys.readouterr().out) == got
    assert json.loads(out.read_text()) == got


def test_roofline_writes_no_file_unless_asked(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tr.main(["--device", "cpu", "--read-mb", "1", "--gemv-k", "64",
             "--gemv-n", "128", "--mxu-d", "32"])
    assert os.listdir(tmp_path) == []


def test_roofline_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would measure")
    with pytest.raises(SystemExit) as e:
        tr.main([])
    assert e.value.code not in (0, None)
