"""The port's parallel tools against the JAX package's
(kuiperllama_tpu_torch/tools/{seqpar_bytes,scaling}.py, tools/{seqpar_bytes,
scaling}.py imported by path): seqpar_bytes' byte and page fields equal
the JAX tool's main() output (and the committed SEQPAR_r05.json) at the
default 7B geometry and at another; scaling on two gloo ranks on the CPU at
the tiny config counts exactly the analytic bill (`verified`), its analytic
fields equal collectives.analytic_decode_bill and the JAX tool's bill, no
TPU figure appears in its output, and --json-out writes only there."""

import json
import sys
from pathlib import Path

import pytest

from kuiperllama_tpu.config import preset_config as jpreset
from kuiperllama_tpu_torch.config import preset_config
from kuiperllama_tpu_torch.parallel.collectives import analytic_decode_bill
from kuiperllama_tpu_torch.tools import scaling, seqpar_bytes
from test_torch_exp_kernel import load_jax_tool
from torch_threads import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def _exact(out):
    """Every field but the host's milliseconds and the note."""
    rows = [{k: v for k, v in r.items() if k != "build_work_lists_host_ms"}
            for r in out["rows"]]
    return {**{k: v for k, v in out.items() if k not in ("rows", "note")}, "rows": rows}


@pytest.mark.parametrize("argv", [[], ["--batch", "3", "--ctx", "700", "--page-size", "64"]],
                         ids=["7b-default", "ragged"])
def test_seqpar_bytes_equals_the_jax_tool(argv, capsys, monkeypatch):
    jtool = load_jax_tool("seqpar_bytes")
    monkeypatch.setattr(sys, "argv", ["seqpar_bytes.py", *argv])
    jtool.main()
    want = json.loads(capsys.readouterr().out)
    got = seqpar_bytes.main(argv)
    assert json.loads(capsys.readouterr().out) == got
    assert _exact(got) == _exact(want)
    assert all(r["build_work_lists_host_ms"] > 0 for r in got["rows"])
    if not argv:
        committed = json.loads((REPO / "SEQPAR_r05.json").read_text())
        assert _exact(got) == _exact(committed)
        assert got["rows"][0]["total_bytes"] == 8_589_934_592


def test_scaling_on_two_gloo_ranks(tmp_path, capsys):
    out_path = tmp_path / "scaling.json"
    out = scaling.main(["--device", "cpu", "--world", "2", "--steps", "2",
                        "--json-out", str(out_path)])
    assert json.loads(out_path.read_text()) == out == json.loads(capsys.readouterr().out)
    assert list(tmp_path.iterdir()) == [out_path]
    counted = out["counted_collectives"]
    assert counted["verified"] is True
    assert [(r["dp"], r["tp"]) for r in out["rows"]] == [(1, 1), (1, 2), (2, 1)]
    assert all(r["measured_step_ms"] > 0 for r in out["rows"])
    proj = preset_config("llama2-7b")
    bill = analytic_decode_bill(proj, 2, 4)
    jtool = load_jax_tool("scaling")
    for r in out["rows"]:
        assert r["psum_bytes"] == bill["all-reduce"]["bytes"]
        assert r["all_gather_bytes"] == bill["all-gather"]["bytes"]
        assert r["collectives_per_step"] == (0 if r["tp"] == 1 else
                                             bill["all-reduce"]["count"] + 1)
        want = jtool.analytic(jpreset("llama2-7b"), r["tp"], B=2,
                              weight_bytes=scaling.weight_bytes(proj))
        assert (r["psum_bytes"], r["all_gather_bytes"], r["collectives_per_step"],
                r["weight_bytes_per_rank"]) == (
            want["psum_bytes"], want["all_gather_bytes"], want["collectives_per_step"],
            want["weight_bytes_per_chip"])
    # the projection is the H100's: no TPU figure, every input labelled
    text = json.dumps(out).lower()
    assert "v5e" not in text and "ici" not in text
    assert jtool.ICI_GBPS not in (out["link_GBps"], out["hbm_GBps"])
    assert jtool.HBM_GBPS != out["hbm_GBps"]
    assert "data sheet" in out["hbm_source"] and "data sheet" in out["link_source"]
    assert out["coll_latency_source"].startswith("assumed")
