"""The port's bench matrix (kuiperllama_tpu_torch/tools/bench_matrix.py)
with `subprocess.run` stubbed: no bench runs.

  * its 13 tags and argv are the JAX tool's (tools/bench_matrix.py, imported
    by path), and every argv, with the `--device` the tool appends, parses
    with bench_torch.py's `parse_args`;
  * --only merges the re-run rows into the file's existing ones;
  * a failed child records its exit code and the tail of its stderr, a
    child that times out its stderr; the count excludes both;
  * --out is required; a path named as a committed matrix
    (BENCH_MATRIX_r0*.json), a path git tracks, and an existing file of a
    tree where git cannot answer (not a repository) are refused.
"""

import json
import subprocess

import pytest
import torch

import bench_torch
from kuiperllama_tpu_torch.tools import bench_matrix as bm
from test_torch_exp_kernel import load_jax_tool
from torch_threads import one_thread  # noqa: F401

CPU = torch.device("cpu")
REAL_RUN = subprocess.run


class FakeChildren:
    """Stands in for subprocess.run: git asks go to the real one; a bench
    child returns the canned result of its --model (a dict: one JSON line
    and exit 0; an int: that exit code, no line, a stderr)."""

    def __init__(self, results):
        self.results, self.calls = results, []

    def __call__(self, cmd, **kw):
        if cmd[0] == "git":
            return REAL_RUN(cmd, **kw)
        self.calls.append(cmd)
        res = self.results[cmd[cmd.index("--model") + 1]]
        if res == "timeout":
            raise subprocess.TimeoutExpired(cmd, kw["timeout"], stderr=b"slow child\n")
        if isinstance(res, int):
            return subprocess.CompletedProcess(cmd, res, "", "Traceback ...\nboom\n")
        return subprocess.CompletedProcess(cmd, 0, "log\n" + json.dumps(res) + "\n", "")


def test_configs_are_the_jax_tools():
    jtool = load_jax_tool("bench_matrix")
    assert bm.CONFIGS == jtool.CONFIGS and len(bm.CONFIGS) == 13


@pytest.mark.parametrize("tag", list(bm.CONFIGS))
def test_every_argv_parses_with_bench_torch(tag):
    args = bench_torch.parse_args([*bm.CONFIGS[tag], "--device", "cuda"])
    assert args.device == "cuda" and args.model == bm.CONFIGS[tag][1]


def test_only_merges_and_failures_are_diagnosable(tmp_path, monkeypatch, capsys):
    out = tmp_path / "matrix.json"
    fake = FakeChildren({"tinyllama-1.1b": {"value": 600.0, "launches_per_run": {"fused_decode": 127}},
                         "qwen2.5-0.5b": 3, "llama3.2-1b": "timeout",
                         "llama2-7b": {"value": 120.0, "launches_per_run": {"quant_gemv": 9}}})
    monkeypatch.setattr(bm.subprocess, "run", fake)
    res = bm.run(CPU, str(out), ["tinyllama_int8_b1", "qwen2.5-0.5b_fp_b1"])
    assert [c[c.index("--device") + 1] for c in fake.calls] == ["cpu", "cpu"]
    runs = json.loads(out.read_text())["runs"]
    assert runs["tinyllama_int8_b1"]["value"] == 600.0
    assert runs["tinyllama_int8_b1"]["_argv"] == bm.CONFIGS["tinyllama_int8_b1"]
    failed = runs["qwen2.5-0.5b_fp_b1"]
    assert failed["exit_code"] == 3 and "boom" in failed["stderr_tail"] and failed["error"]
    assert res["value"] == 1 and res["rows"] == {"tinyllama_int8_b1": True,
                                                 "qwen2.5-0.5b_fp_b1": False}
    assert res["launches"] == {"fused_decode": 127} and res["device"] == "cpu"
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res

    # a second run with --only: its rows replace theirs, the others stay
    res = bm.run(CPU, str(out), ["llama2-7b_int8_b1", "llama3.2-1b_int8_b1"])
    runs = json.loads(out.read_text())["runs"]
    assert set(runs) == {"tinyllama_int8_b1", "qwen2.5-0.5b_fp_b1",
                         "llama2-7b_int8_b1", "llama3.2-1b_int8_b1"}
    assert "slow child" in runs["llama3.2-1b_int8_b1"]["stderr_tail"]
    assert res["value"] == 2 and res["launches"] == {"quant_gemv": 9}


def test_out_is_required_and_tracked_paths_are_refused(tmp_path, monkeypatch):
    """In a repository of its own (the tool asks git from its ROOT), so the
    test holds wherever the checkout came from."""
    root = tmp_path / "repo"
    root.mkdir()
    committed = root / "BENCH_MATRIX_r05.json"
    tracked = root / "matrix.json"
    for f in (committed, tracked):
        f.write_text('{"runs": {}}')
    for cmd in (["git", "init", "-q"], ["git", "add", committed.name, tracked.name]):
        REAL_RUN(cmd, cwd=root, check=True, capture_output=True)
    monkeypatch.setattr(bm, "ROOT", str(root))
    fake = FakeChildren({})
    monkeypatch.setattr(bm.subprocess, "run", fake)
    with pytest.raises(SystemExit):
        bm.main(["--device", "cpu"])
    assert "named as a committed matrix" in bm.refusal(str(committed))
    assert "named as a committed matrix" in bm.refusal(str(tmp_path / "BENCH_MATRIX_r09.json"))
    assert "tracked by git" in bm.refusal(str(tracked))
    assert bm.refusal(str(root / "new.json")) is None
    assert bm.refusal(str(tmp_path / "outside.json")) is None
    for out in (committed, tracked):
        with pytest.raises(SystemExit, match="committed matrix|tracked by git"):
            bm.main(["--device", "cpu", "--out", str(out), "--only", "tinyllama_int8_b1"])
        assert out.read_text() == '{"runs": {}}'
    assert not fake.calls
    with pytest.raises(SystemExit, match="unknown tags"):
        bm.run(CPU, str(root / "new.json"), ["nope"])

    # a tree that is not a repository (a git archive), or no git at all: an
    # existing file is refused, a new one is written
    plain = tmp_path / "archive"
    plain.mkdir()
    kept = plain / "matrix.json"
    kept.write_text('{"runs": {}}')
    monkeypatch.setattr(bm, "ROOT", str(plain))
    monkeypatch.setenv("GIT_CEILING_DIRECTORIES", str(tmp_path))
    assert "cannot say" in bm.refusal(str(kept))
    assert bm.refusal(str(plain / "new.json")) is None

    def no_git(cmd, **kw):
        if cmd[0] == "git":
            raise FileNotFoundError("git")
        return fake(cmd, **kw)

    monkeypatch.setattr(bm.subprocess, "run", no_git)
    monkeypatch.setattr(bm, "ROOT", str(root))
    assert "cannot say" in bm.refusal(str(tracked))
    assert bm.refusal(str(root / "new.json")) is None
