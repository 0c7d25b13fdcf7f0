"""The ahead-of-time build, `python -m kuiperllama_tpu_torch.ops.kernels.build`
(ops/kernels/build.py `main`), on the CPU with no CUDA toolkit.

  * `--only runtime` builds both g++ libraries (runtime/src/*.cpp) under the
    names `native._load` looks up; a second call builds nothing, and the
    loader then loads them without running a compiler.
  * The CUDA half runs through a fake nvcc reached by CUDA_HOME: every
    csrc/*.cu lands at `build.lib_path(name)`, and a second call builds
    nothing; a compiler that fails makes the command exit 1 with its output
    and leave no partial file (the g++ half likewise, on a broken source).
  * A missing compiler exits 2 before anything is built; the first-use
    build names the nvcc it tried.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from kuiperllama_tpu_torch.ops.kernels import build
from kuiperllama_tpu_torch.runtime import native

REPO = Path(__file__).resolve().parents[1]
needs_gxx = pytest.mark.skipif(native.gxx() is None, reason="needs g++")

NVCC_WRITES = """#!/bin/sh
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
printf 'fake library' > "$out"
"""
NVCC_FAILS = """#!/bin/sh
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
printf 'half a library' > "$out"
echo "fake_nvcc: error: expected a ';'"
exit 1
"""


def _fake_nvcc(tmp_path, monkeypatch, script):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    (bin_dir / "nvcc").write_text(script)
    (bin_dir / "nvcc").chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))


@pytest.fixture
def build_dirs(tmp_path, monkeypatch):
    """Both halves build into a directory of the test's own."""
    out = tmp_path / "_build"
    monkeypatch.setattr(build, "BUILD_DIR", out)
    monkeypatch.setattr(native, "BUILD_DIR", out)
    return out


def _run(capsys, *argv):
    """rc, {name: status} from the per-library lines, the JSON line, stderr."""
    rc = build.main(list(argv))
    cap = capsys.readouterr()
    lines = cap.out.splitlines()
    if rc != 0:
        return rc, {}, None, cap.err
    rows = {}
    for line in lines[:-1]:
        name, status, secs, unit, path = line.split()
        assert unit == "s" and float(secs) >= 0
        rows[name] = (status, Path(path))
    return rc, rows, json.loads(lines[-1]), cap.err


def test_sources_are_every_cu_and_cpp():
    assert build.sources() == sorted(p.stem for p in (REPO / "kuiperllama_tpu_torch"
                                                      / "csrc").glob("*.cu"))
    assert {"quant_gemv", "quant_gemm", "fused_decode", "fused_decode_chunk",
            "fused_decode_big", "paged_attention", "exp_kernel", "exp_int8"} <= set(
                build.sources())
    assert [p.name for p in native.sources()] == ["loader.cpp", "spm_bpe.cpp"]


@needs_gxx
def test_runtime_half_builds_then_caches_then_loads(build_dirs, capsys, monkeypatch):
    rc, rows, summary, _ = _run(capsys, "--only", "runtime")
    assert rc == 0
    assert {name: status for name, (status, _) in rows.items()} == {
        "loader": "built", "spm_bpe": "built"}
    for name, (_, path) in rows.items():
        assert path == native.lib_path(native.SRC_DIR / f"{name}.cpp")
        assert path.parent == build_dirs and path.exists()
    assert set(summary["built"]) == {"loader", "spm_bpe"} and summary["cached"] == []
    assert summary["nvcc"] is None and summary["gxx"] == native.gxx()

    rc, rows, summary, _ = _run(capsys, "--only", "runtime")
    assert rc == 0 and summary["built"] == {}
    assert {name: status for name, (status, _) in rows.items()} == {
        "loader": "cached", "spm_bpe": "cached"}

    def no_compiler(*args, **kwargs):
        raise AssertionError(f"rebuilt: {args}")

    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native.subprocess, "run", no_compiler)
    assert native.available()
    assert native._load("loader") is not None and native._load("spm_bpe") is not None


def test_cuda_half_through_a_fake_nvcc_builds_every_source_once(
        build_dirs, tmp_path, capsys, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch, NVCC_WRITES)
    rc, rows, summary, _ = _run(capsys, "--only", "cuda")
    assert rc == 0
    assert list(rows) == build.sources()
    for name, (status, path) in rows.items():
        assert status == "built" and path == build.lib_path(name)
        assert path.read_text() == "fake library"
    assert sorted(summary["built"]) == build.sources() and summary["cached"] == []
    assert summary["nvcc"] == str(tmp_path / "cuda" / "bin" / "nvcc")
    assert summary["nvcc_flags"] == " ".join(build.NVCC_FLAGS)
    assert sorted(p.name for p in build_dirs.iterdir()) == sorted(
        build.lib_path(n).name for n in build.sources())

    rc, rows, summary, _ = _run(capsys, "--only", "cuda")
    assert rc == 0 and summary["built"] == {}
    assert summary["cached"] == build.sources()
    assert {status for status, _ in rows.values()} == {"cached"}
    assert build.build(build.sources()) == {}


@pytest.mark.parametrize("half", ["cuda", "runtime"])
def test_a_compile_error_exits_1_with_the_output_and_no_partial_file(
        half, build_dirs, tmp_path, capsys, monkeypatch):
    if half == "cuda":
        _fake_nvcc(tmp_path, monkeypatch, NVCC_FAILS)
        said = "fake_nvcc: error: expected a ';'"
    else:
        if native.gxx() is None:
            pytest.skip("needs g++")
        src = tmp_path / "src"
        src.mkdir()
        (src / "broken.cpp").write_text('extern "C" int f() { return undeclared_name; }\n')
        monkeypatch.setattr(native, "SRC_DIR", src)
        said = "undeclared_name"
    rc, _, _, err = _run(capsys, "--only", half)
    assert rc == 1
    assert said in err and ("nvcc failed" if half == "cuda" else "g++ failed") in err
    assert not list(build_dirs.glob("lib*.so")) and not list(build_dirs.glob("*.tmp"))


@pytest.mark.parametrize("argv, missing", [
    ((), "nvcc"), (("--only", "cuda"), "nvcc"), (("--only", "runtime"), "g++")])
def test_a_missing_compiler_exits_2_and_builds_nothing(
        argv, missing, build_dirs, tmp_path, capsys, monkeypatch):
    tried = tmp_path / "no-cuda" / "bin" / "nvcc"
    monkeypatch.setattr(build, "nvcc", lambda: str(tried))
    if missing == "g++":
        monkeypatch.setattr(native, "gxx", lambda: None)
    rc, _, _, err = _run(capsys, *argv)
    assert rc == 2
    if missing == "nvcc":
        assert str(tried) in err and "CUDA_HOME" in err and "--only runtime" in err
    else:
        assert "no g++" in err
    assert not build_dirs.exists()


def test_first_use_names_the_nvcc_it_tried(build_dirs, tmp_path, monkeypatch):
    tried = tmp_path / "no-cuda" / "bin" / "nvcc"
    monkeypatch.setattr(build, "nvcc", lambda: str(tried))
    with pytest.raises(RuntimeError, match="no nvcc at .*CUDA_HOME"):
        build.build(["quant_gemv"])
    assert not build_dirs.exists()
    build_dirs.mkdir()
    build.lib_path("quant_gemv").write_text("built ahead of time")
    assert build.build(["quant_gemv"]) == {}  # a library present needs no nvcc


def test_the_command_runs_as_a_module():
    """`python -m` on the module: the package that holds it imports nothing
    (runpy would warn of a module run after its import)."""
    proc = subprocess.run(
        [sys.executable, "-m", "kuiperllama_tpu_torch.ops.kernels.build", "--help"],
        cwd=REPO, capture_output=True, text=True, timeout=60,
        env={**os.environ, "PYTHONWARNINGS": "error::RuntimeWarning"})
    assert proc.returncode == 0, proc.stderr
    assert "--only {cuda,runtime}" in proc.stdout and proc.stderr == ""
