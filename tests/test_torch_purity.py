"""The port imports neither JAX nor the JAX package.

This test process has JAX loaded already (conftest.py imports it), so a
sys.modules check here proves nothing: the scan reads every import
statement of the port's sources, and a fresh interpreter imports every
module of the port and then looks at sys.modules.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "kuiperllama_tpu_torch"
# `tools` is the repo-root package of JAX tools (tools/exp_diag.py imports
# it as `tools.*`); the port's own tools are kuiperllama_tpu_torch.tools.
BANNED = ("jax", "jaxlib", "kuiperllama_tpu", "tools")


def _modules(path: Path, pkg_parts):
    """Absolute names of every module an import statement in `path` names."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                yield node.module
                continue
            base = pkg_parts[: len(pkg_parts) - node.level + 1]
            yield ".".join(base + ([node.module] if node.module else []))


def _banned(name: str) -> bool:
    return name.split(".")[0] in BANNED


def _port_sources():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 15
    for f in files:
        rel = f.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        pkg = parts if f.name == "__init__.py" else parts[:-1]
        yield f, pkg


def test_no_jax_imports_in_port_sources():
    offenders = []
    for f, pkg in _port_sources():
        for name in _modules(f, pkg):
            if _banned(name):
                offenders.append(f"{f.relative_to(REPO)}: {name}")
    assert not offenders, offenders
    assert not [n for n in _modules(REPO / "chip_smoke.py", []) if _banned(n)]


def test_scan_covers_the_serving_slice():
    """The serving slice's modules are scanned; their imports of the
    decoder, engine and tokenizer sit inside functions, which the AST walk
    reads too."""
    scanned = {f.relative_to(PKG).as_posix() for f, _ in _port_sources()}
    assert {"api.py", "kvcache.py", "models/paged.py", "serving/engine.py",
            "serving/server.py", "ops/kernels/paged_attention.py"} <= scanned
    lazy = set(_modules(PKG / "serving" / "server.py", ["kuiperllama_tpu_torch", "serving"]))
    assert {"kuiperllama_tpu_torch.api", "kuiperllama_tpu_torch.serving.engine"} <= lazy


def test_relative_import_resolution():
    got = list(_modules(PKG / "ops" / "linear.py", ["kuiperllama_tpu_torch", "ops"]))
    assert "kuiperllama_tpu_torch.quant" in got
    assert "kuiperllama_tpu_torch.ops.kernels.quant_matmul" in got


def test_fresh_interpreter_imports_no_jax():
    names = []
    for f, pkg in _port_sources():
        if f.name == "__init__.py":
            names.append(".".join(pkg))
        else:
            names.append(".".join(pkg + [f.stem]))
    code = ("import importlib, sys\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{BANNED!r}]\n"
            "assert not bad, bad\n"
            "assert 'triton' not in sys.modules\n"
            "from kuiperllama_tpu_torch.ops.kernels import build\n"
            "assert not build._libs, build._libs\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_scan_covers_the_megakernel_routes():
    """The big-model and chunk megakernel routes and the knob table are
    scanned; the route knobs (KT_*) are read in ops/tuning.py and nowhere
    else in the port."""
    scanned = {f.relative_to(PKG).as_posix() for f, _ in _port_sources()}
    assert {"ops/tuning.py", "ops/kernels/fused_decode.py",
            "ops/kernels/fused_decode_big.py", "serving/generate.py"} <= scanned
    readers = {f.relative_to(PKG).as_posix() for f, _ in _port_sources()
               if "environ" in f.read_text() and "KT_" in f.read_text()}
    assert readers == {"ops/tuning.py"}


def test_scan_covers_the_measurement_tools():
    """The profiling module and the four tools are scanned; inside the
    port's tools package a relative import resolves to the port, and an
    absolute `tools.*` import (the JAX tools) is banned."""
    scanned = {f.relative_to(PKG).as_posix() for f, _ in _port_sources()}
    assert {"utils/profiling.py", "tools/roofline.py", "tools/exp_kernel.py",
            "tools/exp_int8.py", "tools/bench_kernels.py"} <= scanned
    got = set(_modules(PKG / "tools" / "exp_kernel.py", ["kuiperllama_tpu_torch", "tools"]))
    assert {"kuiperllama_tpu_torch.tools", "kuiperllama_tpu_torch.utils.profiling",
            "kuiperllama_tpu_torch.ops.kernels"} <= got
    assert not [n for n in got if _banned(n)]
    assert _banned("tools.roofline") and _banned("tools")
    assert not _banned("kuiperllama_tpu_torch.tools.roofline")


def test_scan_covers_the_user_facing_modules():
    """The HF loader, the perplexity gate and its tools, the exporter and
    the parity oracle are scanned, and so is bench_torch.py; transformers
    is imported inside hf_parity's main only, and no module reads
    PROBES.json or a TPU constant of bench.py."""
    scanned = {f.relative_to(PKG).as_posix() for f, _ in _port_sources()}
    assert {"checkpoint/hf.py", "evaluate.py", "tools/ppl.py", "tools/gate_group.py",
            "tools/export.py", "tools/hf_parity.py"} <= scanned
    bench = REPO / "bench_torch.py"
    assert not [n for n in _modules(bench, []) if _banned(n)]
    tree = ast.parse((PKG / "tools" / "hf_parity.py").read_text())
    top = {a.name.split(".")[0] for node in tree.body if isinstance(node, ast.Import)
           for a in node.names}
    top |= {node.module.split(".")[0] for node in tree.body
            if isinstance(node, ast.ImportFrom) and node.module}
    assert "transformers" not in top
    assert "transformers" in set(_modules(PKG / "tools" / "hf_parity.py",
                                          ["kuiperllama_tpu_torch", "tools"]))
    for path in [bench, *(PKG / p for p in ("evaluate.py", "tools/gate_group.py"))]:
        text = path.read_text()
        assert "PROBES.json" not in text and "_FALLBACK_PROBES" not in text
        assert "15.6" not in text and "819" not in text


def test_fresh_interpreter_imports_bench_torch_without_jax():
    code = ("import sys, bench_torch\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{BANNED!r}]\n"
            "assert not bad, bad\n"
            "assert 'triton' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_scan_covers_the_parallel_slice():
    """The parallel slice's modules are scanned, and what the gloo ranks of
    the CPU tests run (tests/torch_rank_cases.py, in processes that import
    only torch and the port) imports neither JAX nor the JAX package."""
    scanned = {f.relative_to(PKG).as_posix() for f, _ in _port_sources()}
    assert {f"parallel/{m}.py" for m in ("mesh", "collectives", "shardings", "sharded",
                                         "sharded_paged", "seqpar", "launch")} <= scanned
    cases = REPO / "tests" / "torch_rank_cases.py"
    assert not [n for n in _modules(cases, ["tests"]) if _banned(n)]


def test_scan_covers_the_native_runtime_and_parallel_tools():
    """The native runtime, the two parallel tools and the server are
    scanned (chip_smoke.py too, above); the runtime's C++ sources are byte
    copies of the JAX package's, and its bindings import nothing of it."""
    scanned = {f.relative_to(PKG).as_posix() for f, _ in _port_sources()}
    assert {"runtime/__init__.py", "runtime/native.py", "tools/scaling.py",
            "tools/seqpar_bytes.py", "serving/server.py"} <= scanned
    for name in ("loader.cpp", "spm_bpe.cpp"):
        port = PKG / "runtime" / "src" / name
        assert port.read_bytes() == (REPO / "kuiperllama_tpu" / "runtime" / "src"
                                     / name).read_bytes()
    for rel in ("runtime/native.py", "tools/scaling.py", "tools/seqpar_bytes.py",
                "serving/server.py", "tokenizer/spm.py"):
        parts = ["kuiperllama_tpu_torch", *Path(rel).parent.parts]
        assert not [n for n in _modules(PKG / rel, parts) if _banned(n)], rel
    assert "kuiperllama_tpu_torch.runtime.native" in set(
        _modules(PKG / "tokenizer" / "spm.py", ["kuiperllama_tpu_torch", "tokenizer"]))
