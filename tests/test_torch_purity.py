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
BANNED = ("jax", "jaxlib", "kuiperllama_tpu")


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
            "assert 'triton' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
