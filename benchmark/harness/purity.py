"""The check that the benchmark measures the PyTorch/CUDA port and nothing
of the JAX package beside it.

Module names are compared by their top-level part (before the first dot),
whole: `kuiperllama_tpu_torch` (the port) begins with `kuiperllama_tpu` (the
JAX package) and is allowed; `bench` and `tools` are the repository root's
JAX harness and JAX tools package."""

from __future__ import annotations

import ast
import os
import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "kuiperllama_tpu", "bench",
                       "tools"})


def top(name: str) -> str:
    return name.split(".", 1)[0]


def imported_names(source: str) -> set:
    """Top-level names of every absolute import in `source`."""
    out = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            out |= {top(a.name) for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(top(node.module))
    return out


def scan(directory: str, forbidden=FORBIDDEN) -> dict:
    """{relative path: forbidden names it imports} for every .py file under
    `directory` that imports any."""
    found = {}
    for base, _, files in os.walk(directory):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(base, f)
                with open(path) as fh:
                    bad = imported_names(fh.read()) & forbidden
                if bad:
                    found[os.path.relpath(path, directory)] = sorted(bad)
    return found


def loaded(forbidden=FORBIDDEN, modules=None) -> list:
    """Forbidden top-level names among the loaded modules."""
    modules = sys.modules if modules is None else modules
    return sorted({top(m) for m in modules} & forbidden)
