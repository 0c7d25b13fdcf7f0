"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own into
`_build/lib<name>-<hash>.so` for sm_90a; the hash covers the source, the
shared headers (`csrc/*.cuh`) and the flags, so an edited source or header
rebuilds and an unchanged one is reused. Nothing
is built when the package is imported: a kernel's library is built at its
first launch, or ahead of time by `build()`, which starts one nvcc per
source, all at once.

Ahead of time, from the command line (the counterpart of the JAX package's
CMakeLists.txt): every `csrc/*.cu` and both native runtime libraries
(`runtime/src/*.cpp`, g++), under the names that first use looks up:

    python -m kuiperllama_tpu_torch.ops.kernels.build [--only {cuda,runtime}]

It prints a line per library (name, `built` or `cached`, seconds, path),
then one JSON line. Exit 2: the compiler of a half asked for is missing
(nothing is built); exit 1: a source did not compile (the compiler's
output follows on stderr, and no partial library is left).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ...runtime import native

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs: dict = {}


def nvcc() -> str:
    """The nvcc to build with: $CUDA_HOME/bin/nvcc, else the one on PATH,
    else /usr/local/cuda/bin/nvcc."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and Path(home, "bin", "nvcc").exists():
        return str(Path(home, "bin", "nvcc"))
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def nvcc_missing():
    """None when `nvcc()` exists, else what to tell the user."""
    path = nvcc()
    if Path(path).exists():
        return None
    return f"no nvcc at {path}: set CUDA_HOME to the CUDA toolkit, or put nvcc on PATH"


def sources() -> list:
    """The name of every `csrc/*.cu`, sorted."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def lib_path(name: str) -> Path:
    """The library of `csrc/<name>.cu`, named by a hash of the source, every
    `csrc/*.cuh` header (any source may include any of them) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names) -> dict:
    """Compile every named source that has no library yet, one nvcc process
    per source, all running at once. Returns {name: seconds from the start
    until its nvcc ended} for the ones built; raises RuntimeError with
    nvcc's output if any fails (its partial output is deleted), or when
    something is to build and there is no nvcc."""
    todo = [name for name in names if not lib_path(name).exists()]
    if not todo:
        return {}
    if nvcc_missing():
        raise RuntimeError(nvcc_missing())
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = lib_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, out)

    def finish(name):
        proc = procs[name][0]
        log = proc.communicate()[0].decode(errors="replace")
        return time.perf_counter() - t0, log

    with ThreadPoolExecutor(len(procs)) as pool:
        ended = dict(zip(procs, pool.map(finish, procs)))
    seconds, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        seconds[name], log = ended[name]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        _libs[name] = lib
    return lib


def entry(source: str, name: str, argtypes):
    """The C entry point `name` of `csrc/<source>.cu`, typed for ctypes; it
    returns a cudaError_t as an int."""
    fn = getattr(load(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    """Build every library ahead of time; see the module's docstring."""
    ap = argparse.ArgumentParser(
        prog="python -m kuiperllama_tpu_torch.ops.kernels.build",
        description="Build the CUDA kernels (csrc/*.cu, nvcc) and the native "
                    "runtime (runtime/src/*.cpp, g++) ahead of time.")
    ap.add_argument("--only", choices=("cuda", "runtime"),
                    help="build one half (default: both)")
    args = ap.parse_args(argv)
    cuda, runtime = args.only in (None, "cuda"), args.only in (None, "runtime")
    if cuda and nvcc_missing():
        print(f"build: {nvcc_missing()}; --only runtime builds the g++ half alone",
              file=sys.stderr)
        return 2
    if runtime and native.gxx() is None:
        print("build: no g++ on PATH; --only cuda builds the nvcc half alone",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    rows = []  # (name, seconds or None when cached, path)
    try:
        if runtime:
            for src in native.sources():
                out = native.lib_path(src)
                t = time.perf_counter()
                fresh = not out.exists()
                native.build_library(src)
                rows.append((src.stem, time.perf_counter() - t if fresh else None, out))
        if cuda:
            names = sources()
            seconds = build(names)
            rows += [(name, seconds.get(name), lib_path(name)) for name in names]
    except RuntimeError as e:
        print(f"build: {e}", file=sys.stderr)
        return 1
    for name, secs, path in rows:
        status = "cached" if secs is None else "built"
        print(f"{name:<20} {status:<6} {secs or 0.0:8.2f} s  {path}")
    print(json.dumps(dict(
        built={name: secs for name, secs, _ in rows if secs is not None},
        cached=[name for name, secs, _ in rows if secs is None],
        seconds=time.perf_counter() - t0, nvcc=nvcc() if cuda else None,
        gxx=native.gxx() if runtime else None, nvcc_flags=" ".join(NVCC_FLAGS))),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
