"""ctypes bindings for the native runtime (C++ `.bin` loader and SPM merge
engine), a copy of kuiperllama_tpu/runtime/native.py with its sources
(`src/loader.cpp`, `src/spm_bpe.cpp`, byte for byte the JAX package's).

Each library is built with g++ at its first use into the port's `_build/`
(beside the CUDA kernels' libraries), under a name hashed from its source
and flags, written to a temporary file and renamed into place, so processes
that build at once never load a half-written library and an edited source
builds anew; `python -m kuiperllama_tpu_torch.ops.kernels.build --only
runtime` builds both ahead of time. Without g++ nothing is built:
`available()` is False and the tokenizer keeps its Python merge. A source
that g++ refuses raises, with the compiler's output (the JAX copy swallows
every build error).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_libs = {}


def gxx() -> Optional[str]:
    """The g++ to build with, None when there is none."""
    return shutil.which("g++")


def sources() -> List[Path]:
    """Every C++ source of the runtime (`src/*.cpp`), sorted."""
    return sorted(SRC_DIR.glob("*.cpp"))


def lib_path(src: Path) -> Path:
    """The library of `src`, named by a hash of its bytes and the flags."""
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build_library(src: Path) -> Optional[Path]:
    """The shared library of the C++ source `src`, built first if needed:
    None when there is no g++; RuntimeError with the compiler's output when
    the source does not compile."""
    out = lib_path(src)
    if out.exists():
        return out
    cxx = gxx()
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run([cxx, *GXX_FLAGS, str(src), "-o", str(tmp)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {src.name}:\n{res.stderr}")
    os.replace(tmp, out)
    return out


def _load(name: str):
    with _lock:
        if name not in _libs:
            path = build_library(SRC_DIR / f"{name}.cpp")
            _libs[name] = ctypes.CDLL(str(path)) if path else None
        return _libs[name]


def available() -> bool:
    """Both libraries are built (there is a g++)."""
    return _load("loader") is not None and _load("spm_bpe") is not None


# ---------------------------------------------------------------------------
# loader


class KtHeader(ctypes.Structure):
    _fields_ = [
        ("dim", ctypes.c_int32),
        ("hidden_dim", ctypes.c_int32),
        ("n_layers", ctypes.c_int32),
        ("n_heads", ctypes.c_int32),
        ("n_kv_heads", ctypes.c_int32),
        ("vocab_size", ctypes.c_int32),
        ("seq_len", ctypes.c_int32),
        ("group_size", ctypes.c_int32),
        ("tied", ctypes.c_int32),
        ("quantized", ctypes.c_int32),
        ("qkv_bias", ctypes.c_int32),
        ("body_offset", ctypes.c_int64),
        ("file_size", ctypes.c_int64),
    ]


def parse_header(path: str, quant_hint: int = -1) -> KtHeader:
    """Parse and validate a .bin header natively (ValueError on a malformed
    or truncated file). quant_hint: 1 v3, 0 v0, -1 by the body size."""
    lib = _load("loader")
    if lib is None:
        raise RuntimeError("native loader unavailable (no g++)")
    lib.kt_parse_header.restype = ctypes.c_int
    lib.kt_parse_header.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.POINTER(KtHeader)]
    h = KtHeader()
    rc = lib.kt_parse_header(path.encode(), quant_hint, ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"invalid checkpoint {path!r} (native rc={rc})")
    return h


class MappedFile:
    """Zero-copy read-only mmap of a checkpoint."""

    def __init__(self, path: str):
        lib = _load("loader")
        if lib is None:
            raise RuntimeError("native loader unavailable (no g++)")
        lib.kt_open.restype = ctypes.c_void_p
        lib.kt_open.argtypes = [ctypes.c_char_p]
        lib.kt_data.restype = ctypes.c_void_p
        lib.kt_data.argtypes = [ctypes.c_void_p]
        lib.kt_size.restype = ctypes.c_int64
        lib.kt_size.argtypes = [ctypes.c_void_p]
        lib.kt_close.restype = None
        lib.kt_close.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self._h = lib.kt_open(path.encode())
        if not self._h:
            raise OSError(f"cannot mmap {path!r}")

    def view(self):
        """The whole file as a read-only numpy uint8 view (zero copy)."""
        import numpy as np

        size = self._lib.kt_size(self._h)
        ptr = self._lib.kt_data(self._h)
        buf = (ctypes.c_uint8 * size).from_address(ptr)
        arr = np.frombuffer(buf, dtype=np.uint8)
        arr.flags.writeable = False
        return arr

    def close(self):
        if getattr(self, "_h", None):
            self._lib.kt_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


# ---------------------------------------------------------------------------
# BPE merge engine


class SpmMergeEngine:
    """Greedy score-BPE merges in C++: the Python merge's result, with a heap
    in place of its rescans."""

    def __init__(self, pieces: List[str], scores: List[float]):
        lib = _load("spm_bpe")
        if lib is None:
            raise RuntimeError("native merge engine unavailable (no g++)")
        lib.spm_create.restype = ctypes.c_void_p
        lib.spm_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
        ]
        lib.spm_merge.restype = ctypes.c_int32
        lib.spm_merge.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        lib.spm_destroy.restype = None
        lib.spm_destroy.argtypes = [ctypes.c_void_p]
        self._lib = lib
        raw = [p.encode("utf-8") for p in pieces]
        arr = (ctypes.c_char_p * len(raw))(*raw)
        lens = (ctypes.c_int32 * len(raw))(*[len(r) for r in raw])
        sc = (ctypes.c_float * len(scores))(*scores)
        self._h = lib.spm_create(arr, lens, sc, len(raw))

    def merge(self, ids: List[int]) -> List[int]:
        n = len(ids)
        if n <= 1:
            return list(ids)
        buf = (ctypes.c_int32 * n)(*ids)
        out_n = self._lib.spm_merge(self._h, buf, n)
        return list(buf[:out_n])

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.spm_destroy(self._h)
            self._h = None
