"""The port's native runtime (kuiperllama_tpu_torch/runtime/native.py, its
copies of the JAX package's loader.cpp and spm_bpe.cpp), the counterpart of
tests/test_native_runtime.py: parse_header on v0, v3 and Qwen-bias files
that the port's writer made equals the JAX package's native parse_header
and the header the port's binfmt reads; a truncated file is refused; the
mmap view is zero-copy; the native merge equals the Python oracle on 25
random texts; the libraries are built with g++ under a name hashed from
their source; a source that does not compile raises, with the compiler's
output; without g++ the tokenizer keeps its Python merge."""

import ctypes

import numpy as np
import pytest

from kuiperllama_tpu.runtime import native as jnative
from kuiperllama_tpu_torch.checkpoint.binfmt import load_bin, write_v0, write_v3
from kuiperllama_tpu_torch.config import tiny_config
from kuiperllama_tpu_torch.params import random_params
from kuiperllama_tpu_torch.runtime import native
from kuiperllama_tpu_torch.tokenizer.spm import SentencePieceTokenizer
from torch_threads import one_thread  # noqa: F401


# the port's libraries are built here; without g++ they cannot be
needs_gxx = pytest.mark.skipif(native.gxx() is None,
                               reason="no g++: the native runtime is not built")


@pytest.fixture
def jax_native():
    """The JAX package's native runtime, which these tests compare with."""
    if not jnative.available():
        pytest.skip("the JAX package's native runtime did not build")
    return jnative


def _fields(h):
    return {name: getattr(h, name) for name, _ in h._fields_}


@needs_gxx
@pytest.mark.parametrize("family,version,tied", [
    ("llama2", "v0", False), ("llama2", "v3", False), ("llama2", "v0", True),
    ("qwen2", "v0", True)], ids=["v0", "v3", "v0-tied", "qwen2-bias"])
def test_parse_header_matches_jax_and_binfmt(tmp_path, jax_native, family, version, tied):
    cfg = tiny_config(family, tied_embedding=tied)
    path = str(tmp_path / "m.bin")
    (write_v3 if version == "v3" else write_v0)(path, cfg, random_params(cfg, seed=0))
    h = native.parse_header(path)
    assert _fields(h) == _fields(jax_native.parse_header(path))
    got, _ = load_bin(path, family=family)
    assert (h.dim, h.hidden_dim, h.n_layers, h.n_heads, h.n_kv_heads, h.vocab_size,
            h.seq_len, bool(h.tied)) == (got.dim, got.hidden_dim, got.n_layers,
                                         got.n_heads, got.n_kv_heads, got.vocab_size,
                                         got.seq_len, got.tied_embedding)
    assert h.quantized == (version == "v3")
    assert h.group_size == (got.group_size or 0)
    assert h.body_offset == (32 if version == "v3" else 28)
    assert h.qkv_bias == (family == "qwen2")


@needs_gxx
def test_parse_header_rejects_truncated(tmp_path, jax_native):
    cfg = tiny_config("llama2")
    path = tmp_path / "t.bin"
    write_v0(str(path), cfg, random_params(cfg, seed=2))
    path.write_bytes(path.read_bytes()[:-100])
    with pytest.raises(ValueError):
        native.parse_header(str(path))
    with pytest.raises(ValueError):
        jax_native.parse_header(str(path))


@needs_gxx
def test_mmap_view_zero_copy(tmp_path):
    p = tmp_path / "blob.bin"
    payload = np.arange(1000, dtype=np.uint8)
    payload.tofile(p)
    f = native.MappedFile(str(p))
    view = f.view()
    np.testing.assert_array_equal(view, payload)
    assert not view.flags.writeable
    # the array reads the mapping itself: its first byte is at the mapped address
    assert view.ctypes.data == f._lib.kt_data(f._h)
    f.close()


@needs_gxx
def test_native_merge_matches_python_oracle_and_jax(rng, jax_native):
    from kuiperllama_tpu.tokenizer.spm import SentencePieceTokenizer as JaxSpm

    alphabet = list("abcd▁")
    pieces = ["<unk>", "<s>", "</s>"] + alphabet
    types = [2, 3, 3] + [1] * len(alphabet)
    seen = set(pieces)
    for ln in (2, 3, 4):
        for _ in range(40):
            cand = "".join(rng.choice(alphabet) for _ in range(ln))
            if cand not in seen:
                seen.add(cand)
                pieces.append(cand)
                types.append(1)
    scores = [0.0] * 3 + list(rng.uniform(-10, 0, len(pieces) - 3))
    tok = SentencePieceTokenizer(pieces, scores, types)
    jtok = JaxSpm(pieces, scores, types)
    assert tok.merge_engine == "native" and jtok._native is not None
    for _ in range(25):
        text = "".join(rng.choice(list("abcd ")) for _ in range(int(rng.integers(1, 60))))
        got = tok.encode(text, bos=False)
        prep = text.replace(" ", "▁")
        if not prep.startswith("▁"):
            prep = "▁" + prep
        assert got == tok._merge_py(tok._symbols_of(prep)) == jtok.encode(text, bos=False)
        assert tok.decode(got) in (text, text[1:] if text.startswith(" ") else text)


@needs_gxx
def test_libraries_are_named_by_their_source_hash():
    for name in ("loader", "spm_bpe"):
        src = native.SRC_DIR / f"{name}.cpp"
        out = native.build_library(src)
        assert out == native.lib_path(src) and out.exists()
        assert out.parent == native.BUILD_DIR and out.name.startswith(f"lib{name}-")
        assert isinstance(native._load(name), ctypes.CDLL)


@needs_gxx
def test_a_source_that_does_not_compile_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int f() { return undeclared_name; }\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native.build_library(bad)
    assert not list((tmp_path / "_build").iterdir())  # no library, no leftover


def test_without_gxx_the_python_merge_serves(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "gxx", lambda: None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_libs", {})
    assert not native.available()
    tok = SentencePieceTokenizer(["<unk>", "<s>", "</s>", "▁", "a", "▁a"],
                                 [0, 0, 0, -1, -2, -0.5], [2, 3, 3, 1, 1, 1])
    assert tok.merge_engine == "python" and tok.encode("a a", bos=False) == [5, 5]
