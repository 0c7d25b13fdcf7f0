"""Greedy generation of the port against the JAX Generator: the same 24 new
tokens on the committed fixtures, both sides in their default fast mode with
fp32 activations (the JAX side with its Pallas kernels in interpret mode)."""

import os

import pytest

from kuiperllama_tpu.checkpoint.binfmt import load_bin as jload, write_v3 as jwrite_v3
from kuiperllama_tpu.fuse import fuse_params as jfuse
from kuiperllama_tpu.params import to_device as jto
from kuiperllama_tpu.serving.generate import Generator as JGenerator
from kuiperllama_tpu_torch.checkpoint.binfmt import load_bin, write_v0
from kuiperllama_tpu_torch.config import tiny_config
from kuiperllama_tpu_torch.fuse import fuse_params
from kuiperllama_tpu_torch.params import random_params, to_device
from kuiperllama_tpu_torch.serving.generate import Generator

ROOT = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
PROMPT = [1, 20, 33, 45, 60, 7, 90]


def _pair(path, family, cache_len=128):
    jc, jp = jload(path, family=family)
    tc, tp = load_bin(path, family=family)
    jgen = JGenerator(jc, jfuse(jto(jp)), cache_len=cache_len)
    tgen = Generator(tc, fuse_params(to_device(tp, device="cpu")),
                     cache_len=cache_len)
    return jgen, tgen


@pytest.mark.parametrize("rel,family,g", [
    ("tinychar/tinychar.bin", "llama2", None),
    ("tinychar/tinychar.q8.bin", "llama2", None),
    ("tinychar_qwen2/tinychar.q8.bin", "qwen2", None),
    ("tinychar_g256/tinychar.bin", "llama2", 256),
])
def test_greedy_tokens_equal_jax(tmp_path, rel, family, g):
    path = os.path.join(ROOT, rel)
    if g is not None:  # the g = 256 checkpoint is quantized here, from v0
        cfg, params = jload(path, family=family)
        path = str(tmp_path / "g256.q8.bin")
        jwrite_v3(path, cfg, params, group_size=g)
    jgen, tgen = _pair(path, family)
    want, _, _ = jgen.generate_ids(PROMPT, max_new_tokens=24)
    got, _, _ = tgen.generate_ids(PROMPT, max_new_tokens=24)
    assert len(got) == 24
    assert got == want


def test_batch_and_stop_ids_equal_jax():
    # a cache longer than the attention window: decode reads a view of the
    # cache's first 256 slots and writes through it
    jgen, tgen = _pair(os.path.join(ROOT, "tinychar/tinychar.q8.bin"), "llama2",
                       cache_len=512)
    prompts = [PROMPT, [1, 101, 32]]
    want, _, _ = jgen.generate_batch_ids(prompts, max_new_tokens=12,
                                         stop_ids={104})
    got, _, _ = tgen.generate_batch_ids(prompts, max_new_tokens=12,
                                        stop_ids={104})
    assert got == want
    assert any(len(r) < 12 for r in got)  # a stop token cut a row short


def test_tokens_reach_host_once_per_chunk():
    _, tgen = _pair(os.path.join(ROOT, "tinychar/tinychar.q8.bin"), "llama2")
    tgen.chunk = 8
    blocks = []
    ids, _, _ = tgen.generate_batch_ids([PROMPT], max_new_tokens=24,
                                        on_chunk=lambda b: blocks.append(b.shape))
    assert blocks == [(1, 1), (1, 8), (1, 8), (1, 7)]
    tgen.chunk = 64
    assert ids[0] == tgen.generate_ids(PROMPT, max_new_tokens=24)[0]


def test_sampling_is_seeded():
    _, tgen = _pair(os.path.join(ROOT, "tinychar/tinychar.q8.bin"), "llama2")
    kw = dict(max_new_tokens=10, temperature=1.0, top_k=20, top_p=0.9)
    a, _, _ = tgen.generate_ids(PROMPT, seed=1, **kw)
    b, _, _ = tgen.generate_ids(PROMPT, seed=1, **kw)
    c = [tgen.generate_ids(PROMPT, seed=s, **kw)[0] for s in range(2, 6)]
    assert a == b and len(a) == 10
    assert any(r != a for r in c)


def test_demo_cli_on_cpu(tmp_path, capsys):
    from test_tokenizer import _build_spm_model

    from kuiperllama_tpu_torch import demo

    cfg = tiny_config(vocab_size=22, seq_len=64)  # the spm fixture has 22 pieces
    write_v0(str(tmp_path / "m.bin"), cfg, random_params(cfg, seed=0))
    (tmp_path / "t.model").write_bytes(_build_spm_model())
    demo.main(["--model", str(tmp_path / "m.bin"), "--tokenizer",
               str(tmp_path / "t.model"), "--prompt", "hello world",
               "--steps", "6", "--device", "cpu", "--dtype", "f32"])
    out = capsys.readouterr()
    assert out.out.startswith("hello world")
    assert "steps/s" in out.err


def test_spm_tokenizer_copy_matches_jax(tmp_path):
    from test_tokenizer import _build_spm_model

    from kuiperllama_tpu.tokenizer import load_tokenizer as jload_tok
    from kuiperllama_tpu_torch.tokenizer import load_tokenizer

    path = str(tmp_path / "t.model")
    with open(path, "wb") as f:
        f.write(_build_spm_model())
    j, t = jload_tok(path), load_tokenizer(path)
    for text in ("hello world", "world hello", "hold", "ü"):
        ids = t.encode(text)
        assert ids == j.encode(text)
        assert t.decode(ids) == j.decode(ids)
    assert t.stop_ids == j.stop_ids
