"""The port's KuiperModel facade (api.py) against the JAX package's on the
committed tinychar INT8 checkpoint, fp32 params (the JAX side on its XLA
matmul path): logits within 5e-3 of max|want| (the fast INT8 mode's bf16
rounding, summed in another order; tests/test_torch_decoder.py's limit),
and predict and greedy generate equal."""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kuiperllama_tpu.api import KuiperModel as JModel
from kuiperllama_tpu.ops.linear import set_use_pallas
from kuiperllama_tpu_torch.api import KuiperModel
from kuiperllama_tpu_torch.errors import InvalidArgument, ModelParseError, PathNotValid
from torch_threads import one_thread  # noqa: F401

CKPT = "checkpoints/tinychar/tinychar.q8.bin"
PROMPT_IDS = [1, 20, 33, 45, 60, 7, 90]


def _write_tok(path):
    """A llama2.c tokenizer file of 8 pieces (ids 0-2 are unk, bos, eos)."""
    pieces = [("<unk>", 0.0), ("\n<s>\n", 0.0), ("\n</s>\n", 0.0), (" ", -2.0),
              ("h", -3.0), ("i", -3.1), ("hi", -1.0), (" hi", -0.5)]
    with open(path, "wb") as f:
        f.write(struct.pack("<i", 16))
        for piece, score in pieces:
            raw = piece.encode("utf-8")
            f.write(struct.pack("<f", score) + struct.pack("<i", len(raw)) + raw)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    tok = str(tmp_path_factory.mktemp("api") / "tok.bin")
    _write_tok(tok)
    set_use_pallas(False)
    jm = JModel.from_checkpoint(CKPT, tok).init(dtype=jnp.float32, cache_len=128)
    tm = KuiperModel.from_checkpoint(CKPT, tok).init(dtype=torch.float32, device="cpu",
                                                     cache_len=128)
    yield jm, tm
    set_use_pallas(True)


def test_forward_and_predict_match_jax(models):
    jm, tm = models
    want = np.asarray(jm.forward(PROMPT_IDS))
    got = tm.forward(PROMPT_IDS).numpy()
    assert got.shape == want.shape == (len(PROMPT_IDS), tm.cfg.vocab_size)
    assert np.abs(got - want).max() <= 5e-3 * np.abs(want).max()
    for n in (1, 4, len(PROMPT_IDS)):
        assert tm.predict(PROMPT_IDS[:n]) == jm.predict(PROMPT_IDS[:n])


def test_generate_matches_jax(models):
    jm, tm = models
    assert tm.generate_ids(PROMPT_IDS, 20) == jm.generate_ids(PROMPT_IDS, 20)
    got, want = tm.generate("hi", max_new_tokens=12), jm.generate("hi", max_new_tokens=12)
    assert got.tokens == want.tokens and got.text == want.text
    assert got.prompt_tokens == want.prompt_tokens
    # predict agrees with generate's first (greedy) token
    assert got.tokens[0] == tm.predict(tm.encode("hi"))


def test_init_cache_dtype_matches_jax_generator(models):
    """init(cache_dtype=) builds the Generator's cache in that dtype: over a
    bf16 cache, greedy tokens equal the JAX Generator's over one."""
    from kuiperllama_tpu.serving.generate import Generator as JGenerator

    jm, _ = models
    tm = KuiperModel.from_checkpoint(CKPT).init(dtype=torch.float32, device="cpu",
                                                cache_len=128, cache_dtype=torch.bfloat16)
    jg = JGenerator(jm.cfg, jm.params, cache_len=128, cache_dtype=jnp.bfloat16)
    assert tm.generate_ids(PROMPT_IDS, 20) == jg.generate_ids(PROMPT_IDS, 20)[0]
    assert tm._generator._decode[1][0]["k"].dtype == torch.bfloat16


def test_tokenizer_and_embedding_match_jax(models):
    jm, tm = models
    assert tm.encode("hi hi") == jm.encode("hi hi")
    assert tm.decode([1, 6, 7]) == jm.decode([1, 6, 7])
    assert tm.is_sentence_ending(2) and not tm.is_sentence_ending(6)
    np.testing.assert_array_equal(tm.embedding([3, 9]).numpy(),
                                  np.asarray(jm.embedding([3, 9])))


def test_errors(tmp_path):
    with pytest.raises(PathNotValid):
        KuiperModel.from_checkpoint(str(tmp_path / "missing.bin"))
    with pytest.raises(ModelParseError, match="checkpoint/hf.py"):
        KuiperModel.from_checkpoint(str(tmp_path))
    with pytest.raises(PathNotValid):
        KuiperModel.from_checkpoint(CKPT, str(tmp_path / "missing.model"))
    with pytest.raises(InvalidArgument, match="init"):
        KuiperModel.from_checkpoint(CKPT).forward([1, 2])
