"""The port's tokenizers (kuiperllama_tpu_torch/tokenizer) against the JAX
package's, the counterpart of tests/test_tokenizer.py: a sentencepiece
`.model`, a llama2.c `tokenizer.bin` and a byte-level BPE `tokenizer.json`,
each built by that file's helpers, give the same ids and decoded text on
both sides, specials and byte fallback included; special tokens typed into
the text parse to their ids. The BPE cases skip without `tokenizers`, as
the JAX package's do."""

import pytest

from kuiperllama_tpu.tokenizer import load_tokenizer as jload
from kuiperllama_tpu.tokenizer.spm import (Llama2cTokenizer as JLlama2c,
                                           SentencePieceTokenizer as JSpm,
                                           parse_model_proto as jparse)
from kuiperllama_tpu_torch.tokenizer import load_tokenizer
from kuiperllama_tpu_torch.tokenizer.spm import (Llama2cTokenizer, SentencePieceTokenizer,
                                                 parse_model_proto)
from test_tokenizer import _build_spm_model, _write_llama2c_bin

TEXTS = ["hello world", "hello", "world hello world", " hello", "h", "held word",
         "héllo", "", "hello  world"]


def _same(tok, jtok, texts, **kw):
    for text in texts:
        ids = tok.encode(text, **kw)
        assert ids == jtok.encode(text, **kw), text
        assert tok.decode(ids) == jtok.decode(ids), text
        prev = -1
        for i in ids:
            assert tok.decode_token(i, prev) == jtok.decode_token(i, prev)
            prev = i


def test_spm_model_matches_jax(tmp_path):
    path = tmp_path / "tok.model"
    path.write_bytes(_build_spm_model())
    assert parse_model_proto(path.read_bytes()) == jparse(path.read_bytes())
    tok, jtok = SentencePieceTokenizer.from_file(str(path)), JSpm.from_file(str(path))
    assert (tok.bos_id, tok.eos_id, tok.unk_id, tok.vocab_size) == (
        jtok.bos_id, jtok.eos_id, jtok.unk_id, jtok.vocab_size)
    for bos in (True, False):
        _same(tok, jtok, TEXTS, bos=bos)
    _same(tok, jtok, TEXTS, bos=True, eos=True)
    ids = tok.encode("hello world", bos=True)
    assert [tok.pieces[i] for i in ids[1:]] == ["▁hello", "▁world"]
    # 'é' has no piece: its bytes fall back to unk (only 0x68 exists)
    assert tok.encode("é", bos=False) == jtok.encode("é", bos=False)
    assert tok.is_stop(tok.eos_id) and jtok.is_stop(jtok.eos_id)
    assert type(tok) is type(load_tokenizer(str(path)))


def test_llama2c_bin_matches_jax(tmp_path):
    vocab = [("<unk>", 0.0), ("\n<s>\n", 0.0), ("\n</s>\n", 0.0),
             (" ", -2.0), ("h", -3.0), ("i", -3.1), ("hi", -1.0), (" hi", -0.5),
             ("<0x0A>", 0.0)]
    path = str(tmp_path / "tokenizer.bin")
    _write_llama2c_bin(path, vocab)
    tok = Llama2cTokenizer.from_file(path, vocab_size=len(vocab))
    jtok = JLlama2c.from_file(path, vocab_size=len(vocab))
    assert (tok.pieces, tok.types) == (jtok.pieces, jtok.types)
    _same(tok, jtok, ["hi", "hi hi", "h i", "ih", "hi\nhi"], bos=True)
    assert [tok.pieces[i] for i in tok.encode("hi", bos=True)[1:]] == ["▁hi"]
    # a vocab larger than the file reads what is there
    short = Llama2cTokenizer.from_file(path, vocab_size=100)
    assert short.pieces == JLlama2c.from_file(path, vocab_size=100).pieces
    assert type(load_tokenizer(path, vocab_size=len(vocab))) is Llama2cTokenizer


def _bpe_json(tmp_path):
    pytest.importorskip("tokenizers")
    from tokenizers import Tokenizer as HFTok, decoders, models, pre_tokenizers, trainers

    tk = HFTok(models.BPE(unk_token=None))
    tk.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tk.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=400,
        special_tokens=["<|begin_of_text|>", "<|end_of_text|>", "<|eot_id|>",
                        "<|im_end|>", "<|endoftext|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tk.train_from_iterator(["hello world", "the quick brown fox", "hello there"], trainer)
    path = str(tmp_path / "tokenizer.json")
    tk.save(path)
    return path


@pytest.mark.parametrize("family", ["llama3", "qwen2"])
def test_bpe_tokenizer_json_matches_jax(tmp_path, family):
    path = _bpe_json(tmp_path)
    tok, jtok = load_tokenizer(path, family=family), jload(path, family=family)
    assert (tok.bos_id, tok.eos_id, tok.stop_ids, tok.vocab_size) == (
        jtok.bos_id, jtok.eos_id, jtok.stop_ids, jtok.vocab_size)
    texts = ["hello world", "the quick brown fox", "héllo ünïcode", "hello there\n"]
    _same(tok, jtok, texts)
    _same(tok, jtok, texts, bos=False, eos=True)
    ids = tok.encode("hello world")
    assert tok.decode(ids) == "hello world"
    assert (ids[0] == tok.bos_id) == (family == "llama3")
    stop = "<|eot_id|>" if family == "llama3" else "<|im_end|>"
    assert tok.is_stop(tok.tk.token_to_id(stop)) and not tok.is_stop(ids[-1])


def test_bpe_special_tokens_in_text_match_jax(tmp_path):
    path = _bpe_json(tmp_path)
    tok, jtok = load_tokenizer(path, family="llama3"), jload(path, family="llama3")
    eot = tok.tk.token_to_id("<|eot_id|>")
    text = "hello<|eot_id|>world<|end_of_text|>"
    ids = tok.encode(text, bos=False)
    assert ids == jtok.encode(text, bos=False)
    assert eot in ids and len(ids) < len("hello<|eot_id|>world")
    assert tok.decode(ids) == jtok.decode(ids) == "helloworld"
