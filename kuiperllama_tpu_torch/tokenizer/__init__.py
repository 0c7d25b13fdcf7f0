"""Tokenizer loading with format autodetection.

Reference equivalent: model.cpp:153-177 create_encode_layer picks the
tokenizer class by compile-time #ifdef; here the file format decides:
  *.json        -> byte-level BPE (tokenizer.json, Llama-3/Qwen2.5)
  *.model       -> sentencepiece protobuf (Llama-2)
  *.bin / other -> llama2.c tokenizer.bin (tinyllamas)
"""

from __future__ import annotations

from .base import Tokenizer
from .bpe import BpeTokenizer
from .spm import Llama2cTokenizer, SentencePieceTokenizer


def load_tokenizer(path: str, family: str = "llama2", vocab_size: int = 32000) -> Tokenizer:
    if path.endswith(".json"):
        return BpeTokenizer.from_file(path, family=family)
    if path.endswith(".model"):
        return SentencePieceTokenizer.from_file(path)
    return Llama2cTokenizer.from_file(path, vocab_size=vocab_size)


__all__ = [
    "Tokenizer",
    "BpeTokenizer",
    "SentencePieceTokenizer",
    "Llama2cTokenizer",
    "load_tokenizer",
]
