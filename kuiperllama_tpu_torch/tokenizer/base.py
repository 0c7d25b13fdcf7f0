"""Tokenizer interface (reference: op/encode.h EncodeLayerBase —
encode/decode/is_sentence_ending/vocab_size)."""

from __future__ import annotations

from typing import List, Sequence


class Tokenizer:
    bos_id: int = -1
    eos_id: int = -1

    def encode(self, text: str, bos: bool = True, eos: bool = False) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int]) -> str:
        raise NotImplementedError

    def decode_token(self, token_id: int, prev_id: int = -1) -> str:
        """Streaming single-token decode (may return partial UTF-8 as '')."""
        return self.decode([token_id])

    def is_stop(self, token_id: int) -> bool:
        """reference: is_sentence_ending (encode.cpp:48/133)."""
        return token_id in self.stop_ids

    @property
    def stop_ids(self) -> set:
        return {self.eos_id}

    @property
    def vocab_size(self) -> int:
        raise NotImplementedError
