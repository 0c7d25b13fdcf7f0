"""Byte-level BPE tokenizer for Llama-3 / Qwen2.5 `tokenizer.json`.

A copy of the JAX package's tokenizer: the HF `tokenizers` runtime (the
exact tokenizer.json semantics), imported only when a file is loaded.

Family-specific special/stop tokens:
  llama3: bos <|begin_of_text|>, stop {<|end_of_text|>, <|eot_id|>}
  qwen2:  no bos, stop {<|im_end|>, <|endoftext|>}
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from .base import Tokenizer

_FAMILY_SPECIALS = {
    "llama3": dict(
        bos="<|begin_of_text|>",
        stops=("<|end_of_text|>", "<|eot_id|>"),
        add_bos=True,
    ),
    "qwen2": dict(bos=None, stops=("<|im_end|>", "<|endoftext|>"), add_bos=False),
    "llama2": dict(bos="<s>", stops=("</s>",), add_bos=True),
}


class BpeTokenizer(Tokenizer):
    def __init__(self, hf_tokenizer, family: str = "llama3"):
        self.tk = hf_tokenizer
        self.family = family
        spec = _FAMILY_SPECIALS.get(family, _FAMILY_SPECIALS["llama3"])
        self.default_bos = spec["add_bos"]
        self.bos_id = (
            self.tk.token_to_id(spec["bos"]) if spec["bos"] else -1
        )
        if self.bos_id is None:
            self.bos_id = -1
        self._stop_ids = {
            tid
            for tid in (self.tk.token_to_id(s) for s in spec["stops"])
            if tid is not None
        }
        self.eos_id = next(iter(self._stop_ids)) if self._stop_ids else -1

    @classmethod
    def from_file(cls, path: str, family: str = "llama3") -> "BpeTokenizer":
        from tokenizers import Tokenizer as HFTokenizer

        return cls(HFTokenizer.from_file(path), family)

    @property
    def stop_ids(self) -> set:
        return self._stop_ids

    @property
    def vocab_size(self) -> int:
        return self.tk.get_vocab_size()

    def encode(self, text: str, bos: Optional[bool] = None, eos: bool = False) -> List[int]:
        # Special tokens appearing IN the text (e.g. "<|eot_id|>") are
        # parsed to their ids, matching the reference's special-token regex
        # scan (tiktoken.h:167-186): HF `tokenizers` matches AddedTokens
        # during pre-tokenization regardless of add_special_tokens, which
        # only gates the post-processor template (we add bos ourselves).
        # Pinned by tests/test_tokenizer.py::test_bpe_special_tokens_in_text.
        ids = self.tk.encode(text, add_special_tokens=False).ids
        if bos is None:
            bos = self.default_bos
        if bos and self.bos_id >= 0:
            ids = [self.bos_id] + ids
        if eos and self.eos_id >= 0:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return self.tk.decode(list(ids), skip_special_tokens=True)

    def decode_token(self, token_id: int, prev_id: int = -1) -> str:
        return self.tk.decode([int(token_id)], skip_special_tokens=True)
