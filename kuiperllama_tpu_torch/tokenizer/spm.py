"""SentencePiece BPE tokenizer, self-contained.

The reference links the sentencepiece C++ library (op/encode.cpp:24-56
SpeEncodeLayer). We instead parse the `.model` protobuf directly (minimal
proto3 wire-format reader — the schema is public: ModelProto field 1 is a
repeated SentencePiece{piece:1 string, score:2 float, type:3 enum}) and run
the greedy highest-score pair merge that SentencePiece BPE (and llama2.c)
uses. No external dependency. The merge runs in C++ (runtime/src/spm_bpe.cpp,
built with g++ at first use) where there is a g++, else in Python;
`merge_engine` says which.

Also reads the llama2.c `tokenizer.bin` flavor (score, length, bytes records)
used by karpathy tinyllamas checkpoints.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

from .base import Tokenizer

_SPACE = "▁"  # '▁'

# sentencepiece piece types
_NORMAL, _UNKNOWN, _CONTROL, _USER_DEFINED, _UNUSED, _BYTE = 1, 2, 3, 4, 5, 6


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message body."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:  # varint
            val, i = _read_varint(buf, i)
        elif wt == 1:  # 64-bit
            val = buf[i : i + 8]
            i += 8
        elif wt == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            val = buf[i : i + ln]
            i += ln
        elif wt == 5:  # 32-bit
            val = buf[i : i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def parse_model_proto(data: bytes):
    """Extract (pieces, scores, types) from a sentencepiece ModelProto."""
    pieces: List[str] = []
    scores: List[float] = []
    types: List[int] = []
    for field, wt, val in _iter_fields(data):
        if field == 1 and wt == 2:  # SentencePiece message
            piece, score, ptype = "", 0.0, _NORMAL
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:
                    piece = v2.decode("utf-8")
                elif f2 == 2:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3:
                    ptype = v2
            pieces.append(piece)
            scores.append(score)
            types.append(ptype)
    return pieces, scores, types


class SentencePieceTokenizer(Tokenizer):
    """Greedy score-BPE over a sentencepiece vocabulary (Llama-2 style)."""

    def __init__(self, pieces: List[str], scores: List[float],
                 types: Optional[List[int]] = None,
                 bos_id: int = 1, eos_id: int = 2, unk_id: int = 0,
                 add_dummy_prefix: bool = True):
        self.pieces = pieces
        self.scores = scores
        self.types = types or [_NORMAL] * len(pieces)
        self.piece_to_id: Dict[str, int] = {}
        for i, p in enumerate(pieces):
            self.piece_to_id.setdefault(p, i)
        self.bos_id, self.eos_id, self.unk_id = bos_id, eos_id, unk_id
        self.add_dummy_prefix = add_dummy_prefix
        self._byte_ids = {}
        for i, (p, t) in enumerate(zip(pieces, self.types)):
            if t == _BYTE and len(p) == 6 and p.startswith("<0x"):
                self._byte_ids[int(p[3:5], 16)] = i
        # the native merge engine where g++ built it; the Python loop stays
        # as the oracle and the merge without g++ (a source that does not
        # compile raises here)
        from ..runtime.native import SpmMergeEngine, available

        self._native = SpmMergeEngine(self.pieces, self.scores) if available() else None
        self.merge_engine = "python" if self._native is None else "native"

    @classmethod
    def from_file(cls, path: str, **kw) -> "SentencePieceTokenizer":
        with open(path, "rb") as f:
            pieces, scores, types = parse_model_proto(f.read())
        return cls(pieces, scores, types, **kw)

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    # ---- encode: greedy highest-score adjacent merge

    def _symbols_of(self, text: str) -> List[int]:
        """Initial symbol sequence: chars as piece ids, unknown chars as bytes."""
        ids: List[int] = []
        for ch in text:
            pid = self.piece_to_id.get(ch)
            if pid is not None:
                ids.append(pid)
            else:
                for b in ch.encode("utf-8"):
                    ids.append(self._byte_ids.get(b, self.unk_id))
        return ids

    def encode(self, text: str, bos: bool = True, eos: bool = False) -> List[int]:
        text = text.replace(" ", _SPACE)
        if self.add_dummy_prefix and not text.startswith(_SPACE):
            text = _SPACE + text
        ids = self._symbols_of(text)
        ids = self._merge_py(ids) if self._native is None else self._native.merge(ids)
        if bos:
            ids = [self.bos_id] + ids
        if eos:
            ids = ids + [self.eos_id]
        return ids

    def _merge_py(self, ids: List[int]) -> List[int]:
        # merge loop: repeatedly merge the adjacent pair whose concatenation is
        # the highest-score piece in the vocab
        while len(ids) >= 2:
            best_score, best_i, best_id = -1e10, -1, -1
            for i in range(len(ids) - 1):
                merged = self.pieces[ids[i]] + self.pieces[ids[i + 1]]
                mid = self.piece_to_id.get(merged)
                if mid is not None and self.scores[mid] > best_score:
                    best_score, best_i, best_id = self.scores[mid], i, mid
            if best_i < 0:
                break
            ids[best_i : best_i + 2] = [best_id]
        return ids

    # ---- decode

    def _piece_text(self, pid: int) -> bytes:
        if not 0 <= pid < len(self.pieces):
            return b""  # out-of-vocab id (e.g. model vocab > tokenizer vocab)
        t = self.types[pid]
        if t == _BYTE:
            return bytes([int(self.pieces[pid][3:5], 16)])
        if t in (_CONTROL, _UNKNOWN):
            return b""
        return self.pieces[pid].replace(_SPACE, " ").encode("utf-8")

    def decode(self, ids: Sequence[int]) -> str:
        out = b"".join(self._piece_text(int(i)) for i in ids)
        text = out.decode("utf-8", errors="replace")
        # sentencepiece strips the dummy-prefix space at sequence start
        if self.add_dummy_prefix and text.startswith(" "):
            text = text[1:]
        return text

    def decode_token(self, token_id: int, prev_id: int = -1) -> str:
        # llama2.c convention: strip the leading space only right after BOS
        raw = self._piece_text(int(token_id))
        text = raw.decode("utf-8", errors="replace")
        if prev_id == self.bos_id and text.startswith(" "):
            text = text[1:]
        return text


class Llama2cTokenizer(SentencePieceTokenizer):
    """karpathy llama2.c `tokenizer.bin`: {int32 max_len} then per token
    {float score, int32 len, bytes piece}. Used with tinyllamas .bin models."""

    @classmethod
    def from_file(cls, path: str, vocab_size: int = 32000, **kw):
        pieces, scores, types = [], [], []
        with open(path, "rb") as f:
            struct.unpack("<i", f.read(4))  # max_token_length, unused
            for i in range(vocab_size):
                hdr = f.read(8)
                if len(hdr) < 8:  # file smaller than the declared vocab
                    break
                score, ln = struct.unpack("<fi", hdr)
                raw = f.read(ln)
                try:
                    piece = raw.decode("utf-8")
                except UnicodeDecodeError:
                    piece = raw.decode("latin-1")
                # llama2.c stores pieces with real spaces + byte tokens as <0xXX>
                pieces.append(piece.replace(" ", _SPACE))
                scores.append(score)
                types.append(
                    _BYTE
                    if len(piece) == 6 and piece.startswith("<0x") and piece.endswith(">")
                    else _NORMAL
                )
        tok = cls(pieces, scores, types, **kw)
        # llama2.c stores bos/eos/unk as plain strings; mark them control so
        # decode skips them (llama2.c decode skips by id instead)
        for cid in (tok.bos_id, tok.eos_id):
            if 0 <= cid < len(types):
                tok.types[cid] = _CONTROL
        if 0 <= tok.unk_id < len(types):
            tok.types[tok.unk_id] = _UNKNOWN
        return tok
