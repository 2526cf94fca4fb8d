"""Reader for binary sentencepiece ``.model`` files (no sentencepiece dep);
the port's own copy of the JAX package's module of the same path.

The reference's subword mode loads a sentencepiece model trained by its
``util/generate_vocab_file.py``; users bring those ``.model`` assets with
them. A sentencepiece model is a
protobuf ``ModelProto`` whose only part needed for inference-side tokenization
is the repeated ``SentencePiece { piece: string = 1, score: float = 2,
type: enum = 3 }`` field (field number 1). This module parses exactly that
from the protobuf wire format (~no other fields are required: trainer/
normalizer specs are training-time metadata).

Segmentation: unigram Viterbi — the max-total-score segmentation of each
word under the piece scores, which is exactly sentencepiece's algorithm for
unigram models (its default type, and what the reference's vocab tool
produces). Characters with no piece fall back to ``<unk>``.
"""
from __future__ import annotations

import struct
from typing import List, Tuple

# SentencePiece.Type enum values (sentencepiece_model.proto)
TYPE_NORMAL = 1
TYPE_UNKNOWN = 2
TYPE_CONTROL = 3
TYPE_USER_DEFINED = 4
TYPE_UNUSED = 5
TYPE_BYTE = 6


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long (corrupt model file)")


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:  # varint
        _, pos = _read_varint(buf, pos)
    elif wire_type == 1:  # 64-bit
        pos += 8
    elif wire_type == 2:  # length-delimited
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire_type == 5:  # 32-bit
        pos += 4
    else:
        raise ValueError(f"unsupported protobuf wire type {wire_type}")
    if pos > len(buf):  # field body ran past the end: truncated message
        raise ValueError("truncated protobuf field")
    return pos


def _read_delimited(buf: bytes, pos: int) -> Tuple[bytes, int]:
    """Length-prefixed bytes; rejects a length past the buffer end (a bare
    slice would silently SHORTEN the field and mis-parse a truncated file)."""
    n, pos = _read_varint(buf, pos)
    if pos + n > len(buf):
        raise ValueError("truncated protobuf field")
    return buf[pos:pos + n], pos + n


def _parse_sentence_piece(buf: bytes) -> Tuple[str, float, int]:
    piece, score, ptype = "", 0.0, TYPE_NORMAL
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if field == 1 and wt == 2:  # piece
            raw, pos = _read_delimited(buf, pos)
            piece = raw.decode("utf-8")
        elif field == 2 and wt == 5:  # score (float32)
            score = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        elif field == 3 and wt == 0:  # type
            ptype, pos = _read_varint(buf, pos)
        else:
            pos = _skip_field(buf, pos, wt)
    return piece, score, ptype


def parse_model_proto(data: bytes) -> List[Tuple[str, float, int]]:
    """Return ``[(piece, score, type), ...]`` in model-id order.

    Raises ``ValueError`` on anything that is not a well-formed model —
    including truncation mid-varint (IndexError), a float field cut short
    (struct.error), or piece bytes that are not UTF-8 — so callers handing
    us a user-supplied file always get one exception type with a clear
    message (tests/test_sentencepiece.py fuzz cases).
    """
    pieces = []
    pos = 0
    try:
        while pos < len(data):
            key, pos = _read_varint(data, pos)
            field, wt = key >> 3, key & 7
            if field == 1 and wt == 2:  # repeated SentencePiece pieces
                sub, pos = _read_delimited(data, pos)
                pieces.append(_parse_sentence_piece(sub))
            else:
                pos = _skip_field(data, pos, wt)
    except (IndexError, struct.error, UnicodeDecodeError) as e:
        raise ValueError(
            f"corrupt or not a sentencepiece .model file ({e!r} at "
            f"byte ~{pos}/{len(data)})") from e
    if not pieces:
        raise ValueError("no sentence pieces found: not a sentencepiece "
                         ".model file?")
    return pieces


def serialize_model_proto(pieces: List[Tuple[str, float, int]]) -> bytes:
    """Inverse of :func:`parse_model_proto` (test fixtures + vocab tool)."""
    out = bytearray()
    for piece, score, ptype in pieces:
        sub = bytearray()
        pb = piece.encode("utf-8")
        sub += b"\x0a" + _varint(len(pb)) + pb          # field 1, wt 2
        sub += b"\x15" + struct.pack("<f", score)        # field 2, wt 5
        sub += b"\x18" + _varint(ptype)                  # field 3, wt 0
        out += b"\x0a" + _varint(len(sub)) + sub         # ModelProto field 1
    return bytes(out)


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


class SentencePieceVocab:
    """Unigram-Viterbi tokenizer over a parsed sentencepiece model."""

    BOUNDARY = "▁"  # ▁ word-boundary marker

    def __init__(self, pieces: List[Tuple[str, float, int]]):
        self.pieces = [p for p, _, _ in pieces]
        self.scores = [s for _, s, _ in pieces]
        self.types = [t for _, _, t in pieces]
        self._idx = {p: i for i, (p, _, t) in enumerate(pieces)
                     if t in (TYPE_NORMAL, TYPE_USER_DEFINED)}
        self._max_piece_len = max((len(p) for p in self._idx), default=1)
        unks = [i for i, t in enumerate(self.types) if t == TYPE_UNKNOWN]
        self.unk_id = unks[0] if unks else 2
        # sentencepiece gives <unk> a score below every real piece
        min_score = min((s for s, t in zip(self.scores, self.types)
                         if t == TYPE_NORMAL), default=0.0)
        self._unk_score = min_score - 10.0

    @classmethod
    def load(cls, path: str) -> "SentencePieceVocab":
        with open(path, "rb") as f:
            return cls(parse_model_proto(f.read()))

    def __len__(self) -> int:
        return len(self.pieces)

    def encode_word(self, word: str) -> List[int]:
        """Viterbi max-score segmentation of one ▁-prefixed word."""
        s = self.BOUNDARY + word
        n = len(s)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: List[Tuple[int, int]] = [(-1, -1)] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == NEG:
                continue
            hi = min(n, i + self._max_piece_len)
            for j in range(i + 1, hi + 1):
                pid = self._idx.get(s[i:j])
                if pid is not None:
                    sc = best[i] + self.scores[pid]
                    if sc > best[j]:
                        best[j], back[j] = sc, (i, pid)
            # unknown fallback: single character as <unk>
            sc = best[i] + self._unk_score
            if sc > best[i + 1]:
                best[i + 1], back[i + 1] = sc, (i, self.unk_id)
        ids = []
        j = n
        while j > 0:
            i, pid = back[j]
            ids.append(pid)
            j = i
        return ids[::-1]

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in text.split():
            ids.extend(self.encode_word(word))
        return ids
