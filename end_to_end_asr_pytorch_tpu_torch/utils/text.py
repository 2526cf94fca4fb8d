"""Tokenizers: character and word encoders (the port's own copy).

Index contract shared with the JAX package and the reference:

    0 = <pad>   (also the CTC blank and the cross-entropy ignore_index)
    1 = <eos>   (doubles as the decoder's <sos> start token)
    2 = <unk>

``decode(idxs, ignore_repeat=True)`` performs CTC collapse (merge repeats,
drop blanks). Subword / sentencepiece vocabularies are not ported yet.
"""
from __future__ import annotations

import abc
from typing import List, Sequence

PAD_IDX = 0
EOS_IDX = 1  # also used as <sos>
UNK_IDX = 2


class TextEncoder(abc.ABC):
    RESERVED = ["<pad>", "<eos>", "<unk>"]

    @property
    @abc.abstractmethod
    def vocab_size(self) -> int: ...

    @abc.abstractmethod
    def encode(self, text: str) -> List[int]:
        """Text -> token ids, with <eos> appended."""

    @abc.abstractmethod
    def _id_to_piece(self, idx: int) -> str: ...

    def decode(self, idxs: Sequence[int], ignore_repeat: bool = False) -> str:
        """Ids -> text. ``ignore_repeat=True`` applies CTC collapse:
        consecutive duplicates merged, then blanks (=pad=0) dropped."""
        crop = []
        prev = None
        for i in idxs:
            i = int(i)
            if i == EOS_IDX:
                break
            if ignore_repeat and prev is not None and i == prev:
                continue
            prev = i
            if i == PAD_IDX:
                continue
            crop.append(i)
        return self._join([self._id_to_piece(i) for i in crop])

    def _join(self, pieces: List[str]) -> str:
        return "".join(pieces)


class CharacterTextEncoder(TextEncoder):
    """One id per character. Vocab file: one char per line ('<space>' for ' ')."""

    def __init__(self, vocab_list: List[str]):
        if vocab_list[:3] != self.RESERVED:
            raise ValueError("vocab must start with <pad> <eos> <unk>")
        self._vocab = vocab_list
        self._idx = {tok: i for i, tok in enumerate(vocab_list)}

    @classmethod
    def load_from_file(cls, vocab_file: str) -> "CharacterTextEncoder":
        with open(vocab_file, "r", encoding="utf-8") as f:
            chars = [ln.rstrip("\n") for ln in f if ln.rstrip("\n")]
        return cls(cls.RESERVED + [c for c in chars if c not in cls.RESERVED])

    @property
    def vocab_size(self) -> int:
        return len(self._vocab)

    def encode(self, text: str) -> List[int]:
        ids = [self._idx.get("<space>" if c == " " else c, UNK_IDX) for c in text]
        return ids + [EOS_IDX]

    def _id_to_piece(self, idx: int) -> str:
        tok = self._vocab[idx]
        return " " if tok == "<space>" else tok


class WordTextEncoder(TextEncoder):
    """One id per whitespace-separated word. Vocab file: one word per line."""

    def __init__(self, vocab_list: List[str]):
        if vocab_list[:3] != self.RESERVED:
            raise ValueError("vocab must start with <pad> <eos> <unk>")
        self._vocab = vocab_list
        self._idx = {tok: i for i, tok in enumerate(vocab_list)}

    @classmethod
    def load_from_file(cls, vocab_file: str) -> "WordTextEncoder":
        with open(vocab_file, "r", encoding="utf-8") as f:
            words = [ln.strip() for ln in f if ln.strip()]
        return cls(cls.RESERVED + [w for w in words if w not in cls.RESERVED])

    @property
    def vocab_size(self) -> int:
        return len(self._vocab)

    def encode(self, text: str) -> List[int]:
        ids = [self._idx.get(w, UNK_IDX) for w in text.split()]
        return ids + [EOS_IDX]

    def _id_to_piece(self, idx: int) -> str:
        return self._vocab[idx]

    def _join(self, pieces: List[str]) -> str:
        return " ".join(pieces)


def load_text_encoder(mode: str, vocab_file: str) -> TextEncoder:
    if mode == "character":
        return CharacterTextEncoder.load_from_file(vocab_file)
    if mode == "word":
        return WordTextEncoder.load_from_file(vocab_file)
    if mode == "subword":
        raise NotImplementedError(
            "subword / sentencepiece vocabularies are not ported yet")
    raise NotImplementedError(f"unknown text mode: {mode!r}")
