"""Tokenizers: character, word and subword encoders (the port's own copy).

Index contract shared with the JAX package and the reference:

    0 = <pad>   (also the CTC blank and the cross-entropy ignore_index)
    1 = <eos>   (doubles as the decoder's <sos> start token)
    2 = <unk>

``decode(idxs, ignore_repeat=True)`` performs CTC collapse (merge repeats,
drop blanks). Subword mode takes a binary sentencepiece ``.model`` (unigram
Viterbi, ``utils/sentencepiece_model.py``) or the JSON BPE of the repo's
vocab tool, told apart by the file's first byte. The JSON BPE encodes
through the port's native encoder (``utils/native.py`` ``BpeEncoder``,
built at first use, no fallback); ``encode_py``, the Python walk, is the
plain version the tests hold it to.
"""
from __future__ import annotations

import abc
import json
import threading
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


class SubwordTextEncoder(TextEncoder):
    """Greedy-merge BPE. Model = JSON {vocab: [...], merges: [[a,b], ...]}.
    A leading U+2581 marks a word-initial piece (sentencepiece style), so
    decode is reversible. ``encode`` goes through the native encoder, made
    at the first call (so a model that only decodes needs no compiler)."""

    BOUNDARY = "▁"

    def __init__(self, vocab_list: List[str], merges: List[List[str]]):
        if vocab_list[:3] != self.RESERVED:
            raise ValueError("vocab must start with <pad> <eos> <unk>")
        self._vocab = vocab_list
        self._idx = {tok: i for i, tok in enumerate(vocab_list)}
        self._merges = merges
        self._merge_rank = {tuple(m): r for r, m in enumerate(merges)}
        self._native = None
        self._native_lock = threading.Lock()

    @classmethod
    def load_from_file(cls, vocab_file: str) -> "SubwordTextEncoder":
        with open(vocab_file, "r", encoding="utf-8") as f:
            model = json.load(f)
        return cls(model["vocab"], model["merges"])

    @property
    def vocab_size(self) -> int:
        return len(self._vocab)

    def _bpe_word(self, word: str) -> List[str]:
        pieces = [self.BOUNDARY + word[0]] + list(word[1:]) if word else []
        while len(pieces) > 1:
            best, best_rank = None, None
            for i in range(len(pieces) - 1):
                r = self._merge_rank.get((pieces[i], pieces[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            pieces = (pieces[:best] + [pieces[best] + pieces[best + 1]]
                      + pieces[best + 2:])
        return pieces

    def encode(self, text: str) -> List[int]:
        if self._native is None:
            with self._native_lock:
                if self._native is None:
                    from .native import BpeEncoder
                    self._native = BpeEncoder(self._vocab, self._merges,
                                              UNK_IDX)
        return self._native.encode(text) + [EOS_IDX]

    def encode_py(self, text: str) -> List[int]:
        """The Python walk (the JAX package's reference for its native
        encoder): ``encode``'s ids."""
        ids: List[int] = []
        for word in text.split():
            for piece in self._bpe_word(word):
                ids.append(self._idx.get(piece, UNK_IDX))
        return ids + [EOS_IDX]

    def _id_to_piece(self, idx: int) -> str:
        return self._vocab[idx]

    def _join(self, pieces: List[str]) -> str:
        return "".join(pieces).replace(self.BOUNDARY, " ").strip()


class SentencePieceTextEncoder(TextEncoder):
    """Subword encoder over a binary sentencepiece ``.model`` file, with the
    model's own piece ids. Ids 0 and 1 must not be normal pieces (the
    0=<pad>, 1=<eos>, 2=<unk> contract): a mismatched layout raises."""

    def __init__(self, vocab):
        from .sentencepiece_model import TYPE_NORMAL, TYPE_USER_DEFINED
        self._sp = vocab
        if (vocab.types[0] in (TYPE_NORMAL, TYPE_USER_DEFINED)
                or vocab.types[1] in (TYPE_NORMAL, TYPE_USER_DEFINED)):
            raise ValueError(
                "sentencepiece model ids 0/1 are normal pieces; this "
                "framework (like the reference) requires 0=<pad> 1=<eos> "
                "2=<unk> — retrain with pad_id=0 eos_id=1 unk_id=2 bos_id=-1")

    @classmethod
    def load_from_file(cls, vocab_file: str) -> "SentencePieceTextEncoder":
        from .sentencepiece_model import SentencePieceVocab
        return cls(SentencePieceVocab.load(vocab_file))

    @property
    def vocab_size(self) -> int:
        return len(self._sp)

    def encode(self, text: str) -> List[int]:
        return self._sp.encode(text) + [EOS_IDX]

    def _id_to_piece(self, idx: int) -> str:
        return self._sp.pieces[idx]

    def _join(self, pieces: List[str]) -> str:
        return "".join(pieces).replace(
            SubwordTextEncoder.BOUNDARY, " ").strip()


def load_text_encoder(mode: str, vocab_file: str) -> TextEncoder:
    if mode == "character":
        return CharacterTextEncoder.load_from_file(vocab_file)
    if mode == "word":
        return WordTextEncoder.load_from_file(vocab_file)
    if mode == "subword":
        with open(vocab_file, "rb") as f:
            head = f.read(1)
        if head == b"{":  # JSON BPE (the repo's vocab tool)
            return SubwordTextEncoder.load_from_file(vocab_file)
        return SentencePieceTextEncoder.load_from_file(vocab_file)
    raise NotImplementedError(f"unknown text mode: {mode!r}")
