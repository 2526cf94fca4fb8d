"""Synthetic tone-code speech corpus for CI and benchmarking.

The port's copy of the JAX package's ``data/synthetic.py`` (same seeds, same
files). Generates a corpus in the LibriSpeech directory layout (so the
``data/librispeech.py`` walker is the single tested code path): each
character of the
transcript is rendered as a fixed-duration tone whose frequency encodes the
character, giving an exactly learnable audio->text mapping that a small model
fits in minutes on one chip.
"""
from __future__ import annotations

import string
from pathlib import Path

import numpy as np

from .audio_io import write_wav

SR = 16000
CHAR_DUR = 0.08          # seconds per character tone
WORDS = [
    "alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
    "hotel", "india", "juliet", "kilo", "lima", "mike", "november",
]

# syllable pieces for the generated large word inventory (subword-scale
# corpora: enough distinct words that a ~1k BPE/sentencepiece vocab is
# meaningful, SURVEY.md section 6 realistic-vocab evidence)
SYLLABLES = [c + v for c in "bcdfghjklmnprstvwz" for v in "aeiou"]


def make_word_inventory(n: int, seed: int = 1234) -> list:
    """Deterministic list of ``n`` distinct 2-3 syllable pseudo-words.
    Fixed seed (independent of the corpus seed) so train/dev/test share
    one inventory."""
    rng = np.random.RandomState(seed)
    seen, out = set(), []
    while len(out) < n:
        w = "".join(SYLLABLES[rng.randint(len(SYLLABLES))]
                    for _ in range(rng.randint(2, 4)))
        if w not in seen:
            seen.add(w)
            out.append(w)
    return out


def make_bigram_grammar(n_words: int, branch: int = 4,
                        seed: int = 4321) -> np.ndarray:
    """Deterministic (n_words, branch) successor table: word i may only be
    followed by one of ``successors[i]``. Sentences sampled from it carry
    ~log2(branch) bits/word instead of log2(n_words) — learnable sequence
    structure for the LM-fusion demonstration (an RNN-LM trained on enough
    grammar text disambiguates homophones that the acoustics cannot)."""
    rng = np.random.RandomState(seed)
    return np.stack([rng.choice(n_words, size=branch, replace=False)
                     for _ in range(n_words)])


def _char_freq(c: str) -> float:
    if c == " ":
        return 0.0
    idx = string.ascii_lowercase.index(c)
    return 220.0 * (2.0 ** (idx / 12.0))  # semitone ladder from A3


def render(text: str, rng: np.random.RandomState) -> np.ndarray:
    n = int(SR * CHAR_DUR)
    t = np.arange(n) / SR
    chunks = []
    for c in text.lower():
        f = _char_freq(c)
        if f == 0.0:
            chunks.append(np.zeros(n, np.float32))
        else:
            env = np.hanning(n).astype(np.float32)
            tone = 0.4 * np.sin(2 * np.pi * f * t) + 0.15 * np.sin(4 * np.pi * f * t)
            chunks.append((tone * env).astype(np.float32))
    wave = np.concatenate(chunks) if chunks else np.zeros(n, np.float32)
    wave = wave + rng.randn(len(wave)).astype(np.float32) * 0.01
    return wave


def generate_corpus(root: str, n_train: int = 64, n_dev: int = 16,
                    n_test: int = 16, seed: int = 0,
                    min_words: int = 1, max_words: int = 3,
                    word_inventory: int = 0, grammar: str = "",
                    branch: int = 4, homophones: int = 0,
                    text_only: int = 0, grammar_in_train: bool = True) -> Path:
    """Writes <root>/{train,dev,test}-clean/<spk>/<chap>/*.wav + trans.txt.
    Returns the root path. Deterministic for a given seed.
    ``word_inventory > 0`` swaps the 14 NATO words for that many generated
    pseudo-words (subword-vocab-scale corpora).

    LM-fusion demonstration knobs (BASELINE.md "grammar corpus"):
    - ``grammar='bigram'``: word order follows ``make_bigram_grammar``
      successor sets instead of uniform sampling.
    - ``homophones=H``: the first 2H inventory words form H pairs whose
      members RENDER with the first member's audio but keep their own
      spelling — acoustically indistinguishable, resolvable only from
      word context. (The paired-audio training set is kept small so the
      decoder's implicit LM underfits the grammar; the text-only corpus
      below is what lets the external fused LM win.)
    - ``text_only=M``: additionally writes M grammar-sampled text-only
      sentences (no audio) to <root>/lm_text.txt for LM training — the
      realistic regime where LM text vastly outnumbers paired audio.
    - ``grammar_in_train=False``: the ASR train split keeps UNIFORM word
      order (dev/test/lm_text still follow the grammar), so the attention
      decoder's implicit LM cannot learn the transitions — homophone
      disambiguation on dev/test then isolates the external fused LM's
      contribution.

    Grammar sentences start on a non-homophone word (a left-to-right LM
    has no context to resolve a sentence-initial homophone; real corpora
    constrain sentence starts too).
    """
    rng = np.random.RandomState(seed)
    words = (make_word_inventory(word_inventory) if word_inventory > 0
             else WORDS)
    successors = (make_bigram_grammar(len(words), branch)
                  if grammar == "bigram" else None)
    # strict <: grammar sentences START on a non-homophone word (see
    # docstring), so at least one word must remain outside the pairs —
    # reject clearly here instead of crashing in the start sampler
    if homophones and grammar == "bigram" and 2 * homophones >= len(words):
        raise ValueError(
            f"homophone pairs cover the whole {len(words)}-word inventory; "
            "grammar sentences need >= 1 non-homophone start word "
            f"(2*{homophones} >= {len(words)})")
    assert 2 * homophones <= len(words)
    # spoken[i] = the word whose characters are rendered for word i
    spoken = list(range(len(words)))
    for h in range(homophones):
        spoken[2 * h + 1] = 2 * h

    def sample_sentence(use_grammar: bool) -> list:
        n_words = rng.randint(min_words, max_words + 1)
        if use_grammar:
            # non-homophone start: a left-to-right LM can't resolve a
            # context-free first word
            idxs = [int(rng.randint(2 * homophones, len(words)))]
        else:
            idxs = [int(rng.randint(len(words)))]
        while len(idxs) < n_words:
            if use_grammar:
                idxs.append(int(successors[idxs[-1]][rng.randint(branch)]))
            else:
                idxs.append(int(rng.randint(len(words))))
        return idxs

    root_p = Path(root)
    for split, n_utt in (("train-clean", n_train), ("dev-clean", n_dev),
                         ("test-clean", n_test)):
        chap_dir = root_p / split / "1" / "1"
        chap_dir.mkdir(parents=True, exist_ok=True)
        use_grammar = successors is not None and (
            grammar_in_train or split != "train-clean")
        lines = []
        for i in range(n_utt):
            idxs = sample_sentence(use_grammar)
            text = " ".join(words[j] for j in idxs)
            audio_text = " ".join(words[spoken[j]] for j in idxs)
            utt_id = f"1-1-{i:04d}"
            write_wav(str(chap_dir / f"{utt_id}.wav"),
                      render(audio_text, rng), SR)
            lines.append(f"{utt_id} {text.upper()}")
        (chap_dir / "1-1.trans.txt").write_text("\n".join(lines) + "\n")
    if text_only > 0:
        with open(root_p / "lm_text.txt", "w") as f:
            for _ in range(text_only):
                f.write(" ".join(words[j] for j in
                                 sample_sentence(successors is not None))
                        + "\n")
    # vocab file for character mode
    chars = sorted(set(string.ascii_lowercase)) + ["<space>"]
    (root_p / "vocab.txt").write_text("\n".join(chars) + "\n")
    return root_p
