"""The one traffic generator: a mix file (``traffic/<name>.json``) of
parameters -> a pool of host batches, assembled by the program's own
loaders (``data/dataset.py``: ``AudioBatchLoader`` buckets length-sorted
utterances and pads waves to its frame quantum and labels to its text
quantum, PCM16 waves as int16; ``TextBatchLoader`` sorts sentences and
pads them), and the seeded order in which a run cycles through the pool.

Sizes never depend on the seed: every seed gets the same set of lengths,
at evenly spaced quantiles of the mix's table, so the same batches' shapes.
The seed draws the content (noise waves, uniform characters) and the
order. Mix keys:

- ``driver``: the driver module (``drivers/<driver>.py``);
- ``batch``, ``pool``: rows a batch, batches in the pool;
- ``audio_s`` or ``chars``: a quantile table ``[[q, value], ...]`` of
  utterance seconds or sentence characters, interpolated linearly;
- ``chars_per_s``, ``chars_spread``: transcript characters per second of
  audio, spread evenly over +-``chars_spread`` of it (audio mixes);
- ``amplitude``: the noise waves' peak, a share of full scale.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

SR = 16000
ALPHABET = "abcdefghijklmnopqrstuvwxyz '"   # the character vocabulary's
SIZES_SEED = 0   # the fixed draw behind the sizes' order, for every run seed


def vocab() -> List[str]:
    """The character tokenizer's list: <pad>, <eos>, <unk>, then the
    alphabet (V = 31)."""
    return ["<pad>", "<eos>", "<unk>"] + ["<space>" if c == " " else c
                                          for c in ALPHABET]


def quantiles(table, n: int) -> np.ndarray:
    """``n`` values of a quantile table at the midpoints (i + 0.5) / n."""
    q = np.asarray([a for a, _ in table], dtype=np.float64)
    v = np.asarray([b for _, b in table], dtype=np.float64)
    return np.interp((np.arange(n) + 0.5) / n, q, v)


def sizes(mix: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The mix's sizes, ascending: ``samples`` and ``chars`` of each
    utterance, or ``chars`` of each sentence."""
    n = int(mix["batch"]) * int(mix["pool"])
    if "audio_s" in mix:
        samples = np.round(quantiles(mix["audio_s"], n) * SR).astype(np.int64)
        spread = float(mix.get("chars_spread", 0.0))
        f = np.linspace(-1.0, 1.0, n) if n > 1 else np.zeros(1)
        np.random.RandomState(SIZES_SEED).shuffle(f)
        chars = np.round(samples / SR * float(mix["chars_per_s"])
                         * (1.0 + spread * f)).astype(np.int64)
        return {"samples": samples, "chars": np.maximum(chars, 1)}
    return {"chars": np.round(quantiles(mix["chars"], n)).astype(np.int64)}


class _Utterances:
    """The dataset interface ``AudioBatchLoader`` and ``TextBatchLoader``
    read, over generated arrays (ascending by size)."""

    def __init__(self, waves, texts, tokenizer):
        self.waves, self.texts = waves, texts
        self.ids = [tokenizer.encode(t) for t in texts]

    def __len__(self):
        return len(self.texts)

    def load_wave(self, i):
        return self.waves[i]

    def num_samples(self, i):
        return len(self.waves[i])

    def text_ids(self, i):
        return self.ids[i]

    def text_raw(self, i):
        return self.texts[i]

    def utt_id(self, i):
        return f"utt{i}"


def _texts(rng: np.random.Generator, chars: np.ndarray) -> List[str]:
    letters = np.frombuffer(ALPHABET.encode(), dtype=np.uint8)
    draw = rng.integers(0, len(letters), int(chars.sum()))
    out, off = [], 0
    for n in chars:
        out.append(letters[draw[off:off + n]].tobytes().decode())
        off += n
    return out


def make_pool(mix: Dict[str, Any], seed: int, tokenizer, device
              ) -> List[Dict[str, Any]]:
    """The pool of host batches of ``mix`` for ``seed``, ascending by
    size. Noise is drawn on ``device`` in one call and brought to the
    host."""
    from end_to_end_asr_pytorch_tpu_torch.data.dataset import (
        AudioBatchLoader, TextBatchLoader)
    sz = sizes(mix)
    rng = np.random.Generator(np.random.PCG64(int(seed)))
    texts = _texts(rng, sz["chars"])
    B = int(mix["batch"])
    if "samples" not in sz:
        loader = TextBatchLoader(_Utterances(None, texts, tokenizer), B,
                                 shuffle=False)
        return [loader.make_batch(ids) for ids in loader.batches]
    amp = int(round(float(mix.get("amplitude", 0.1)) * 32767))
    total = int(sz["samples"].sum())
    g = torch.Generator(device=device).manual_seed(int(seed))
    noise = torch.randint(-amp, amp + 1, (total,), generator=g, device=device,
                          dtype=torch.int16).cpu().numpy()
    ends = np.cumsum(sz["samples"])
    waves = np.split(noise, ends[:-1])
    loader = AudioBatchLoader(_Utterances(waves, texts, tokenizer), B,
                              shuffle=False, cache_waves=False)
    return [loader.make_batch(ids) for ids in loader.batches]


def cycle(n: int, seed: int):
    """Pool indices for a run: a seeded order of the pool, repeated."""
    order = np.random.Generator(np.random.PCG64(int(seed) + 1)).permutation(n)
    while True:
        yield from (int(i) for i in order)
