"""Error-rate metrics: edit distance and WER / CER, the JAX package's
``utils/metrics.py``. Distances come from the port's native library
(``native/edit_distance.cc`` through ``utils/native.py``), a batch in one
call; there is no fallback. ``edit_distance_plain``, the two-row dynamic
programme in Python, is the plain version the tests hold the library to."""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from . import native


def edit_distance_plain(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance between two token sequences (two-row DP)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
        prev = cur
    return prev[-1]


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance between two token sequences."""
    return native.edit_distance(a, b)


def error_rates(hyps: Sequence[str], refs: Sequence[str],
                mode: str = "wer") -> List[Optional[float]]:
    """Each (hyp, ref) text pair's edit distance over the reference's
    length, in words ('wer') or characters ('cer'); None where the
    reference is empty. One call to the native batch."""
    split = str.split if mode == "wer" else list
    pairs = [(split(h), split(r)) for h, r in zip(hyps, refs)]
    scored = [p for p in pairs if p[1]]
    dists = iter(native.edit_distance_batch([h for h, _ in scored],
                                            [r for _, r in scored]))
    return [int(next(dists)) / len(r) if r else None for _, r in pairs]


def cal_er(tokenizer, pred: np.ndarray, truth: np.ndarray,
           mode: str = "wer", ctc: bool = False) -> float:
    """Batch error rate: the mean over utterances with a non-empty reference
    of edit distance / reference length. pred (B, U, V) scores or (B, U)
    ids, truth (B, U') padded ids; mode 'wer' (words) or 'cer' (chars);
    ``ctc`` applies the CTC collapse."""
    pred = np.asarray(pred)
    if pred.ndim == 3:
        pred = pred.argmax(axis=-1)
    hyps, refs = [], []
    for p, t in zip(pred, np.asarray(truth)):
        hyps.append(tokenizer.decode(p.tolist(), ignore_repeat=ctc))
        refs.append(tokenizer.decode(t.tolist()))
    errs = [e for e in error_rates(hyps, refs, mode) if e is not None]
    return float(np.mean(errs)) if errs else 0.0
