"""Error-rate metrics: edit distance and WER / CER (the JAX package's
``utils/metrics.py`` without its native C++ batch path)."""
from __future__ import annotations

from typing import Sequence

import numpy as np


def edit_distance(a: Sequence, b: Sequence) -> int:
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


def cal_er(tokenizer, pred: np.ndarray, truth: np.ndarray,
           mode: str = "wer", ctc: bool = False) -> float:
    """Batch error rate: the mean over utterances with a non-empty reference
    of edit distance / reference length. pred (B, U, V) scores or (B, U)
    ids, truth (B, U') padded ids; mode 'wer' (words) or 'cer' (chars);
    ``ctc`` applies the CTC collapse."""
    pred = np.asarray(pred)
    if pred.ndim == 3:
        pred = pred.argmax(axis=-1)
    errs = []
    for p, t in zip(pred, np.asarray(truth)):
        hyp = tokenizer.decode(p.tolist(), ignore_repeat=ctc)
        ref = tokenizer.decode(t.tolist())
        h, r = (hyp.split(), ref.split()) if mode == "wer" else (list(hyp), list(ref))
        if r:
            errs.append(edit_distance(h, r) / len(r))
    return float(np.mean(errs)) if errs else 0.0
