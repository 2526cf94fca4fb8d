"""Greedy CTC best-path decoding (used by ``transcribe`` for CTC-only models)."""
from __future__ import annotations

import torch


def ctc_greedy(ctc_output: torch.Tensor) -> torch.Tensor:
    """(B, T, V) log-probs -> (B, T) best-path ids (collapse happens in the
    tokenizer's ignore_repeat decode)."""
    return torch.argmax(ctc_output, dim=-1).to(torch.int32)
