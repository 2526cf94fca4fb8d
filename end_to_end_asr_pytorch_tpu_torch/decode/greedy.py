"""Greedy decoding: CTC best path and the attention decoder's self-fed
argmax (validation and CTC-only transcription)."""
from __future__ import annotations

import torch

from ..models.asr import ASR
from ..utils.text import EOS_IDX


def ctc_greedy(ctc_output: torch.Tensor) -> torch.Tensor:
    """(B, T, V) log-probs -> (B, T) best-path ids (collapse happens in the
    tokenizer's ignore_repeat decode)."""
    return torch.argmax(ctc_output, dim=-1).to(torch.int32)


def att_greedy(model: ASR, enc: torch.Tensor, enc_len: torch.Tensor,
               max_step: int, amp: bool = False, plugin=None) -> torch.Tensor:
    """Self-fed argmax decode for up to ``max_step`` steps -> (B, max_step)
    int32 ids; a row emits <eos> for every step after its first <eos>. The
    loop stops once every row is done: the remaining steps would all write
    <eos>, which the output is pre-filled with, so the output is identical
    to running all ``max_step`` steps. ``amp`` (the training solver's amp
    flag, as the JAX package's validation passes it) takes the first-layer
    lookup-table route (``precompute_decode_tables``) in place of the
    embedding gather. An embedding ``plugin`` with ``fuse > 0`` replaces
    each step's logits by its fused log-probs, as the JAX package's
    validation decode does."""
    B = enc.shape[0]
    cache, state, align = model.init_decode(enc, enc_len)
    tables = model.precompute_decode_tables() if amp else None
    ids = torch.full((B, max_step), EOS_IDX, dtype=torch.int32,
                     device=enc.device)
    prev = torch.full((B,), EOS_IDX, dtype=torch.int64, device=enc.device)
    done = torch.zeros((B,), dtype=torch.bool, device=enc.device)
    for t in range(max_step):
        logits, state, align, _ = model.decode_step(cache, state, align, prev,
                                                    tables=tables)
        if plugin is not None and plugin.apply_fuse:
            logits = plugin.fused_log_prob(state.h[-1], logits)
        pred = torch.where(done, EOS_IDX, torch.argmax(logits, dim=-1))
        ids[:, t] = pred.to(torch.int32)
        done = done | (pred == EOS_IDX)
        prev = pred
        if bool(done.all()):
            break
    return ids
