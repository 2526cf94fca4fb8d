"""Plain RNN-LM of the reference (``config/libri/lm_example.yaml``'s model):
embedding, dropout, stacked LSTMs with dropout between them, linear output;
next-token NLL over ``[<sos>, t_0 .. t_{U-2}]`` against the text, summed
over the valid tokens and divided by their count.

Dropout draws its uniforms from the caller's generator in the order and at
the shapes of the program's training step (``draws``): the embedding's
(B, U, E), then between layers a time-major (U, B, H) draw each.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from .numerics import Numerics
from .rnn import Leaf, dropout, lstm_leaves, lstm_scan

EOS = 1   # also <sos>


def _check(cfg: Dict[str, Any]) -> None:
    if str(cfg.get("module", "LSTM")).lower() != "lstm" or cfg.get(
            "emb_tying", False):
        raise NotImplementedError("the reference LM is an untied LSTM stack")


def leaves(cfg: Dict[str, Any], vocab: int) -> List[Leaf]:
    _check(cfg)
    E, H, L = int(cfg["emb_dim"]), int(cfg["dim"]), int(cfg["layer"])
    out: List[Leaf] = [("embed", (vocab, E), "w", E)]
    d = E
    for i in range(L):
        out += lstm_leaves(f"cells.{i}.", d, H)
        d = H
    return out + [("out_w", (H, vocab), "w", H), ("out_b", (vocab,), "zero", 0)]


def draws(cfg: Dict[str, Any], B: int, U: int, gen: torch.Generator,
          device) -> List[torch.Tensor]:
    if float(cfg.get("dropout", 0.0)) <= 0:
        return []
    E, H, L = int(cfg["emb_dim"]), int(cfg["dim"]), int(cfg["layer"])
    out = [torch.rand((B, U, E), generator=gen, device=device)]
    for _ in range(L - 1):
        out.append(torch.rand((U, B, H), generator=gen,
                              device=device).transpose(0, 1))
    return out


def forward(nm: Numerics, p: Dict[str, torch.Tensor], cfg: Dict[str, Any],
            tokens: torch.Tensor, lengths: torch.Tensor,
            u: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """tokens (B, U) -> logits (B, U, V); ``u`` the dropout draws of a
    training step, None for no dropout."""
    _check(cfg)
    rate = float(cfg.get("dropout", 0.0))
    U = tokens.shape[1]
    mask = torch.arange(U, device=tokens.device)[None, :] < lengths[:, None]
    h = F.embedding(tokens, p["embed"])
    if u:
        h = dropout(h, rate, u[0])
    L = int(cfg["layer"])
    for i in range(L):
        h = lstm_scan(nm, p, f"cells.{i}.", h, mask)
        if u and i < L - 1:
            h = dropout(h, rate, u[1 + i])
    return nm.mm(h, p["out_w"]) + p["out_b"]


def nll(nm: Numerics, p, cfg, text: torch.Tensor, text_len: torch.Tensor,
        u=None):
    """(the NLL summed over the valid tokens, their count)."""
    B, U = text.shape
    sos = torch.full((B, 1), EOS, dtype=text.dtype, device=text.device)
    logits = forward(nm, p, cfg, torch.cat([sos, text[:, :-1]], 1), text_len,
                     u)
    logp = torch.log_softmax(logits, dim=-1)
    tok = -torch.gather(logp, -1, text[..., None].long())[..., 0]
    mask = (torch.arange(U, device=text.device)[None, :]
            < text_len[:, None]).float()
    return (tok * mask).sum(), mask.sum()


def token_logp(nm: Numerics, p, cfg, prev: torch.Tensor, target: torch.Tensor,
               lengths: torch.Tensor) -> torch.Tensor:
    """log P(target_t | prev_<=t) (B, U), no dropout (decoding)."""
    logits = forward(nm, p, cfg, prev, lengths)
    return torch.gather(torch.log_softmax(logits, -1), -1,
                        target[..., None].long())[..., 0]

