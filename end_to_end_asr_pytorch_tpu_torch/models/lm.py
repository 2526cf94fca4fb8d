"""RNN language model: the full-sequence ``forward`` of LM training and
the incremental ``step`` of shallow-fusion decoding.

Embedding (with optional ``emb_tying``: the output layer is ``embed.T``),
dropout, n-layer LSTM/GRU, linear to vocab, as in the JAX package.
``forward`` runs each layer's scan over the whole sequence (``ops/rnn``:
``LSTMScan``, K2 with residuals and K2b on the card, or ``GRUScan``, K4
and K4b; without residuals under ``torch.no_grad``), with dropout on the
embedding and between layers when training, its masks drawn from the
caller's ``torch.Generator``. Under decode amp the state is bf16, the
weights and the first-layer table are rounded to bf16, and every product
accumulates in f32: the logits are f32. Under tensor parallelism
(``parallel/tp.py``) the output layer computes the rank's vocabulary
columns (under ``emb_tying`` the rank's rows of ``embed``) and joins them,
the embedding lookup sums the ranks' rows, and the first-layer table is
built from the rank's rows and joined; the cells' weights are whole
while the model computes (``tp.gathered``).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import rnn as rnn_ops
from ..ops.amp import dot_f32, round_bf16
from ..parallel import mesh, tp
from ..utils.init import const, uniform
from .encoder import dropout


class LMState(NamedTuple):
    h: torch.Tensor                 # (L, B, H)
    c: Optional[torch.Tensor]       # (L, B, H) LSTM only


class RNNLM(nn.Module):
    def __init__(self, vocab_size: int, cfg: Dict[str, Any], generator=None,
                 device=None):
        super().__init__()
        self.vocab_size = vocab_size
        self.module = cfg.get("module", "LSTM").lower()
        self.emb_dim = int(cfg.get("emb_dim", cfg.get("dim", 512)))
        self.dim = int(cfg["dim"])
        self.n_layers = int(cfg.get("layer", 1))
        self.dropout = float(cfg.get("dropout", 0.0))
        self.emb_tying = bool(cfg.get("emb_tying", False))
        if self.emb_tying and self.emb_dim != self.dim:
            raise ValueError("emb_tying needs emb_dim == dim")
        self.embed = uniform((vocab_size, self.emb_dim), self.emb_dim,
                             generator, device)
        cells, d = [], self.emb_dim
        for _ in range(self.n_layers):
            cells.append(rnn_ops.cell_weights(self.module, d, self.dim,
                                              generator, device))
            d = self.dim
        self.cells = nn.ModuleList(cells)
        self.out_w = (None if self.emb_tying else
                      uniform((self.dim, vocab_size), self.dim, generator,
                              device))
        self.out_b = const(vocab_size, 0.0, device)

    def init_state(self, batch: int, device=None,
                   dtype=torch.float32) -> LMState:
        h = torch.zeros((self.n_layers, batch, self.dim), dtype=dtype,
                        device=device)
        return LMState(h, h if self.module == "lstm" else None)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        w = self.embed.T if self.out_w is None else self.out_w
        return tp.vocab_logits(h, w, self.out_b,
                               tp.split_dim(self, "out_b") is not None)

    def _embed_split(self) -> bool:
        return tp.split_dim(self, "embed") is not None

    def emb_proj_table(self, amp: bool = False) -> torch.Tensor:
        """(V, gates) f32 first-layer input projection of every token's
        embedding, bias folded in (under ``amp`` rounded to bf16)."""
        w = self.cells[0]
        b = w.b if self.module == "lstm" else w.b_ih
        t = tp.vocab_table(self.embed, w.w_ih, b, self._embed_split())
        return round_bf16(t) if amp else t

    def step(self, state: LMState, token: torch.Tensor,
             emb_proj: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, LMState]:
        """token (B,) -> (logits (B, V), new state)."""
        inp = None
        if emb_proj is None:
            inp = (tp.vocab_lookup(self.embed, token) if self._embed_split()
                   else self.embed[token])
        hs, cs = [], []
        for i, w in enumerate(self.cells):
            if i == 0 and emb_proj is not None:
                oh = F.one_hot(token, emb_proj.shape[0]).to(emb_proj.dtype)
                x_proj = dot_f32(oh, emb_proj)
            else:
                b = w.b if self.module == "lstm" else w.b_ih
                x_proj = dot_f32(inp, w.w_ih) + b
            if self.module == "lstm":
                h_new, c_new = rnn_ops.lstm_cell(w, state.h[i], state.c[i], x_proj)
                cs.append(c_new)
            else:
                h_new = rnn_ops.gru_cell(w, state.h[i], x_proj)
            hs.append(h_new)
            inp = h_new
        new_state = LMState(torch.stack(hs),
                            torch.stack(cs) if self.module == "lstm" else None)
        return self._logits(inp), new_state

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """tokens (B, U) (the input sequence), lengths (B,) -> logits
        (B, U, V) f32. Steps past a row's length hold the carry and emit
        zeros. ``train`` applies the configured dropout, which needs
        ``generator``."""
        U = tokens.shape[1]
        drop = train and self.dropout > 0
        # F.embedding's backward sums each token's rows in parallel; the
        # index backward of embed[tokens] walks a token's repeats in turn
        x = (tp.vocab_lookup(self.embed, tokens) if self._embed_split()
             else F.embedding(tokens, self.embed))
        if drop:
            x = dropout(x, self.dropout, generator)
        mask = (torch.arange(U, device=tokens.device)[:, None]
                < lengths[None, :])
        scan = rnn_ops.lstm_scan if self.module == "lstm" else rnn_ops.gru_scan
        h = x.transpose(0, 1)                        # (U, B, E)
        for i, w in enumerate(self.cells):
            h = scan(w, h, mask)
            if drop and i < self.n_layers - 1:
                with mesh.time_major():
                    h = dropout(h, self.dropout, generator)
        return self._logits(h.transpose(0, 1))
