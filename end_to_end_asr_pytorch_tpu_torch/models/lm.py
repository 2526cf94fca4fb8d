"""RNN language model for shallow-fusion decoding (incremental step only).

Embedding (with optional ``emb_tying``: the output layer is ``embed.T``),
n-layer LSTM/GRU, linear to vocab, as in the JAX package. Under decode amp
the state is bf16, the weights and the first-layer table are rounded to
bf16, and every product accumulates in f32: the logits are f32.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import rnn as rnn_ops
from ..ops.amp import dot_f32, round_bf16
from ..utils.init import const, uniform


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
        return dot_f32(h, w) + self.out_b

    def emb_proj_table(self, amp: bool = False) -> torch.Tensor:
        """(V, gates) f32 first-layer input projection of every token's
        embedding, bias folded in (under ``amp`` rounded to bf16)."""
        w = self.cells[0]
        b = w.b if self.module == "lstm" else w.b_ih
        t = dot_f32(self.embed, w.w_ih) + b
        return round_bf16(t) if amp else t

    def step(self, state: LMState, token: torch.Tensor,
             emb_proj: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, LMState]:
        """token (B,) -> (logits (B, V), new state)."""
        inp = None if emb_proj is not None else self.embed[token]
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
