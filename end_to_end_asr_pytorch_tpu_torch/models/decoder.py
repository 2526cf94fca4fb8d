"""Speller / decoder: stacked LSTM or GRU cells advanced one label step at a
time over an explicit ``DecoderState``. ``dropout`` applies between layers
in training steps only, its masks drawn from the caller's generator. Under
decode amp the state is bf16 and each cell accumulates in f32
(``ops/rnn.py``)."""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from ..ops import rnn as rnn_ops
from ..ops.amp import dot_f32
from .encoder import dropout


class DecoderState(NamedTuple):
    h: torch.Tensor                 # (L, B, H)
    c: Optional[torch.Tensor]       # (L, B, H) for LSTM, None for GRU


class Decoder(nn.Module):
    def __init__(self, in_dim: int, cfg: Dict[str, Any], generator=None,
                 device=None):
        super().__init__()
        self.module = cfg.get("module", "LSTM").lower()
        self.dim = int(cfg["dim"])
        self.layers = int(cfg.get("layer", 1))
        self.dropout = float(cfg.get("dropout", 0.0))
        self.out_dim = self.dim
        cells, d = [], in_dim
        for _ in range(self.layers):
            cells.append(rnn_ops.cell_weights(self.module, d, self.dim,
                                              generator, device))
            d = self.dim
        self.cells = nn.ModuleList(cells)

    def init_state(self, batch: int, device=None,
                   dtype=torch.float32) -> DecoderState:
        h = torch.zeros((self.layers, batch, self.dim), dtype=dtype,
                        device=device)
        return DecoderState(h, h if self.module == "lstm" else None)

    def query(self, state: DecoderState) -> torch.Tensor:
        """Attention query = top-layer hidden state (B, H)."""
        return state.h[-1]

    def step(self, state: DecoderState, x: Optional[torch.Tensor] = None, *,
             train: bool = False, generator=None,
             x0_proj: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, DecoderState]:
        """x (B, in_dim) -> (output (B, dim), new state). ``x0_proj`` (B, G)
        optionally supplies the first layer's input projection (bias
        included) directly."""
        hs, cs = [], []
        inp = x
        for i, w in enumerate(self.cells):
            if i == 0 and x0_proj is not None:
                x_proj = x0_proj
            elif self.module == "lstm":
                x_proj = dot_f32(inp, w.w_ih) + w.b
            else:
                x_proj = dot_f32(inp, w.w_ih) + w.b_ih
            if self.module == "lstm":
                h_new, c_new = rnn_ops.lstm_cell(w, state.h[i], state.c[i], x_proj)
                cs.append(c_new)
            else:
                h_new = rnn_ops.gru_cell(w, state.h[i], x_proj)
            hs.append(h_new)
            inp = h_new
            if train and self.dropout > 0 and i < self.layers - 1:
                inp = dropout(h_new, self.dropout, generator)
        return inp, DecoderState(
            torch.stack(hs), torch.stack(cs) if self.module == "lstm" else None)
