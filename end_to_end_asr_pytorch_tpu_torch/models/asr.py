"""The ASR model: encoder + optional CTC head + optional attention decoder
(inference side). ``ctc_weight > 0`` enables the CTC head, ``< 1`` the
attention decoder, as in the JAX package."""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.init import const, uniform
from .attention import Attention, AttCache
from .decoder import Decoder, DecoderState
from .encoder import Encoder


class ASR(nn.Module):
    """Parameters (names as the JAX ``ASRParams`` fields): ``encoder``,
    ``ctc_w`` (enc_dim, V), ``ctc_b``, ``embed`` (V, dec_dim),
    ``attention``, ``decoder``, ``char_w`` (dec_dim, V), ``char_b``."""

    def __init__(self, input_size: int, vocab_size: int, cfg: Dict[str, Any],
                 generator=None, device=None):
        super().__init__()
        self.vocab_size = vocab_size
        self.ctc_weight = float(cfg.get("ctc_weight", 0.0))
        if not 0.0 <= self.ctc_weight <= 1.0:
            raise ValueError(f"ctc_weight {self.ctc_weight} not in [0, 1]")
        self.enable_ctc = self.ctc_weight > 0.0
        self.enable_att = self.ctc_weight < 1.0
        g, dev = generator, device
        self.encoder = Encoder(input_size, cfg["encoder"], g, dev)
        enc_dim = self.encoder.out_dim
        self.ctc_w = self.ctc_b = None
        if self.enable_ctc:
            self.ctc_w = uniform((enc_dim, vocab_size), enc_dim, g, dev)
            self.ctc_b = const(vocab_size, 0.0, dev)
        self.embed = self.attention = self.decoder = None
        self.char_w = self.char_b = None
        if self.enable_att:
            dec_cfg = cfg["decoder"]
            self.dec_dim = int(dec_cfg["dim"])
            self.embed = uniform((vocab_size, self.dec_dim), self.dec_dim, g, dev)
            self.attention = Attention(cfg["attention"], self.dec_dim,
                                       enc_dim, g, dev)
            self.decoder = Decoder(self.dec_dim + self.attention.context_dim,
                                   dec_cfg, g, dev)
            self.char_w = uniform((self.decoder.out_dim, vocab_size),
                                  self.decoder.out_dim, g, dev)
            self.char_b = const(vocab_size, 0.0, dev)

    def encode(self, feat: torch.Tensor, feat_len: torch.Tensor):
        return self.encoder(feat, feat_len)

    def ctc_logits(self, enc: torch.Tensor) -> torch.Tensor:
        return enc @ self.ctc_w + self.ctc_b

    def ctc_output(self, enc: torch.Tensor) -> torch.Tensor:
        return F.log_softmax(self.ctc_logits(enc), dim=-1)

    def precompute_decode_tables(self):
        """The decoder's first-layer input is [emb(prev_token) ; context];
        the embedding half of its projection has only V distinct rows, so
        ``embed @ W_ih[:E] + b`` is a (V, gates) table."""
        c0 = self.decoder.cells[0]
        E = self.dec_dim
        b = c0.b if self.decoder.module == "lstm" else c0.b_ih
        return {"emb_proj": self.embed @ c0.w_ih[:E] + b,
                "w_ctx": c0.w_ih[E:]}

    def decode_step_beam(self, cache: AttCache, state: DecoderState,
                         prev_align: torch.Tensor, prev_token: torch.Tensor,
                         beam: int, tables=None):
        """state (L, B*K, H), prev_align (B, K, H, T), prev_token (B*K,) ->
        (logits (B*K, V), state, align, context)."""
        BK = prev_token.shape[0]
        B = BK // beam
        query = self.decoder.query(state).reshape(B, beam, -1)
        context, align = self.attention.step_beam(cache, query, prev_align)
        if tables is not None:
            oh = F.one_hot(prev_token, self.vocab_size).to(
                tables["emb_proj"].dtype)
            x0 = oh @ tables["emb_proj"] + context.reshape(BK, -1) @ tables["w_ctx"]
            dec_out, state = self.decoder.step(state, x0_proj=x0)
        else:
            emb = self.embed[prev_token]
            dec_in = torch.cat([emb, context.reshape(BK, -1)], dim=-1)
            dec_out, state = self.decoder.step(state, dec_in)
        logits = dec_out @ self.char_w + self.char_b
        return logits, state, align, context
