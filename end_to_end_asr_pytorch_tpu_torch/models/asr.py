"""The ASR model: encoder + optional CTC head + optional attention decoder.
``ctc_weight > 0`` enables the CTC head, ``< 1`` the attention decoder, as in
the JAX package. ``forward`` is the teacher-forced training pass: a Python
loop over label steps (the JAX package's ``lax.scan``; its remat and unroll
are XLA devices that change no number and are not carried over). Under
amp (bf16 activations, the weights rounded to bf16, ``ops/amp.py``) every
product accumulates in f32, so the CTC and decoder logits are f32; a bf16
encoder output keeps the attention cache and the training label scan's
lookup table in bf16, as in the JAX package's amp training.

Under tensor parallelism (``parallel/tp.py``) the CTC and attention heads
compute the rank's vocabulary columns and join them, the embedding lookup
sums the ranks' rows, and the decoding table is built from the rank's
rows and joined; every other leaf is whole while the model computes
(``tp.gathered``)."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..ops.amp import dot_f32, round_bf16
from ..parallel import tp
from ..utils.init import const, uniform
from .attention import Attention, AttCache
from .decoder import Decoder, DecoderState
from .encoder import Encoder, dropout
from ..utils.text import EOS_IDX


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
        self.emb_drop = float(cfg.get("emb_drop", 0.0))
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

    def encode(self, feat: torch.Tensor, feat_len: torch.Tensor,
               train: bool = False, generator=None):
        return self.encoder(feat, feat_len, train=train, generator=generator)

    def ctc_logits(self, enc: torch.Tensor) -> torch.Tensor:
        """Raw CTC head logits, f32."""
        return tp.vocab_logits(enc, self.ctc_w, self.ctc_b,
                               tp.split_dim(self, "ctc_w") is not None)

    def char_logits(self, dec_out: torch.Tensor) -> torch.Tensor:
        """The attention head's logits, f32."""
        return tp.vocab_logits(dec_out, self.char_w, self.char_b,
                               tp.split_dim(self, "char_w") is not None)

    def embed_rows(self, tokens: torch.Tensor) -> torch.Tensor:
        """The embedding of ``tokens``."""
        if tp.split_dim(self, "embed") is None:
            return self.embed[tokens.long()]
        return tp.vocab_lookup(self.embed, tokens)

    def ctc_output(self, enc: torch.Tensor) -> torch.Tensor:
        return F.log_softmax(self.ctc_logits(enc), dim=-1)

    def precompute_decode_tables(self, amp: bool = False):
        """The decoder's first-layer input is [emb(prev_token) ; context];
        the embedding half of its projection has only V distinct rows, so
        ``embed @ W_ih[:E] + b`` is a (V, gates) f32 table (under ``amp``
        rounded to bf16, the JAX package's bf16 table)."""
        c0 = self.decoder.cells[0]
        E = self.dec_dim
        b = c0.b if self.decoder.module == "lstm" else c0.b_ih
        t = tp.vocab_table(self.embed, c0.w_ih[:E], b,
                           tp.split_dim(self, "embed") is not None)
        return {"emb_proj": round_bf16(t) if amp else t, "w_ctx": c0.w_ih[E:]}

    def init_decode(self, enc: torch.Tensor, enc_len: torch.Tensor):
        """-> (attention cache, zero decoder state, initial alignment); a
        bf16 ``enc`` (amp training) keeps the cache in bf16."""
        cache = self.attention.precompute(enc, enc_len,
                                          amp=enc.dtype == torch.bfloat16)
        state = self.decoder.init_state(enc.shape[0], device=enc.device,
                                        dtype=enc.dtype)
        return cache, state, self.attention.init_align(cache)

    def decode_step(self, cache: AttCache, state: DecoderState,
                    prev_align: torch.Tensor, prev_token: torch.Tensor, *,
                    train: bool = False, generator=None, tables=None):
        """One label-synchronous step: prev_token (B,) -> (logits (B, V),
        state, align (B, H, T), context). Attention is queried with the
        previous decoder state, then the decoder consumes
        [emb(prev_token) ; context] (or the ``tables`` lookup, which needs
        emb_drop == 0)."""
        context, align = self.attention.step(cache, self.decoder.query(state),
                                             prev_align)
        if tables is not None:
            oh = F.one_hot(prev_token.long(), self.vocab_size).to(
                tables["emb_proj"].dtype)
            x0 = (dot_f32(oh, tables["emb_proj"])
                  + dot_f32(context, tables["w_ctx"]))
            dec_out, state = self.decoder.step(state, x0_proj=x0, train=train,
                                               generator=generator)
        else:
            emb = self.embed_rows(prev_token)
            if train and self.emb_drop > 0:
                emb = dropout(emb, self.emb_drop, generator)
            dec_out, state = self.decoder.step(
                state, torch.cat([emb, context], dim=-1), train=train,
                generator=generator)
        return self.char_logits(dec_out), state, align, context

    def forward(self, feat: torch.Tensor, feat_len: torch.Tensor,
                decode_step: int, tf_rate: float = 1.0,
                teacher: Optional[torch.Tensor] = None, *,
                train: bool = False, generator=None,
                get_dec_state: bool = False):
        """-> (ctc_output (B, T', V) | None, encode_len (B,),
        att_output (B, U, V) | None, att_align (B, U, H, T') | None,
        dec_state | None): the final top-layer hidden (B, dec_dim), or with
        ``get_dec_state`` every step's (B, U, dec_dim) (the embedding
        plugin's input).

        Step 0 is fed <sos>; each later step one Bernoulli(tf_rate) coin for
        the whole batch, drawn from ``generator``, picks the teacher token or
        the previous step's argmax. ``teacher=None`` self-feeds every step.
        Its parts are profiler ranges (``asr.encode``, ``asr.ctc_head``,
        ``asr.label_scan``)."""
        with record_function("asr.encode"):
            enc, enc_len = self.encode(feat, feat_len, train=train,
                                       generator=generator if train else None)
        ctc_out = att_out = att_align = dec_state = None
        if self.enable_ctc:
            with record_function("asr.ctc_head"):
                ctc_out = self.ctc_output(enc)
        if self.enable_att and decode_step > 0:
            with record_function("asr.label_scan"):
                att_out, att_align, dec_state = self.label_scan(
                    enc, enc_len, decode_step, tf_rate, teacher, train=train,
                    generator=generator, get_dec_state=get_dec_state)
        return ctc_out, enc_len, att_out, att_align, dec_state

    def label_scan(self, enc: torch.Tensor, enc_len: torch.Tensor,
                   decode_step: int, tf_rate: float = 1.0,
                   teacher: Optional[torch.Tensor] = None, *,
                   train: bool = False, generator=None,
                   get_dec_state: bool = False):
        """The attention decoder over ``decode_step`` label steps ->
        (att_output (B, U, V), att_align (B, U, H, T'), final top-layer
        hidden (B, dec_dim), or with ``get_dec_state`` each step's
        (B, U, dec_dim)); see ``forward``."""
        B = enc.shape[0]
        dev = enc.device
        cache, state, align = self.init_decode(enc, enc_len)
        sos = torch.full((B, 1), EOS_IDX, dtype=torch.int64, device=dev)
        if teacher is not None:
            coins = torch.rand(decode_step, generator=generator,
                               device=dev) <= tf_rate
            coins[0] = True
            tf_toks = torch.cat([sos, teacher[:, :decode_step - 1].long()], 1)
        else:
            coins = torch.arange(decode_step, device=dev) == 0
            tf_toks = sos.expand(B, decode_step)
        tables = (self.precompute_decode_tables(enc.dtype == torch.bfloat16)
                  if (self.emb_drop == 0.0 or not train) else None)
        pred = sos[:, 0]
        logits_all, aligns, queries = [], [], []
        for u in range(decode_step):
            prev = torch.where(coins[u], tf_toks[:, u], pred)
            logits, state, align, _ = self.decode_step(
                cache, state, align, prev, train=train,
                generator=generator if train else None, tables=tables)
            pred = torch.argmax(logits, dim=-1)
            logits_all.append(logits)
            aligns.append(align)
            if get_dec_state:
                queries.append(self.decoder.query(state))
        return (torch.stack(logits_all, dim=1), torch.stack(aligns, dim=1),
                torch.stack(queries, dim=1) if get_dec_state
                else self.decoder.query(state))

    def decode_step_beam(self, cache: AttCache, state: DecoderState,
                         prev_align: torch.Tensor, prev_token: torch.Tensor,
                         beam: int, tables=None):
        """state (L, B*K, H), prev_align (B, K, H, T), prev_token (B*K,) ->
        (logits (B*K, V) f32, state, align, context). ``tables`` (from
        ``precompute_decode_tables``) replaces the embedding lookup and the
        first layer's input product by a one-hot product with the table,
        exact (one nonzero term per row)."""
        BK = prev_token.shape[0]
        B = BK // beam
        query = self.decoder.query(state).reshape(B, beam, -1)
        context, align = self.attention.step_beam(cache, query, prev_align)
        if tables is not None:
            oh = F.one_hot(prev_token, self.vocab_size).to(
                tables["emb_proj"].dtype)
            x0 = (dot_f32(oh, tables["emb_proj"])
                  + dot_f32(context.reshape(BK, -1), tables["w_ctx"]))
            dec_out, state = self.decoder.step(state, x0_proj=x0)
        else:
            emb = self.embed_rows(prev_token)
            dec_in = torch.cat([emb, context.reshape(BK, -1)], dim=-1)
            dec_out, state = self.decoder.step(state, dec_in)
        return self.char_logits(dec_out), state, align, context
