"""The embedding-regularization plugin and its fused decoding, the port of
the JAX package's ``models/plugin.py``.

An auxiliary training loss pulls each label step's decoder state, projected
to the embedding width and unit-normalised, toward the target token's
pretrained embedding (mean cosine distance, times ``weight``); fused
decoding (``fuse`` = lambda > 0) replaces the attention head's
distribution by ``lambda * P_emb + (1 - lambda) * P_char``, where ``P_emb``
is a softmax at temperature ``temp`` over the cosine similarities to the
table.

The table is fixed: a ``.npy`` of shape (vocab, emb_dim) (see
``utils/bert_embedding.py``), or a fasttext / word2vec ``.vec`` aligned to
the tokenizer's vocabulary; its rows are unit-normalised into a buffer
that is no parameter and no checkpoint entry. The learnable part is the
projection ``w_proj`` (emb_dim, dec_dim), ``nn.Linear``'s layout (the JAX
package stores it (dec_dim, emb_dim)), and ``b_proj`` (emb_dim,).
Products with the table and the projection accumulate in f32, so a bf16
decoder state (amp) is widened exactly, as the JAX package's promotion
does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ..ops.amp import dot_f32
from ..utils.init import const, uniform


class EmbeddingRegularizer(nn.Module):
    def __init__(self, cfg: Dict[str, Any], vocab_size: int, dec_dim: int,
                 tokenizer=None, generator=None, device=None):
        super().__init__()
        src = str(cfg["src"])
        if src.endswith(".vec"):
            if tokenizer is None:
                raise ValueError("plugin src is a .vec file; the caller "
                                 "must pass the tokenizer")
            from ..utils.bert_embedding import load_vec_table
            table = load_vec_table(src, tokenizer)
        else:
            table = np.load(src).astype(np.float32)
        if table.shape[0] != vocab_size:
            raise ValueError(f"embedding table rows {table.shape[0]} != "
                             f"vocab {vocab_size}")
        norm = np.linalg.norm(table, axis=1, keepdims=True)
        self.register_buffer(
            "table", torch.tensor(table / np.maximum(norm, 1e-8),
                                  dtype=torch.float32, device=device),
            persistent=False)
        self.emb_dim = table.shape[1]
        self.dec_dim = dec_dim
        self.weight = float(cfg.get("weight", 1.0))
        self.fuse_lambda = float(cfg.get("fuse", 0.0))
        self.temperature = float(cfg.get("temp", 1.0))
        self.apply_fuse = self.fuse_lambda > 0.0
        self.w_proj = uniform((self.emb_dim, dec_dim), dec_dim, generator,
                              device)
        self.b_proj = const(self.emb_dim, 0.0, device)

    def project(self, dec_state: torch.Tensor) -> torch.Tensor:
        """(..., dec_dim) -> unit vectors (..., emb_dim), f32."""
        proj = dot_f32(dec_state, self.w_proj.T) + self.b_proj
        return proj * torch.rsqrt(torch.sum(proj * proj, -1, keepdim=True)
                                  + 1e-8)

    def loss(self, dec_states: torch.Tensor, targets: torch.Tensor,
             count: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``weight`` x the mean of 1 - cos between the projected decoder
        states (B, U, dec_dim) and the targets' (B, U) embeddings, over
        the non-pad targets (their sum divided by ``count``, the global
        batch's number of them, when given)."""
        cos = torch.sum(self.project(dec_states) * self.table[targets.long()],
                        dim=-1)
        mask = (targets != 0).to(cos.dtype)
        if count is None:
            count = torch.sum(mask)
        return (self.weight * torch.sum((1.0 - cos) * mask)
                / torch.clamp(count, min=1.0))

    def fused_log_prob(self, dec_state: torch.Tensor,
                       char_logits: torch.Tensor) -> torch.Tensor:
        """log(lambda P_emb + (1 - lambda) P_char + 1e-10), (B, V) f32,
        from the decoder state (B, dec_dim) and the attention head's
        logits (B, V)."""
        sim = self.project(dec_state) @ self.table.T
        p_emb = torch.softmax(sim / self.temperature, -1)
        p_char = torch.softmax(char_logits.float(), -1)
        lam = self.fuse_lambda
        return torch.log(lam * p_emb + (1.0 - lam) * p_char + 1e-10)


def plugin_from_config(model_cfg: Dict[str, Any], vocab_size: int,
                       dec_dim: int, tokenizer=None, generator=None,
                       device=None) -> Optional[EmbeddingRegularizer]:
    """The plugin of a ``model:`` block (``plugin`` present and not
    ``enabled: false``), else None."""
    cfg = model_cfg.get("plugin")
    if not cfg or not cfg.get("enabled", True):
        return None
    return EmbeddingRegularizer(cfg, vocab_size, dec_dim, tokenizer,
                                generator, device)
