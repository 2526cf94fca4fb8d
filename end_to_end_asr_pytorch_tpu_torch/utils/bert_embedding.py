"""Pretrained-embedding tables for the embedding plugin, the port of the
JAX package's ``utils/bert_embedding.py`` over the port's tokenizers.

``generate_embedding`` writes a (vocab, emb_dim) ``.npy``, one row per
vocabulary entry: from a transformer's mean last hidden state per piece
(``--model``, a local HuggingFace model directory; ``transformers`` is
imported only then), or (``--method hash``) from a deterministic random
row per piece, seeded by the piece's bytes. Nothing is downloaded: under
``--method auto`` a model that cannot be loaded falls back to hash rows.
``load_vec_table`` aligns a fasttext / word2vec ``.vec`` text file to the
vocabulary.

  python -m end_to_end_asr_pytorch_tpu_torch.utils.bert_embedding \\
      --vocab_file v.txt --mode character --output emb.npy \\
      [--model path/to/bert | --method hash --dim 256]
"""
from __future__ import annotations

import argparse
import hashlib

import numpy as np

from .text import load_text_encoder


def _hash_embedding(tokens, dim: int) -> np.ndarray:
    """One gaussian row per token, seeded by the first 4 bytes of the
    token's sha256 (little-endian): not semantic, deterministic."""
    out = np.zeros((len(tokens), dim), np.float32)
    for i, tok in enumerate(tokens):
        seed = int.from_bytes(hashlib.sha256(tok.encode()).digest()[:4],
                              "little")
        out[i] = np.random.RandomState(seed).randn(dim).astype(np.float32)
    return out


def load_vec_table(vec_file: str, tokenizer) -> np.ndarray:
    """A ``.vec`` file (``word v1 .. vdim`` rows, an optional ``count dim``
    header) -> (vocab, dim) rows in the tokenizer's order. A piece is
    looked up as it is, then lowercased, then without a leading
    sentencepiece word marker (U+2581), as it is and lowercased. Pieces
    absent from the file, the reserved ids 0-2 always among them, get zero
    rows."""
    vecs = {}
    dim = None
    with open(vec_file, "r", encoding="utf-8") as f:
        for ln_no, ln in enumerate(f):
            parts = ln.rstrip("\n").split(" ")
            if ln_no == 0 and len(parts) == 2:
                continue  # "count dim" header
            if len(parts) < 2:
                continue
            word, vals = parts[0], parts[1:]
            if vals and vals[-1] == "":  # fasttext writes a trailing space
                vals = vals[:-1]
            if dim is None:
                dim = len(vals)
            elif len(vals) != dim:
                raise ValueError(
                    f"{vec_file}:{ln_no + 1}: row has {len(vals)} dims, "
                    f"expected {dim}")
            vecs[word] = np.asarray(vals, np.float32)
    if dim is None:
        raise ValueError(f"{vec_file}: no embedding rows found")
    table = np.zeros((tokenizer.vocab_size, dim), np.float32)
    hit = 0
    for i in range(3, tokenizer.vocab_size):
        piece = tokenizer._id_to_piece(i)
        row = vecs.get(piece)
        if row is None:
            row = vecs.get(piece.lower())
        if row is None and piece.startswith("▁") and len(piece) > 1:
            row = vecs.get(piece[1:])
            if row is None:
                row = vecs.get(piece[1:].lower())
        if row is not None:
            table[i] = row
            hit += 1
    print(f"[vec_table] {vec_file}: matched {hit}/{tokenizer.vocab_size - 3} "
          f"vocab pieces (dim {dim})")
    return table


def _transformer_rows(pieces, model: str) -> np.ndarray:
    """Each piece's mean last hidden state under a local transformer."""
    import torch
    from transformers import AutoModel, AutoTokenizer
    bert_tok = AutoTokenizer.from_pretrained(model)
    bert = AutoModel.from_pretrained(model).eval()
    rows = []
    with torch.no_grad():
        for piece in pieces:
            ids = bert_tok(piece, return_tensors="pt", add_special_tokens=True)
            rows.append(bert(**ids).last_hidden_state[0].mean(0).numpy())
    return np.stack(rows).astype(np.float32)


def generate_embedding(vocab_file: str, mode: str, output: str,
                       model: str | None = None, method: str = "auto",
                       dim: int = 256) -> np.ndarray:
    """Write and return the (vocab, dim) table for ``vocab_file``."""
    tok = load_text_encoder(mode, vocab_file)
    pieces = [tok._id_to_piece(i) if i >= 3 else f"<{i}>"
              for i in range(tok.vocab_size)]
    table = None
    if method in ("auto", "bert") and model:
        try:
            table = _transformer_rows(pieces, model)
        except Exception as e:  # no such local model, or no transformers
            if method == "bert":
                raise
            print(f"[bert_embedding] transformer path failed ({e}); "
                  f"falling back to hash embeddings")
    if table is None:
        table = _hash_embedding(pieces, dim)
    np.save(output, table)
    return table


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--vocab_file", required=True)
    ap.add_argument("--mode", default="character",
                    choices=["character", "word", "subword"])
    ap.add_argument("--output", required=True)
    ap.add_argument("--model", default=None)
    ap.add_argument("--method", default="auto",
                    choices=["auto", "bert", "hash"])
    ap.add_argument("--dim", type=int, default=256)
    args = ap.parse_args(argv)
    t = generate_embedding(args.vocab_file, args.mode, args.output,
                           args.model, args.method, args.dim)
    print(f"wrote {t.shape} embedding table to {args.output}")


if __name__ == "__main__":
    main()
