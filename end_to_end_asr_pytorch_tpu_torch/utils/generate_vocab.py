"""Offline vocabulary and subword-model generation: the port's copy of the
repository's ``util/generate_vocab_file.py``, on the port's own
``utils/text.py`` and ``utils/sentencepiece_model.py``. For the same input
it writes the same bytes.

    python -m end_to_end_asr_pytorch_tpu_torch.utils.generate_vocab \
        --input_file text.txt --mode character --output_file vocab.txt
    ... --mode word --output_file vocab.txt --vocab_size 5000
    ... --mode subword --output_file bpe.json --vocab_size 1000
    ... --mode subword --output_file bpe.model --vocab_size 1000 --format spm

``--mode subword`` trains a BPE (characters with a word-boundary marker on
each word's first, the most frequent adjacent pair merged until the
vocabulary reaches ``--vocab_size``) and writes the JSON model that
``SubwordTextEncoder`` reads, or with ``--format spm`` a binary
sentencepiece ``.model`` (unigram scores = log piece frequency under the
trained segmentation) that this package's tokenizer and sentencepiece both
read.
"""
import argparse
import collections
import json
import math
from typing import List, Optional

from .sentencepiece_model import (TYPE_CONTROL, TYPE_NORMAL, TYPE_UNKNOWN,
                                  serialize_model_proto)
from .text import SubwordTextEncoder, TextEncoder

RESERVED = TextEncoder.RESERVED
BOUNDARY = SubwordTextEncoder.BOUNDARY


def read_lines(path):
    with open(path, "r", encoding="utf-8") as f:
        return [ln.strip() for ln in f if ln.strip()]


def gen_char_vocab(lines):
    counter = collections.Counter()
    for ln in lines:
        counter.update(ln.replace(" ", "\x00"))
    chars = ["<space>" if c == "\x00" else c for c, _ in counter.most_common()]
    return chars


def gen_word_vocab(lines, vocab_size):
    counter = collections.Counter()
    for ln in lines:
        counter.update(ln.split())
    words = [w for w, _ in counter.most_common()]
    if vocab_size:
        words = words[: max(0, vocab_size - len(RESERVED))]
    return words


def train_bpe(lines, vocab_size):
    """Classic BPE: start from characters (with word-boundary marker on the
    first char of each word), greedily merge the most frequent adjacent pair
    until the vocab reaches ``vocab_size``."""
    word_freq = collections.Counter()
    for ln in lines:
        word_freq.update(ln.split())
    # each word as a tuple of pieces
    words = {w: tuple([BOUNDARY + w[0]] + list(w[1:])) for w in word_freq}
    vocab = set()
    for pieces in words.values():
        vocab.update(pieces)
    merges = []
    while len(vocab) + len(RESERVED) < vocab_size:
        pair_freq = collections.Counter()
        for w, pieces in words.items():
            f = word_freq[w]
            for i in range(len(pieces) - 1):
                pair_freq[(pieces[i], pieces[i + 1])] += f
        if not pair_freq:
            break
        (a, b), cnt = pair_freq.most_common(1)[0]
        if cnt < 2:
            break
        merges.append([a, b])
        merged = a + b
        vocab.add(merged)
        new_words = {}
        for w, pieces in words.items():
            out, i = [], 0
            while i < len(pieces):
                if i + 1 < len(pieces) and pieces[i] == a and pieces[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(pieces[i])
                    i += 1
            new_words[w] = tuple(out)
        words = new_words
    # order vocab by frequency of use under the final segmentation
    use = collections.Counter()
    for w, pieces in words.items():
        for p in pieces:
            use[p] += word_freq[w]
    ordered = [p for p, _ in use.most_common()]
    ordered += sorted(vocab - set(ordered))
    return ordered, merges, use


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input_file", required=True)
    ap.add_argument("--output_file", required=True)
    ap.add_argument("--mode", required=True, choices=["character", "word", "subword"])
    ap.add_argument("--vocab_size", type=int, default=5000)
    ap.add_argument("--format", default="json", choices=["json", "spm"],
                    help="subword model format: json (this repo's BPE) or "
                         "spm (binary sentencepiece-compatible unigram)")
    args = ap.parse_args(argv)

    lines = read_lines(args.input_file)
    if args.mode == "character":
        with open(args.output_file, "w", encoding="utf-8") as f:
            f.write("\n".join(gen_char_vocab(lines)) + "\n")
    elif args.mode == "word":
        with open(args.output_file, "w", encoding="utf-8") as f:
            f.write("\n".join(gen_word_vocab(lines, args.vocab_size)) + "\n")
    elif args.format == "json":
        pieces, merges, _ = train_bpe(lines, args.vocab_size)
        model = {"vocab": RESERVED + pieces, "merges": merges}
        with open(args.output_file, "w", encoding="utf-8") as f:
            json.dump(model, f, ensure_ascii=False)
    else:  # spm: binary sentencepiece ModelProto, unigram scores
        pieces, merges, use = train_bpe(lines, args.vocab_size)
        total = max(sum(use.values()), 1)
        floor = math.log(0.5 / total)  # unseen pieces: below every real one
        entries = [("<pad>", 0.0, TYPE_CONTROL), ("</s>", 0.0, TYPE_CONTROL),
                   ("<unk>", 0.0, TYPE_UNKNOWN)]
        for piece in pieces:
            score = (math.log(use[piece] / total) if use[piece] > 0
                     else floor)
            entries.append((piece, score, TYPE_NORMAL))
        with open(args.output_file, "wb") as f:
            f.write(serialize_model_proto(entries))
    print(f"wrote {args.mode} model to {args.output_file}")


if __name__ == "__main__":
    main()
