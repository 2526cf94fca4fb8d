"""CLI: generate the synthetic tone corpus (LibriSpeech layout), the port's
copy of the JAX package's ``data/make_synthetic.py`` (the same flags and
defaults, the same files through the port's ``data/synthetic.py``).

  python -m end_to_end_asr_pytorch_tpu_torch.data.make_synthetic \
      --out data/synth [--n_train 512 --n_dev 64 --n_test 64 --seed 0]
"""
import argparse

from .synthetic import generate_corpus


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--n_train", type=int, default=512)
    ap.add_argument("--n_dev", type=int, default=64)
    ap.add_argument("--n_test", type=int, default=64)
    ap.add_argument("--min_words", type=int, default=1)
    ap.add_argument("--max_words", type=int, default=3)
    ap.add_argument("--word_inventory", type=int, default=0,
                    help="generate this many pseudo-words instead of the "
                         "14 NATO words (subword-vocab corpora)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grammar", default="", choices=["", "bigram"],
                    help="word-order structure (LM-fusion demonstration)")
    ap.add_argument("--branch", type=int, default=4,
                    help="bigram grammar branching factor")
    ap.add_argument("--homophones", type=int, default=0,
                    help="pairs of words rendered with identical audio")
    ap.add_argument("--text_only", type=int, default=0,
                    help="extra grammar-sampled sentences -> lm_text.txt")
    ap.add_argument("--uniform_train", action="store_true",
                    help="keep UNIFORM word order in train-clean (grammar "
                         "applies to dev/test/lm_text only)")
    args = ap.parse_args(argv)
    root = generate_corpus(args.out, args.n_train, args.n_dev, args.n_test,
                           args.seed, args.min_words, args.max_words,
                           word_inventory=args.word_inventory,
                           grammar=args.grammar, branch=args.branch,
                           homophones=args.homophones,
                           text_only=args.text_only,
                           grammar_in_train=not args.uniform_train)
    print(f"synthetic corpus at {root} "
          f"({args.n_train}/{args.n_dev}/{args.n_test} utts)")
    return root


if __name__ == "__main__":
    main()
