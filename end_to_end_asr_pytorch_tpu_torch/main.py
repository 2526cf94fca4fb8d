"""Entry point of the port, the JAX package's ``main.py``: the same flags and
defaults, the same dispatch.

  python -m end_to_end_asr_pytorch_tpu_torch.main --config config/libri/asr_example.yaml          # train ASR
  python -m end_to_end_asr_pytorch_tpu_torch.main --config config/libri/lm_example.yaml --lm      # train LM
  python -m end_to_end_asr_pytorch_tpu_torch.main --config config/libri/asr_example.yaml --test \\
      --load ckpt/asr_example_sd0/best_att.pth [--outdir result/]                  # decode dev / test

Training writes ``<ckpdir>/<name>_sd<seed>/{latest,best_att,best_ctc}.pth``
in the reference checkpoint layout and logs to
``<logdir>/<name>_sd<seed>/log.jsonl``; ``--lm`` trains an RNN-LM on text
and writes ``best_ppx.pth`` / ``latest.pth`` there, the files
``decode.lm_path`` takes. ``--test`` decodes the dev and test
splits with the ``decode:`` block (beam search with CTC prefix scoring and
RNN-LM shallow fusion from ``decode.lm_config`` / ``decode.lm_path`` when
``lm_weight > 0``; greedy CTC for a CTC-only model) and writes
``<outdir>/<name>_sd<seed>/{dev,test}_{output,beam}.csv``. ``--load`` takes a
reference-layout torch checkpoint or one the JAX package wrote (its native
file or its orbax directory); training resumes the weights, the optimizer
state (optax's, mapped by ``utils/optax_state.py``) and the step of either
package's checkpoints, and ``ckpt_format: orbax`` writes the optimizer as
the optax tree the JAX package resumes from. Runs on the
card unless ``--cpu`` is given (no card is an error). ``--amp`` trains the
ASR in bf16 (as ``hparas.amp: True``; ``--test`` and ``--lm`` ignore it, as
the JAX package's decode and LM solvers do). ``--cudnn-ctc`` and
``--no-pin`` are accepted for compatibility and ignored.

Data parallel over N cards (or N CPU processes with ``--cpu``), one
process per card, each mode as above:

  python -m torch.distributed.run --standalone --nproc_per_node=N \
      -m end_to_end_asr_pytorch_tpu_torch.main --config ... [--lm | --test]

``corpus.batch_size`` stays the global batch: each rank takes its rows,
the losses are normalised over the global batch and the gradients summed
(NCCL on the card, gloo on the CPU), so a step equals the one-process
step. Rank 0 alone prints, logs and writes checkpoints and decode CSVs.

Tensor parallel with ``model_parallel: M`` in the yaml (M dividing the
number of processes N, else ``ValueError``), in all three modes: the N
ranks form N / M data groups of M; the ranks of a model group decode or
train the same rows, each holding 1/M of the vocabulary heads, the
embeddings, the recurrent and attention weights and their optimizer
slots (the JAX package's placement rule); checkpoints hold whole tensors
and load at any M.
"""
from __future__ import annotations

import argparse
import random

import numpy as np
import torch

from .config import load_config
from .parallel import mesh


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--config", required=True, help="experiment yaml")
    ap.add_argument("--name", default=None, help="override experiment name")
    ap.add_argument("--logdir", default="log/", help="log directory")
    ap.add_argument("--ckpdir", default="ckpt/", help="checkpoint directory")
    ap.add_argument("--outdir", default="result/", help="decode output dir")
    ap.add_argument("--load", default=None,
                    help="checkpoint to load/resume (weights, optimizer "
                         "state and step, from either package's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cudnn-ctc", action="store_true",
                    help="(compatibility flag, ignored)")
    ap.add_argument("--njobs", type=int, default=1,
                    help="threads assembling batches")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--no-pin", action="store_true",
                    help="(compatibility flag, ignored)")
    ap.add_argument("--test", action="store_true", help="beam-decode mode")
    ap.add_argument("--no-msg", action="store_true", help="quiet console")
    ap.add_argument("--lm", action="store_true", help="train RNN-LM")
    ap.add_argument("--amp", action="store_true",
                    help="bf16 ASR training (hparas.amp); --test and --lm "
                         "ignore it")
    return ap


def main(argv=None):
    paras = build_parser().parse_args(argv)
    random.seed(paras.seed)
    np.random.seed(paras.seed)
    torch.manual_seed(paras.seed)
    config = load_config(paras.config)
    if paras.lm:
        from .solvers.train_lm import Solver
    elif paras.test:
        from .solvers.test_asr import Solver
    else:
        from .solvers.train_asr import Solver
    solver = Solver(config, paras)
    try:
        if not solver.quiet():
            dev = solver.device
            name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu")
            world = (f" | world {solver.world} ({mesh.backend()})"
                     if mesh.active() else "")
            print(f"[device] {dev} ({name}){world}", flush=True)
        solver.load_data()
        solver.set_model()
        return solver.exec()
    finally:
        mesh.shutdown()


if __name__ == "__main__":
    main()
