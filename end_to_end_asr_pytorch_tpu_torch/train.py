"""ASR training entry point of the port.

  python -m end_to_end_asr_pytorch_tpu_torch.train --config config/synthetic/las.yaml \\
      [--name NAME] [--logdir log/] [--ckpdir ckpt/] [--load ckpt.pth] \\
      [--seed 0] [--njobs 1] [--no-msg] [--cpu]

The ASR-training flags of the JAX package's ``main.py``, the same YAML
schema. Runs on the card unless ``--cpu`` is given (no card is an error).
Writes ``<ckpdir>/<name>_sd<seed>/{latest,best_att,best_ctc}.pth`` in the
reference checkpoint layout, which ``--load`` resumes (weights, optimizer
state, step) and the port's ``transcribe`` decodes, and logs to
``<logdir>/<name>_sd<seed>/log.jsonl``. ``--amp`` (bf16 training) and
``--lm`` (RNN-LM training) are not ported yet and raise.
"""
from __future__ import annotations

import argparse
import random

import numpy as np
import torch

from .config import load_config
from .solvers.train_asr import Solver


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--config", required=True, help="experiment yaml")
    ap.add_argument("--name", default=None, help="override experiment name")
    ap.add_argument("--logdir", default="log/", help="log directory")
    ap.add_argument("--ckpdir", default="ckpt/", help="checkpoint directory")
    ap.add_argument("--load", default=None, help="checkpoint to resume")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--njobs", type=int, default=1,
                    help="threads assembling batches")
    ap.add_argument("--no-msg", action="store_true", help="quiet console")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--amp", action="store_true", help="(not ported yet)")
    ap.add_argument("--lm", action="store_true", help="(not ported yet)")
    return ap


def main(argv=None):
    paras = build_parser().parse_args(argv)
    if paras.amp:
        raise NotImplementedError("--amp (bf16 training) is not ported yet")
    if paras.lm:
        raise NotImplementedError("--lm (RNN-LM training) is not ported yet")
    random.seed(paras.seed)
    np.random.seed(paras.seed)
    torch.manual_seed(paras.seed)
    config = load_config(paras.config)
    solver = Solver(config, paras)
    if not paras.no_msg:
        dev = solver.device
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        print(f"[device] {dev} ({name})", flush=True)
    solver.load_data()
    solver.set_model()
    return solver.exec()


if __name__ == "__main__":
    main()
