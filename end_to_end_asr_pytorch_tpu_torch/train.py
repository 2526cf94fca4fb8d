"""ASR training entry point of the port: an alias of ``main`` (the same
parser, flags and dispatch).

  python -m end_to_end_asr_pytorch_tpu_torch.train --config config/synthetic/las.yaml \\
      [--name NAME] [--logdir log/] [--ckpdir ckpt/] [--load ckpt.pth] \\
      [--seed 0] [--njobs 1] [--no-msg] [--cpu]

Over N cards, one process each (``main``'s docstring has the details):

  python -m torch.distributed.run --standalone --nproc_per_node=N \
      -m end_to_end_asr_pytorch_tpu_torch.train --config ...
"""
from __future__ import annotations

from .main import build_parser, main

__all__ = ["build_parser", "main"]

if __name__ == "__main__":
    main()
