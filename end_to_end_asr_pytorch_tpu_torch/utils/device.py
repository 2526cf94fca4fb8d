"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. A missing
card is an error, never a quiet fall back to the CPU. Under ``torchrun``
(one process per card) "the card" is ``cuda:$LOCAL_RANK``, made the current
device, which the NCCL object collectives use.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card (``cuda:$LOCAL_RANK`` when that is set).
    Sets full-f32 matmul/conv numerics (TF32 off) so results are held to
    the JAX reference at f32."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or --cpu) to run on "
            "the CPU")
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
