"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. A missing
card is an error, never a quiet fall back to the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card. Sets full-f32 matmul/conv numerics (TF32
    off) so results are held to the JAX reference at f32."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or --cpu) to run on "
            "the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
