"""The arithmetic the plain reference computes in.

``Numerics("f32")`` is the reference itself: float32 with TF32 off for
cuBLAS and cuDNN. The other modes are the controls, the reference put in
the program's place one precision below what a configuration states:

- ``"tf32"``: float32 storage with TF32 allowed in every matrix product and
  convolution (the control of a float32 configuration);
- ``"fp8"``: every operand of a matrix product or convolution, and every
  recurrent state a step stores (h and c of each LSTM step, as the
  program stores its in bf16), rounded to float8 e4m3 with one scale per
  tensor (its largest magnitude mapped to 448), the gradient passed
  straight through (the control of a bfloat16 configuration).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

MODES = ("f32", "tf32", "fp8")
E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, E4M3_MAX / amax, torch.ones_like(amax))
    q = (x.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x.detach())


class Numerics:
    def __init__(self, mode: str = "f32"):
        if mode not in MODES:
            raise ValueError(f"numerics {mode!r}: want one of {MODES}")
        self.mode = mode

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product, or a stored state, as this mode rounds
        it."""
        return _fp8(x) if self.mode == "fp8" else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    def conv2d(self, x, w, padding):
        return F.conv2d(self.q(x), self.q(w), padding=padding)

    def conv1d(self, x, w):
        return F.conv1d(self.q(x), self.q(w))

    @contextlib.contextmanager
    def flags(self):
        """TF32 on in ``"tf32"`` mode and off otherwise, for the block; the
        caller's flags are restored after it."""
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        on = self.mode == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield self
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old
