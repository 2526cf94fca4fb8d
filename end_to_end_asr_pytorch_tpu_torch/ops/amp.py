"""Amp (bf16) for decoding and training: the JAX package's
mixed-precision rules.

Under amp the JAX package keeps parameters and activations in bf16 and
writes every product with ``preferred_element_type=float32``: the products
of bf16 values are exact in f32, they are summed in f32, and the result is
f32. ``torch.matmul`` on bf16 returns bf16, which would round scores near
-100 to steps of 0.5, so each such product in the port goes through
``dot_f32`` (TF32 stays off, as in every entry point). On f32 operands it is
the plain product.

The parameters of an amp call are rounded to bf16 once and kept as f32
(``bf16_rounded_copy``): each product then reads its weight as it is, with
the same values as a bf16 weight widened exactly, so no step widens a
weight again. What the JAX package stores in bf16 besides its parameters
(the features, the encoder's activations, the decoder and LM states, the
attention keys and values, the CTC probs and the lookup tables) is bf16 or
rounded to bf16 where the port makes it.

Amp training (``hparas.amp`` / ``--amp``) follows the JAX solver's
``_cast_bf16``: every floating parameter is rounded to bf16 for the step's
forward (``bf16_call``), kept in f32 as for decoding, through a
differentiable rounding: the uses' gradients are summed in f32 and the sum
reaches the f32 parameter rounded to bf16 once. (JAX rounds each use's
gradient and sums the uses in bf16; over the 96 label steps of a training
step those sums drift by about 1%, and the kernels' bf16 ulps move them.)
What the JAX package derives in bf16 from a bf16 parameter is rounded
where the port makes it: the activations (from the bf16 features), the
attention cache, the location features of the training step and the
decoder's lookup table. The optimizer and its state keep the f32
parameters.
"""
from __future__ import annotations

import copy

import torch
import torch.nn as nn
from torch.func import functional_call


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b accumulated and returned in f32 (operands widened exactly)."""
    return a.float() @ b.float()


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 and kept in f32."""
    return x.to(torch.bfloat16).float()


def bf16_rounded_copy(module: nn.Module) -> nn.Module:
    """A copy of ``module`` whose floating parameters are rounded to bf16
    and kept as f32; ``module`` itself is left as it is."""
    memo = {id(p): nn.Parameter(round_bf16(p.detach()), requires_grad=False)
            for p in module.parameters() if p.is_floating_point()}
    return copy.deepcopy(module, memo)


def bf16_call(module: nn.Module, *args, **kwargs):
    """``module(*args, **kwargs)`` with every floating parameter rounded to
    bf16 and kept in f32; differentiable, so gradients reach the f32
    parameters through the rounding."""
    params = {n: round_bf16(p) for n, p in module.named_parameters()
              if p.is_floating_point()}
    return functional_call(module, params, args, kwargs)


class _TanhBf16(torch.autograd.Function):
    """tanh of a bf16 tensor whose backward rounds where JAX's autodiff of
    ``tanh`` rounds in bf16: its JVP is (g + g y)(1 - y), so the cotangent
    is t = bf16(g bf16(1 - y)), then bf16(t + bf16(t y)). PyTorch's own
    ``tanh`` backward rounds g (1 - y^2) once; under the attention's
    softmax the terms of the query's gradient nearly cancel, so the two
    roundings leave gradients that differ by tens of percent."""

    @staticmethod
    def forward(ctx, x):
        y = torch.tanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        t = g * (1.0 - y)
        return t + t * y


def tanh(x: torch.Tensor) -> torch.Tensor:
    """``torch.tanh``; for bf16 (amp) its gradient rounds as in JAX."""
    return _TanhBf16.apply(x) if x.dtype == torch.bfloat16 else torch.tanh(x)
