"""Decode-time amp (bf16): the JAX package's mixed-precision rules.

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
"""
from __future__ import annotations

import copy

import torch
import torch.nn as nn


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
