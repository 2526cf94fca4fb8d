"""Parameter construction shared by the port's modules.

Parameters start with ``requires_grad=False`` (serving); the trainer turns
gradients on with ``model.requires_grad_(True)``. They are initialised as
the JAX package initialises them: Uniform(+-1/sqrt(fan_in)) weights, zero
biases.
The numbers differ from the JAX package's for the same seed (a
``torch.Generator`` is not a ``jax.random`` key); parity tests load shared
weights instead (``utils/weights.py``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn


def uniform(shape, fan_in, generator=None, device=None) -> nn.Parameter:
    s = 1.0 / np.sqrt(max(fan_in, 1))
    t = torch.empty(shape, dtype=torch.float32)
    t.uniform_(-s, s, generator=generator)
    return nn.Parameter(t.to(device), requires_grad=False)


def const(n, value=0.0, device=None) -> nn.Parameter:
    return nn.Parameter(torch.full((n,), value, dtype=torch.float32,
                                   device=device), requires_grad=False)
