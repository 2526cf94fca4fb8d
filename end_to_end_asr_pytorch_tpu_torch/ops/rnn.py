"""Recurrent cores: LSTM / GRU cells and time-major masked scans.

Gate order follows torch (i, f, g, o for the LSTM; r, z, n for the GRU).
The LSTM keeps a single bias ``b = b_ih + b_hh``; the GRU keeps separate
biases because its n-gate applies the reset gate between them. Weights are
stored as the JAX package stores them: ``w_ih`` (D, G), ``w_hh`` (H, G).

``lstm_scan`` and ``gru_scan`` with zero initial state go through
``LSTMScan`` / ``GRUScan`` (``ops/cuda/{lstm,gru}_kernel.py``), whose
backward is the hand-written reverse-time recurrence: K2 / K2b and K4 / K4b
for a CUDA input, their plain versions for CPU tensors. With an initial
state they run the plain scan under autograd, as the JAX package does.

Under amp (bf16 inputs, the weights rounded to bf16 and kept in f32,
``ops/amp.py``) the rules are the JAX package's: every product accumulates
in f32 (``ops/amp.dot_f32``), a cell casts its new state back to the
carry's dtype, and both scans stream x_proj = (x @ w_ih + b) rounded to
bf16 through their kernels' bf16 variants with w_hh (and the GRU's b_hh)
in f32, an f32 carry and bf16 outputs, as the JAX package's TPU kernels
do. In training the scans keep bf16 residuals and return dxp in bf16 and
dW_hh (and db_hh) in f32.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from ..utils.init import const, uniform
from . import cuda as cuda_kernels
from .amp import dot_f32
from .cuda.gru_kernel import GRUScan, gru_scan_plain
from .cuda.lstm_kernel import LSTMScan, lstm_scan_plain


class LSTMWeights(nn.Module):
    """w_ih (D, 4H), w_hh (H, 4H), b (4H,). Uniform(+-1/sqrt(H)) init with
    forget-gate bias 1."""

    def __init__(self, in_dim: int, hidden: int, generator=None, device=None,
                 forget_bias: float = 1.0):
        super().__init__()
        self.w_ih = uniform((in_dim, 4 * hidden), hidden, generator, device)
        self.w_hh = uniform((hidden, 4 * hidden), hidden, generator, device)
        self.b = const(4 * hidden, 0.0, device)
        self.b[hidden:2 * hidden] = forget_bias


class GRUWeights(nn.Module):
    """w_ih (D, 3H), w_hh (H, 3H), b_ih (3H,), b_hh (3H,)."""

    def __init__(self, in_dim: int, hidden: int, generator=None, device=None):
        super().__init__()
        self.w_ih = uniform((in_dim, 3 * hidden), hidden, generator, device)
        self.w_hh = uniform((hidden, 3 * hidden), hidden, generator, device)
        self.b_ih = const(3 * hidden, 0.0, device)
        self.b_hh = const(3 * hidden, 0.0, device)


def cell_weights(module: str, in_dim: int, hidden: int, generator=None,
                 device=None) -> nn.Module:
    cls = LSTMWeights if module == "lstm" else GRUWeights
    return cls(in_dim, hidden, generator=generator, device=device)


def lstm_cell(w: LSTMWeights, h: torch.Tensor, c: torch.Tensor,
              x_proj: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step given the precomputed input projection x@w_ih + b. The
    gates accumulate in f32; the new state takes the carry's dtype."""
    H = h.shape[-1]
    gates = x_proj + dot_f32(h, w.w_hh)
    i, f, g, o = gates.split(H, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(h.dtype), c_new.to(c.dtype)


def gru_cell(w: GRUWeights, h: torch.Tensor, x_proj: torch.Tensor
             ) -> torch.Tensor:
    """One GRU step given x_proj = x@w_ih + b_ih (torch gate order r, z, n)."""
    H = h.shape[-1]
    h_proj = dot_f32(h, w.w_hh) + w.b_hh
    r = torch.sigmoid(x_proj[..., :H] + h_proj[..., :H])
    z = torch.sigmoid(x_proj[..., H:2 * H] + h_proj[..., H:2 * H])
    n = torch.tanh(x_proj[..., 2 * H:] + r * h_proj[..., 2 * H:])
    return ((1.0 - z) * n + z * h).to(h.dtype)


def lstm_scan(w: LSTMWeights, x: torch.Tensor, mask: torch.Tensor,
              reverse: bool = False, h0=None, c0=None) -> torch.Tensor:
    """x (T, B, D) time-major, mask (T, B) bool (a contiguous valid prefix
    per sequence) -> (T, B, H) in x's dtype. Padded steps emit zeros and
    hold the carry."""
    x_proj = dot_f32(x, w.w_ih) + w.b
    if h0 is None and c0 is None:
        use_kernel = x.is_cuda and cuda_kernels.USE_KERNELS
        return LSTMScan.apply(x_proj.to(x.dtype).contiguous(),
                              w.w_hh.contiguous(),
                              mask.contiguous(), reverse, use_kernel)
    return lstm_scan_plain(x_proj, w.w_hh, mask, reverse, h0, c0)


def gru_scan(w: GRUWeights, x: torch.Tensor, mask: torch.Tensor,
             reverse: bool = False, h0=None) -> torch.Tensor:
    """GRU analogue of lstm_scan: x_proj = x @ w_ih + b_ih, b_hh applied
    inside the recurrence (its n third under the reset gate)."""
    x_proj = dot_f32(x, w.w_ih) + w.b_ih
    if h0 is None:
        use_kernel = x.is_cuda and cuda_kernels.USE_KERNELS
        return GRUScan.apply(x_proj.to(x.dtype).contiguous(),
                             w.w_hh.contiguous(), w.b_hh.contiguous(),
                             mask.contiguous(), reverse, use_kernel)
    return gru_scan_plain(x_proj, w.w_hh, w.b_hh, mask, reverse, h0)


def bidirectional(scan_fn, w_fwd, w_bwd, x: torch.Tensor, mask: torch.Tensor,
                  **kw) -> torch.Tensor:
    """Concat forward and (length-aware) backward passes: (T, B, 2H)."""
    fwd = scan_fn(w_fwd, x, mask, reverse=False, **kw)
    bwd = scan_fn(w_bwd, x, mask, reverse=True, **kw)
    return torch.cat([fwd, bwd], dim=-1)
