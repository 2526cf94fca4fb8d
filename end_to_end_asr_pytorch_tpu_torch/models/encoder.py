"""Listener / encoder: VGG or CNN prenet + pyramidal (Bi)RNN stack.

Same configuration schema and numerics as the JAX package's encoder:
``prenet: 'vgg' | 'cnn' | ''``; per-layer ``module``, ``bidirection``,
``dim``, ``dropout``, ``layer_norm``, ``proj`` and pyramidal
``sample_rate`` with ``sample_style 'drop' | 'concat'``. Dropout runs only
with ``train=True``, its masks drawn from the caller's ``torch.Generator``.

VGG layout follows the JAX package: features reshape to
(B, T, in_ch, freq), the 3x3 convs treat time as height and frequency as
width, the 2x2 max-pools floor (``F.max_pool2d``, the same values as the
JAX package's ``reduce_window``), and the output is flattened
channel-major.
The feat_dim split: divisible by 13 => feat_dim/13 channels of 13 bins,
else divisible by 40 => feat_dim/40 channels of 40 bins.

The forward runs in the dtype of its input: under amp (bf16 features, the
weights rounded to bf16; in decoding and, under autograd, in training) the
convolutions (each bias added after its conv), pooling, layer norm and the
LSTM outputs are bf16, and the projection accumulates in f32, as in the
JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import rnn as rnn_ops
from ..ops.amp import dot_f32
from ..parallel import mesh
from ..utils.init import const, uniform


def _as_list(v, n):
    if isinstance(v, (list, tuple)):
        if len(v) != n:
            raise ValueError(f"config list length {len(v)} != layers {n}")
        return list(v)
    return [v] * n


def dropout(h: torch.Tensor, rate: float, generator: torch.Generator
            ) -> torch.Tensor:
    """Inverted dropout, keep mask drawn from ``generator`` (on h's device)
    at the global batch's shape (``parallel/mesh.rand``: h's batch axis is
    0, or 1 within ``mesh.time_major``). A training step must pass its
    generator: without one it raises rather than train with no dropout."""
    if generator is None:
        raise ValueError(f"dropout {rate} in a training step needs a "
                         "torch.Generator")
    keep = 1.0 - rate
    u = mesh.rand(h.shape, generator, h.device)
    return h * (u < keep).to(h.dtype) / keep


def same_pad(length: int, kernel: int, stride: int):
    """XLA 'SAME' padding (low, high) along one axis: for an even kernel
    or a stride the padding is asymmetric, one more on the high side."""
    out = -(-length // stride)
    total = max((out - 1) * stride + kernel - length, 0)
    return total // 2, total - total // 2


def _conv2d(h: torch.Tensor, k: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3x3 'SAME' conv in h's dtype, then the bias added in h's dtype, as
    the JAX package adds it (under amp: two bf16 roundings)."""
    return (F.conv2d(h, k.to(h.dtype), padding=1)
            + b.to(h.dtype)[:, None, None])


class VGGExtractor(nn.Module):
    """2 blocks of (conv3x3, conv3x3, maxpool2x2): time/4, freq/4. Conv
    weights are stored OIHW (H = time, W = frequency)."""

    def __init__(self, feat_dim: int, generator=None, device=None):
        super().__init__()
        if feat_dim % 13 == 0:
            self.in_ch, self.freq = feat_dim // 13, 13
        elif feat_dim % 40 == 0:
            self.in_ch, self.freq = feat_dim // 40, 40
        else:
            self.in_ch, self.freq = 1, feat_dim
        f4 = self.freq // 4
        self.out_dim = 128 * (f4 if f4 > 0 else 1)
        for i, (cin, cout) in enumerate(((self.in_ch, 64), (64, 64),
                                         (64, 128), (128, 128)), 1):
            setattr(self, f"k{i}", uniform((cout, cin, 3, 3), 9 * cin,
                                            generator, device))
            setattr(self, f"b{i}", const(cout, 0.0, device))

    def forward(self, x: torch.Tensor, x_len: torch.Tensor):
        B, T, _ = x.shape
        h = x.reshape(B, T, self.in_ch, self.freq).permute(0, 2, 1, 3)
        h = F.relu(_conv2d(h, self.k1, self.b1))
        h = F.relu(_conv2d(h, self.k2, self.b2))
        h = F.max_pool2d(h, 2)
        h = F.relu(_conv2d(h, self.k3, self.b3))
        h = F.relu(_conv2d(h, self.k4, self.b4))
        h = F.max_pool2d(h, 2)                       # (B, C, T4, F4)
        B, C, T4, F4 = h.shape
        out = h.permute(0, 2, 1, 3).reshape(B, T4, C * F4)
        return out, x_len // 4


class CNNExtractor(nn.Module):
    """1-D conv downsampler: two stride-2 kernel-4 convs => time/4. Weights
    stored (out, in, k)."""

    def __init__(self, feat_dim: int, out_dim: int, generator=None,
                 device=None):
        super().__init__()
        self.out_dim = out_dim
        self.k1 = uniform((out_dim, feat_dim, 4), 4 * feat_dim, generator,
                           device)
        self.b1 = const(out_dim, 0.0, device)
        self.k2 = uniform((out_dim, out_dim, 4), 4 * out_dim, generator,
                           device)
        self.b2 = const(out_dim, 0.0, device)

    def forward(self, x: torch.Tensor, x_len: torch.Tensor):
        h = x.transpose(1, 2)                         # (B, D, T)
        for k, b in ((self.k1, self.b1), (self.k2, self.b2)):
            h = F.conv1d(F.pad(h, same_pad(h.shape[-1], 4, 2)), k.to(h.dtype),
                         stride=2) + b.to(h.dtype)[:, None]
            h = F.relu(h)
        return h.transpose(1, 2), x_len // 4


class RNNLayer(nn.Module):
    """One (Bi)RNN layer + optional layer norm / projection + subsampling."""

    def __init__(self, in_dim: int, module: str, dim: int, bidirection: bool,
                 dropout: float, layer_norm: bool, sample_rate: int,
                 sample_style: str, proj: bool, generator=None, device=None):
        super().__init__()
        self.dropout = float(dropout)
        if sample_style not in ("drop", "concat"):
            raise ValueError(f"unsupported sample_style {sample_style!r}")
        self.module = module.lower()
        self.sample_rate = int(sample_rate)
        self.sample_style = sample_style
        rnn_out = dim * (2 if bidirection else 1)
        self.out_dim = rnn_out * (self.sample_rate if (
            self.sample_rate > 1 and sample_style == "concat") else 1)
        self.fwd = rnn_ops.cell_weights(self.module, in_dim, dim, generator,
                                        device)
        self.bwd = (rnn_ops.cell_weights(self.module, in_dim, dim, generator,
                                         device) if bidirection else None)
        self.ln_scale = self.ln_bias = self.w_proj = self.b_proj = None
        if layer_norm:
            self.ln_scale = const(rnn_out, 1.0, device)
            self.ln_bias = const(rnn_out, 0.0, device)
        if proj:
            self.w_proj = uniform((rnn_out, rnn_out), rnn_out, generator,
                                   device)
            self.b_proj = const(rnn_out, 0.0, device)

    def forward(self, x: torch.Tensor, x_len: torch.Tensor, train=False,
                generator=None):
        """x (B, T, D) -> (B, T', out_dim), new lengths."""
        xt = x.transpose(0, 1)                        # (T, B, D)
        T = xt.shape[0]
        mask = torch.arange(T, device=x.device)[:, None] < x_len[None, :]
        scan = rnn_ops.lstm_scan if self.module == "lstm" else rnn_ops.gru_scan
        if self.bwd is not None:
            h = rnn_ops.bidirectional(scan, self.fwd, self.bwd, xt, mask)
        else:
            h = scan(self.fwd, xt, mask)
        h = h.transpose(0, 1)                         # (B, T, rnn_out)
        if self.ln_scale is not None:
            mu = h.mean(-1, keepdim=True)
            var = h.var(-1, unbiased=False, keepdim=True)
            h = ((h - mu) * torch.rsqrt(var + 1e-5) * self.ln_scale.to(h.dtype)
                 + self.ln_bias.to(h.dtype))
        if train and self.dropout > 0:
            h = dropout(h, self.dropout, generator)
        if self.w_proj is not None:
            h = torch.tanh(dot_f32(h, self.w_proj) + self.b_proj)
        if self.sample_rate > 1:
            r = self.sample_rate
            Bc, Tc, Dc = h.shape
            if self.sample_style == "drop":
                h = h[:, ::r]
                x_len = (x_len + r - 1) // r
            else:
                Tt = (Tc // r) * r
                h = h[:, :Tt].reshape(Bc, Tt // r, Dc * r)
                x_len = x_len // r
        return h, x_len


class Encoder(nn.Module):
    def __init__(self, feat_dim: int, cfg: Dict[str, Any], generator=None,
                 device=None):
        super().__init__()
        prenet = cfg.get("prenet", "")
        module = cfg.get("module", "LSTM")
        dims: List[int] = (list(cfg["dim"]) if isinstance(cfg["dim"], (list, tuple))
                           else [cfg["dim"]])
        n = len(dims)
        bidir = bool(cfg.get("bidirection", True))
        drop = _as_list(cfg.get("dropout", 0.0), n)
        layer_norm = _as_list(cfg.get("layer_norm", False), n)
        proj = _as_list(cfg.get("proj", False), n)
        sample_rate = _as_list(cfg.get("sample_rate", 1), n)
        sample_style = cfg.get("sample_style", "drop")
        in_dim = feat_dim
        if prenet == "vgg":
            self.prenet = VGGExtractor(feat_dim, generator, device)
            in_dim = self.prenet.out_dim
        elif prenet == "cnn":
            self.prenet = CNNExtractor(feat_dim, dims[0], generator, device)
            in_dim = dims[0]
        elif prenet in ("", None, "none"):
            self.prenet = None
        else:
            raise NotImplementedError(f"prenet {prenet!r}")
        layers = []
        for i in range(n):
            layer = RNNLayer(in_dim, module, dims[i], bidir, drop[i],
                             layer_norm[i],
                             sample_rate[i], sample_style, proj[i],
                             generator, device)
            layers.append(layer)
            in_dim = layer.out_dim
        self.layers = nn.ModuleList(layers)
        self.out_dim = in_dim

    def forward(self, feat: torch.Tensor, feat_len: torch.Tensor,
                train: bool = False, generator=None):
        h, h_len = feat, feat_len
        if self.prenet is not None:
            h, h_len = self.prenet(h, h_len)
        for layer in self.layers:
            h, h_len = layer(h, h_len, train=train, generator=generator)
        T = h.shape[1]
        mask = (torch.arange(T, device=h.device)[None, :] < h_len[:, None])[..., None]
        return torch.where(mask, h, torch.zeros((), device=h.device)), h_len
