"""CTC loss: the log-space forward algorithm over the extended labels.

Port of the JAX package's ``ops/ctc.py``: ``extend_labels``, ``ctc_loss``
(per-utterance NLL, gradient by autograd through the time loop) and
``ctc_loss_mean``, with the same ``NEG_INF = -1e30`` arithmetic (no
infinities; the all-dead ``logaddexp3`` lane is guarded so autograd sees no
NaN). ``ctc_loss_k3`` is the same NLL through K3's analytic gradient
(``ops/cuda/ctc_kernel.py``). Shapes: log_probs (B, T, V) log-softmax,
labels (B, U) right-padded with 0, blank = 0.
"""
from __future__ import annotations

import torch

from . import cuda as cuda_kernels
from .cuda.ctc_kernel import CTCLoss, extend_labels

NEG_INF = -1e30

__all__ = ["NEG_INF", "extend_labels", "ctc_loss", "ctc_loss_mean",
           "ctc_loss_k3"]


def _logaddexp3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    all_inf = m <= NEG_INF / 2
    m_safe = torch.where(all_inf, torch.zeros_like(m), m)
    s = torch.exp(a - m_safe) + torch.exp(b - m_safe) + torch.exp(c - m_safe)
    s = torch.where(all_inf, torch.ones_like(s), s)
    return torch.where(all_inf, torch.full_like(m, NEG_INF), m_safe + torch.log(s))


def ctc_loss(log_probs: torch.Tensor, logit_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor,
             blank: int = 0) -> torch.Tensor:
    """Per-utterance negative log-likelihood, shape (B,). Rows with no
    feasible alignment give a large finite value (~1e30)."""
    B, T, V = log_probs.shape
    ext = extend_labels(labels.to(torch.int64), blank)        # (B, S)
    S = ext.shape[1]
    lab_len = label_lengths.to(torch.int64)
    ext_len = 2 * lab_len + 1
    skip_ok = torch.zeros((B, S), dtype=torch.bool, device=log_probs.device)
    skip_ok[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])
    emit = torch.gather(log_probs, 2, ext[:, None, :].expand(B, T, S))
    neg = torch.full((), NEG_INF, dtype=log_probs.dtype, device=log_probs.device)
    alpha = torch.cat([emit[:, 0, :1],
                       torch.where(lab_len[:, None] > 0, emit[:, 0, 1:2], neg),
                       neg.expand(B, S - 2)], dim=1)
    lens = logit_lengths.to(torch.int64)[:, None]
    for t in range(1, T):
        a_prev = torch.cat([neg.expand(B, 1), alpha[:, :-1]], dim=1)
        a_skip = torch.where(skip_ok, torch.cat([neg.expand(B, 2), alpha[:, :-2]],
                                                dim=1), neg)
        new = _logaddexp3(alpha, a_prev, a_skip) + emit[:, t]
        alpha = torch.where(t < lens, new, alpha)
    idx_last = torch.clamp(ext_len - 1, 0, S - 1)[:, None]
    idx_prev = torch.clamp(ext_len - 2, 0, S - 1)[:, None]
    a_last = torch.gather(alpha, 1, idx_last)[:, 0]
    a_prev = torch.gather(alpha, 1, idx_prev)[:, 0]
    a_prev = torch.where(lab_len > 0, a_prev, neg)
    return -torch.logaddexp(a_last, a_prev)


def ctc_loss_mean(log_probs, logit_lengths, labels, label_lengths,
                  blank: int = 0) -> torch.Tensor:
    """torch.nn.CTCLoss(reduction='mean', zero_infinity=True) semantics:
    each NLL over its label length, averaged over the batch; infeasible rows
    (NLL ~1e30) contribute zero, and the where zeroes their cotangent."""
    nll = ctc_loss(log_probs, logit_lengths, labels, label_lengths, blank)
    denom = torch.clamp(label_lengths, min=1).to(nll.dtype)
    return torch.mean(torch.where(nll < 1e29, nll / denom,
                                  torch.zeros_like(nll)))


def ctc_loss_k3(log_probs: torch.Tensor, logit_lengths: torch.Tensor,
                labels: torch.Tensor, label_lengths: torch.Tensor,
                blank: int = 0) -> torch.Tensor:
    """Drop-in for ``ctc_loss`` through K3's forward-backward: the kernel for
    a CUDA input (which raises unless it is f32), its plain version for CPU
    tensors or on the card with the kernels switched off."""
    use_kernel = log_probs.is_cuda and cuda_kernels.USE_KERNELS
    return CTCLoss.apply(log_probs, logit_lengths, labels, label_lengths,
                         blank, use_kernel)
