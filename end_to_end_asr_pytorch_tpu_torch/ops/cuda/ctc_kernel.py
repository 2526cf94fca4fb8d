"""K3: CTC forward-backward (loss and analytic gradient) — wrapper for
``csrc/ctc_loss.cu``, its plain PyTorch version, and the autograd Function.

Replaces ``end_to_end_asr_pytorch_tpu/ops/pallas/ctc_kernel.py``:
``_prepare`` (here ``prepare``: the emission-lattice gather, skip mask and
end states, in PyTorch), ``_kernel`` / ``_run_kernel`` (here the CUDA kernel:
alpha lattice, per-row NLL, beta walk fused with the gradient
``-exp(alpha + beta - logZ)``) and ``_ctc_bwd`` (here ``CTCLoss.backward``:
the (B, T, S) gradient scattered to (B, T, V) with ``scatter_add_`` and
scaled by the incoming cotangent). On the H100 the kernel is bound by its T
serial lattice steps, not by bytes (see the CUDA source). The 128-lane
padding of S and the batch tile are TPU layout devices and are not carried.

Arithmetic follows the TPU kernel exactly: the ``-1e30`` sentinel and
``_lse3``, no infinities; infeasible rows (logZ == -1e30) and frames at or
past a row's length get exactly zero gradient.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

NEG_INF = -1e30
MAX_STATES = 1024   # one thread per lattice state, one block per utterance
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ctc_smem_bytes": (ctypes.c_size_t, [_I, _I, _I]),
    "ctc_max_smem": (_I, [ctypes.POINTER(_I)]),
    "ctc_launch": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
}


def extend_labels(labels: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """(B, U) -> (B, 2U+1) with blanks interleaved: [b, l1, b, l2, ..., b]."""
    B, U = labels.shape
    ext = torch.full((B, 2 * U + 1), blank, dtype=labels.dtype,
                     device=labels.device)
    ext[:, 1::2] = labels
    return ext


def prepare(log_probs: torch.Tensor, labels: torch.Tensor,
            label_lengths: torch.Tensor, blank: int = 0):
    """-> emit (B, T, S) f32 (states at or past 2L+1 set to -1e30), skip
    (B, S) f32, end_idx (B, 2) int32 (last state, the one before it), ext
    (B, S) int64."""
    B, T, V = log_probs.shape
    ext = extend_labels(labels.to(torch.int64), blank)
    S = ext.shape[1]
    ext_len = 2 * label_lengths.to(torch.int64) + 1
    skip = torch.zeros((B, S), dtype=torch.float32, device=log_probs.device)
    skip[:, 2:] = ((ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])).float()
    emit = torch.gather(log_probs, 2, ext[:, None, :].expand(B, T, S))
    lane = torch.arange(S, device=log_probs.device)
    live = (lane[None, :] < ext_len[:, None])[:, None, :]
    emit = torch.where(live, emit, torch.full((), NEG_INF, device=emit.device))
    end_idx = torch.stack([ext_len - 1, ext_len - 2], dim=1).to(torch.int32)
    return emit.contiguous(), skip, end_idx, ext


def _lse3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    dead = m <= NEG_INF / 2
    ms = torch.where(dead, torch.zeros_like(m), m)
    s = torch.exp(a - ms) + torch.exp(b - ms) + torch.exp(c - ms)
    return torch.where(dead, torch.full_like(m, NEG_INF),
                       ms + torch.log(torch.clamp(s, min=1e-37)))


def _shift(a: torch.Tensor, n: int, left: bool = False) -> torch.Tensor:
    """Shift (B, S) rows right by n (left when ``left``), filling -1e30."""
    fill = torch.full_like(a[:, :n], NEG_INF)
    return torch.cat([a[:, n:], fill], 1) if left else torch.cat([fill, a[:, :-n]], 1)


def ctc_loss_plain(emit: torch.Tensor, skip: torch.Tensor,
                   lengths: torch.Tensor, end_idx: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel with explicit alpha / beta lattices:
    emit (B, T, S), skip (B, S), lengths (B,), end_idx (B, 2) ->
    (nll (B,), grad_emit (B, T, S))."""
    B, T, S = emit.shape
    neg = torch.full((), NEG_INF, device=emit.device)
    lane = torch.arange(S, device=emit.device)[None, :]
    lens = lengths.to(torch.int64)[:, None]
    skip_ok = skip > 0
    alpha = [None] * T
    prev = torch.where(lane < 2, emit[:, 0], neg)
    alpha[0] = prev
    for t in range(1, T):
        a2 = torch.where(skip_ok, _shift(prev, 2), neg)
        new = _lse3(prev, _shift(prev, 1), a2) + emit[:, t]
        prev = torch.where(t < lens, new, prev)
        alpha[t] = prev
    e_last, e_prev = end_idx[:, :1].long(), end_idx[:, 1:].long()
    sel = (lane == e_last) | ((lane == e_prev) & (e_prev >= 0))
    ending = torch.where(sel, alpha[T - 1], neg)
    m = torch.clamp(ending.max(dim=1, keepdim=True).values, min=NEG_INF)
    dead = m <= NEG_INF / 2
    ms = torch.where(dead, torch.zeros_like(m), m)
    z = torch.where(sel, torch.exp(ending - ms), torch.zeros_like(ending)).sum(1, keepdim=True)
    logz = torch.where(dead, torch.full_like(m, NEG_INF),
                       ms + torch.log(torch.clamp(z, min=1e-37)))
    feas = logz > NEG_INF / 2
    zero = torch.zeros((), device=emit.device)
    grad = [None] * T
    beta = torch.where(sel, zero, neg)
    grad[T - 1] = torch.where(((T - 1) < lens) & feas,
                              -torch.exp(alpha[T - 1] + beta - logz), zero)
    src_ok = _shift(torch.where(skip_ok, zero, neg), 2, left=True) > NEG_INF / 2
    for t in range(T - 2, -1, -1):
        contrib = beta + emit[:, t + 1]
        b2 = _shift(contrib, 2, left=True) + torch.where(src_ok, zero, neg)
        nb = _lse3(contrib, _shift(contrib, 1, left=True), b2)
        beta = torch.where(t + 1 < lens, nb, beta)
        grad[t] = torch.where((t < lens) & feas,
                              -torch.exp(alpha[t] + beta - logz), zero)
    return -logz[:, 0], torch.stack(grad, dim=1)


def ctc_loss_fused(emit: torch.Tensor, skip: torch.Tensor,
                   lengths: torch.Tensor, end_idx: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3. emit (B, T, S) f32, skip (B, S) f32, lengths (B,) int, end_idx
    (B, 2) int32 -> (nll (B,), grad_emit (B, T, S)). CPU tensors take the
    plain version; CUDA tensors launch the kernel. Either way, inputs of
    another dtype or layout raise."""
    B, T, S = emit.shape
    lens = lengths.to(torch.int32).contiguous()
    build.check_inputs("ctc_loss_fused", emit,
                       ("emit", emit, (B, T, S), torch.float32),
                       ("skip", skip, (B, S), torch.float32),
                       ("lengths", lens, (B,), torch.int32),
                       ("end_idx", end_idx, (B, 2), torch.int32))
    if emit.device.type == "cpu":
        return ctc_loss_plain(emit, skip, lengths, end_idx)
    if emit.device.type != "cuda":
        raise ValueError(f"ctc_loss_fused: unsupported device {emit.device}")
    if S > MAX_STATES:
        raise ValueError(f"ctc_loss_fused: {S} lattice states (2U+1) exceed "
                         f"one block's {MAX_STATES} threads")
    lib = build.load("ctc_loss", _SIGNATURES)
    optin = ctypes.c_int(0)
    build.check(lib.ctc_max_smem(ctypes.byref(optin)), "ctc smem query")
    in_smem = lib.ctc_smem_bytes(T, S, 1) <= optin.value
    dev = emit.device
    nll = torch.empty((B,), dtype=torch.float32, device=dev)
    grad = torch.empty((B, T, S), dtype=torch.float32, device=dev)
    scratch = (None if in_smem else
               torch.empty((B, T, S), dtype=torch.float32, device=dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ctc_launch(emit.data_ptr(), skip.data_ptr(), lens.data_ptr(),
                        end_idx.data_ptr(), nll.data_ptr(), grad.data_ptr(),
                        None if in_smem else scratch.data_ptr(),
                        B, T, S, int(in_smem), stream)
    build.check(rc, "ctc_loss_fused launch")
    ctc_loss_fused.launches += 1
    return nll, grad


ctc_loss_fused.launches = 0


class CTCLoss(torch.autograd.Function):
    """Per-utterance CTC NLL (B,) of log_probs (B, T, V) with the analytic
    gradient of K3 (which raises unless the input is f32), or of its plain
    version when ``use_kernel`` is off."""

    @staticmethod
    def forward(ctx, log_probs, logit_lengths, labels, label_lengths,
                blank: int, use_kernel: bool):
        emit, skip, end_idx, ext = prepare(log_probs, labels, label_lengths,
                                           blank)
        run = ctc_loss_fused if use_kernel else ctc_loss_plain
        nll, grad_emit = run(emit, skip, logit_lengths, end_idx)
        ctx.save_for_backward(grad_emit, ext)
        ctx.vocab = log_probs.shape[-1]
        return nll

    @staticmethod
    def backward(ctx, g):
        grad_emit, ext = ctx.saved_tensors
        B, T, S = grad_emit.shape
        grad = torch.zeros((B, T, ctx.vocab), dtype=grad_emit.dtype,
                           device=grad_emit.device)
        grad.scatter_add_(2, ext[:, None, :].expand(B, T, S), grad_emit)
        return grad * g[:, None, None], None, None, None, None, None

