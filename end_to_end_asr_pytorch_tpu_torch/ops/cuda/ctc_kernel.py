"""K3: CTC forward-backward (loss and analytic gradient) — wrapper for
``csrc/ctc_loss.cu``, its plain PyTorch version, and the autograd Function.

Replaces ``end_to_end_asr_pytorch_tpu/ops/pallas/ctc_kernel.py``:
``_prepare`` and ``_kernel`` / ``_run_kernel`` together (here the CUDA
kernel, which reads the log-probs itself: the extended labels, the skip
mask, the end states and the emission gather, then the alpha and beta walks
at once and the gradient ``-exp(alpha + beta - logZ)``; it also writes the
extended labels), and ``_ctc_bwd`` (here ``CTCLoss.backward``: the (B, T, S)
gradient scattered to (B, T, V) by those labels with ``scatter_add_`` and
scaled by the incoming cotangent). On the H100 the
kernel is bound by its chain of serial lattice steps, not by bytes (see the
CUDA source). The 128-lane padding of S and the batch tile are TPU layout
devices and are not carried.

The plain version is ``prepare`` (the emission lattice, skip mask and end
states, in PyTorch) followed by ``lattice_plain`` (explicit alpha / beta
lattices). Arithmetic follows the TPU kernel exactly: the ``-1e30`` sentinel
and ``_lse3``, no infinities; infeasible rows (logZ == -1e30) and frames at
or past a row's length get exactly zero gradient.

Each block runs two groups of ``NW`` warps (alpha and beta), each thread
holding ``R`` lattice states; ``pick(S)`` chooses them (``designs(S)`` lists
every one the kernel takes). A lattice wider than one group is walked in
chunks, so ``supports`` holds for every (T, S) a caller can index.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from . import build

NEG_INF = -1e30
STATES = (1, 2, 4, 8)              # R: lattice states a thread holds
WARPS = (1, 2, 4, 8, 16)           # NW: warps per group
_INT_MAX = 2 ** 31 - 1
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ctc_smem_limit": (_I, [_I, ctypes.POINTER(_I)]),
    "ctc_regs": (_I, [_I, ctypes.POINTER(_I)]),
    "ctc_launch": (_I, [_P] * 9 + [_I] * 11 + [_P]),
    "ctc_floor_launch": (_I, [_P, _I, _I, _P]),
    "ctc_math_check_launch": (_I, [_P, _P]),
}
_SMEM_LIMIT: Dict[int, int] = {}   # R -> bytes, per process


def max_threads(R: int) -> int:
    """Threads a block of the kernel with ``R`` states a thread may have
    (``CTC_MAX_THREADS`` in the CUDA source)."""
    return 1024 if R == 1 else 512


def chunks(S: int, R: int, NW: int) -> int:
    """Chunks of 32 NW R states the kernel walks a lattice of S states in."""
    return -(-S // (32 * NW * R))


def padded(S: int) -> int:
    """Sp: the row length of the kernel's histories and gradient buffer."""
    return -(-S // 4) * 4


def designs(S: int) -> List[Tuple[int, int]]:
    """Every (R, NW) the kernel takes that walks S states in one chunk, or,
    where none does, the widest ones (chunks of 2048 states)."""
    out = [(R, NW) for R in STATES for NW in WARPS
           if 64 * NW <= max_threads(R) and 32 * NW * R >= S
           and 32 * NW * R < 2 * max(S, 32)]
    if not out:
        out = [(R, NW) for R in STATES for NW in WARPS
               if 64 * NW <= max_threads(R) and 32 * NW * R == 2048]
    return out


def pick(S: int) -> Tuple[int, int]:
    """(R, NW) for a lattice of S states: among ``designs(S)``, the one
    with the most warps a group up to 8. (The sweep on the H100: at S=401
    and 1201 eight warps a group were the fastest; at S=193 eight warps
    of one state a thread and four of two were within 5% of each other,
    each ahead in some calls.)"""
    return max((d for d in designs(S) if d[1] <= 8), key=lambda d: d[1])


def supports(T: int, S: int) -> bool:
    """Whether the kernel takes a lattice of T frames and S = 2U + 1
    states: any T >= 1 and odd S >= 1 whose row (S rounded up to 4) an int
    indexes. Shared memory and threads set no limit: a history that does
    not fit in shared memory goes to device memory, and a lattice wider
    than one group is walked in chunks."""
    return 1 <= T <= _INT_MAX and 1 <= S <= _INT_MAX - 3 and S % 2 == 1


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


def lattice_plain(emit: torch.Tensor, skip: torch.Tensor,
                  lengths: torch.Tensor, end_idx: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lattice with explicit alpha / beta walks: emit (B, T, S), skip
    (B, S), lengths (B,), end_idx (B, 2) -> (nll (B,), grad_emit (B, T, S))."""
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


def ctc_loss_plain(log_probs: torch.Tensor, logit_lengths: torch.Tensor,
                   labels: torch.Tensor, label_lengths: torch.Tensor,
                   blank: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: ``prepare`` then ``lattice_plain``.
    log_probs (B, T, V), logit_lengths (B,), labels (B, U), label_lengths
    (B,) -> (nll (B,), grad_emit (B, T, 2U+1), ext (B, 2U+1) int64)."""
    emit, skip, end_idx, ext = prepare(log_probs, labels, label_lengths, blank)
    return (*lattice_plain(emit, skip, logit_lengths, end_idx), ext)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _smem_limit(lib, R: int) -> int:
    if R not in _SMEM_LIMIT:
        out = ctypes.c_int(0)
        build.check(lib.ctc_smem_limit(R, ctypes.byref(out)), "ctc smem query")
        _SMEM_LIMIT[R] = out.value
    return _SMEM_LIMIT[R]


def ctc_loss_fused(log_probs: torch.Tensor, logit_lengths: torch.Tensor,
                   labels: torch.Tensor, label_lengths: torch.Tensor,
                   blank: int = 0, design: Optional[Tuple[int, int]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3. log_probs (B, T, V) f32, logit_lengths (B,), labels (B, U) and
    label_lengths (B,), each int32 or int64 -> (nll (B,), grad_emit (B, T,
    2U+1), ext (B, 2U+1) int64, the extended labels). CPU tensors take the
    plain version; CUDA tensors launch the kernel (``design`` (R, NW)
    overrides ``pick``), which allocates its outputs and scratch and
    launches nothing else; the gradient is a view of a (B, T, Sp) buffer.
    Either way, inputs of another dtype or layout raise."""
    B, T, V = log_probs.shape
    U = labels.shape[1] if labels.dim() == 2 else -1
    build.check_inputs("ctc_loss_fused", log_probs,
                       ("log_probs", log_probs, (B, T, V), torch.float32))
    ints = (torch.int32, torch.int64)
    for name, t, shape in (("labels", labels, (B, U)),
                           ("label_lengths", label_lengths, (B,)),
                           ("logit_lengths", logit_lengths, (B,))):
        if (t.dtype not in ints or tuple(t.shape) != shape
                or t.device != log_probs.device or not t.is_contiguous()):
            raise ValueError(f"ctc_loss_fused: {name} must be a contiguous "
                             f"int32 or int64 {shape} tensor on "
                             f"{log_probs.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if not log_probs.is_cuda:
        if log_probs.device.type != "cpu":
            raise ValueError(
                f"ctc_loss_fused: unsupported device {log_probs.device}")
        return ctc_loss_plain(log_probs, logit_lengths, labels,
                              label_lengths, blank)
    S = 2 * U + 1
    if not supports(T, S):
        raise ValueError(f"ctc_loss_fused: T={T}, S={S} outside the kernel")
    R, NW = design if design is not None else pick(S)
    lib = build.load("ctc_loss", _SIGNATURES)
    Sp, K = padded(S), chunks(S, R, NW)
    in_smem = T * Sp * 4 <= _smem_limit(lib, R)
    dev = log_probs.device
    nll = torch.empty((B,), dtype=torch.float32, device=dev)
    grad = torch.empty((B, T, Sp), dtype=torch.float32, device=dev)
    ext = torch.empty((B, S), dtype=torch.int64, device=dev)
    if B == 0:
        return nll, grad[:, :, :S], ext
    alpha = None if in_smem else torch.empty((B, T, Sp), dtype=torch.float32,
                                             device=dev)
    edge = None if K == 1 else torch.empty((B, K, T, 2), dtype=torch.float32,
                                           device=dev)
    idx64 = sum(1 << i for i, t in enumerate((labels, label_lengths,
                                              logit_lengths))
                if t.dtype == torch.int64)
    rc = lib.ctc_launch(log_probs.data_ptr(), labels.data_ptr(),
                        label_lengths.data_ptr(), logit_lengths.data_ptr(),
                        nll.data_ptr(), grad.data_ptr(),
                        None if alpha is None else alpha.data_ptr(),
                        None if edge is None else edge.data_ptr(),
                        ext.data_ptr(),
                        B, T, V, U, S, Sp, R, NW, blank, idx64, int(in_smem),
                        _stream(dev))
    build.check(rc, "ctc_loss_fused launch")
    ctc_loss_fused.launches += 1
    return nll, grad[:, :, :S], ext


ctc_loss_fused.launches = 0


def chain_floor_ms(steps: int, nw: int = 1) -> float:
    """Device ms per step of the kernel's chain alone (shuffles, one lse3,
    and with ``nw`` > 1 the exchange through shared memory behind the
    group's barrier), from a walk of ``steps`` steps with no memory
    traffic, timed by CUDA events. Card only."""
    lib = build.load("ctc_loss", _SIGNATURES)
    out = torch.empty((1,), dtype=torch.float32, device="cuda")
    stream = _stream(out.device)
    run = lambda n: build.check(
        lib.ctc_floor_launch(out.data_ptr(), n, nw, stream), "ctc floor")
    run(steps)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run(steps)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def math_mismatches() -> Tuple[int, int]:
    """How many inputs the kernel's written-out expf and logf (exp_n,
    log_n) map to other bits than the CUDA library's: over every finite f32
    x <= 0, and over every positive normal finite f32. Card only."""
    lib = build.load("ctc_loss", _SIGNATURES)
    counts = torch.zeros((2,), dtype=torch.int64, device="cuda")
    build.check(lib.ctc_math_check_launch(counts.data_ptr(),
                                          _stream(counts.device)),
                "ctc math check")
    return tuple(int(c) for c in counts.cpu())


class CTCLoss(torch.autograd.Function):
    """Per-utterance CTC NLL (B,) of log_probs (B, T, V) with the analytic
    gradient of K3 (which raises unless the input is f32), or of its plain
    version when ``use_kernel`` is off."""

    @staticmethod
    def forward(ctx, log_probs, logit_lengths, labels, label_lengths,
                blank: int, use_kernel: bool):
        run = ctc_loss_fused if use_kernel else ctc_loss_plain
        nll, grad_emit, ext = run(log_probs, logit_lengths, labels,
                                  label_lengths, blank)
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
