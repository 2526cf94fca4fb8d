"""K2 / K2b: masked LSTM time scan, forward and backward — wrappers for
``csrc/lstm_scan.cu``, their plain PyTorch versions, and the autograd
Function that joins them.

Replaces ``end_to_end_asr_pytorch_tpu/ops/pallas/lstm_kernel.py``:
``_run_fwd`` (forward, with the cell-state and gate residuals) and
``_run_bwd`` (reverse-time gate gradients), tied together by the
``jax.custom_vjp`` of ``lstm_scan_fused`` (``_fused_fwd`` / ``_fused_bwd``),
whose counterpart here is ``LSTMScan``. On the H100 both passes are bound by
their T serial (B, H) x (H, 4H) f32 products; each kernel is one persistent
cooperative launch per (layer, direction) that keeps its slice of W_hh and
its carries in shared memory and synchronises the grid once per step (see
the CUDA source). dW_hh is one ``torch.matmul`` outside the backward kernel,
as the TPU wrapper leaves it to XLA. The TPU kernels' UNROLL / B_TILE are
TPU pipeline devices and are not carried over; the port walks time by index
in both directions and makes no flipped copies.

Numerics: the TPU kernels pin Precision.DEFAULT (bf16 multiplies on a TPU,
f32 in CPU interpret mode). These kernels compute in f32 throughout and are
held to the f32 plain versions. The forward also takes bf16 x_proj (decode
amp, the TPU kernel's x_proj.dtype outputs): ``lstm_scan_bf16`` (K2-bf16)
reads bf16 x_proj, keeps W_hh, the carries and the gate math in f32 and
writes ys rounded to bf16; its plain version is ``lstm_scan_plain`` on bf16
x_proj. On the card it is a separate design, the tensor-core scan of
``scan_tc`` (one thread-block cluster per layer, direction and group of
batch rows, the product exact to f32 through a three-part split of h).
The JAX package's own CPU scan rounds the carries to bf16 each step, which
the TPU kernel does not: the port follows the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build, scan_tc

_NT = 256  # threads per block in the kernels
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "lstm_max_coresident": (_I, [_I, _I, _I, _I, ctypes.POINTER(_I)]),
    "lstm_fwd_launch": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _P]),
    "lstm_tc_max_groups": (_I, [_I] * 7 + [ctypes.POINTER(_I)]),
    "lstm_tc_launch": (_I, [_P] * 6 + [_I] * 12 + [_P]),
    "lstm_bwd_launch": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _P]),
}


def _scan(x_proj, w_hh, mask, reverse, h, c, residuals):
    """The recurrence in the carries' dtype; ys in x_proj's."""
    T = x_proj.shape[0]
    H = w_hh.shape[0]
    ys, cs, gs = [None] * T, [None] * T, [None] * T
    zero = torch.zeros((), dtype=h.dtype, device=x_proj.device)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        i, f, g, o = (x_proj[t].to(h.dtype) + h @ w_hh).split(H, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        m = mask[t][:, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        ys[t] = torch.where(m, h_new, zero)
        if residuals:
            cs[t] = c
            gs[t] = torch.cat([i, f, g, o], dim=-1)
    if residuals:
        return torch.stack(ys), torch.stack(cs), torch.stack(gs)
    return torch.stack(ys).to(x_proj.dtype)


def lstm_scan_plain(x_proj: torch.Tensor, w_hh: torch.Tensor,
                    mask: torch.Tensor, reverse: bool = False,
                    h0: Optional[torch.Tensor] = None,
                    c0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain scan: x_proj (T, B, 4H), w_hh (H, 4H), mask (T, B) bool ->
    ys (T, B, H) in x_proj's dtype. Padded steps emit zeros and hold the
    carry. Without an initial state the carries are f32 and bf16 x_proj is
    widened each step (K2's bf16 contract). Autograd runs through its loop
    (the decoder-style path with an initial state)."""
    B = x_proj.shape[1]
    H = w_hh.shape[0]
    z = torch.zeros((B, H), dtype=torch.float32, device=x_proj.device)
    return _scan(x_proj, w_hh, mask, reverse, z if h0 is None else h0,
                 z if c0 is None else c0, False)


def lstm_scan_fwd_plain(x_proj: torch.Tensor, w_hh: torch.Tensor,
                        mask: torch.Tensor, reverse: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel with residuals: -> ys (T, B, H),
    cs (T, B, H) the carried cell state, gates (T, B, 4H) post-activation
    (i, f, g, o), each indexed by real time."""
    B = x_proj.shape[1]
    H = w_hh.shape[0]
    z = torch.zeros((B, H), dtype=x_proj.dtype, device=x_proj.device)
    return _scan(x_proj, w_hh, mask, reverse, z, z, True)


def _prev_step(a: torch.Tensor, reverse: bool) -> torch.Tensor:
    """a[t] of the forward's previous step (t-1, or t+1 when reversed),
    zero at the first step the forward walked."""
    z = torch.zeros_like(a[:1])
    return torch.cat([a[1:], z]) if reverse else torch.cat([z, a[:-1]])


def lstm_scan_bwd_plain(gates: torch.Tensor, cs: torch.Tensor,
                        ys: torch.Tensor, mask: torch.Tensor,
                        w_hh: torch.Tensor, dys: torch.Tensor,
                        reverse: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel: the explicit reverse-time
    recurrence of ``_bwd_kernel``. -> (dxp (T, B, 4H), dW_hh (H, 4H))."""
    T, B, G = gates.shape
    H = G // 4
    cs_prev = _prev_step(cs, reverse)
    dh_c = torch.zeros((B, H), dtype=gates.dtype, device=gates.device)
    dc_c = torch.zeros_like(dh_c)
    w_t = w_hh.t()
    dxp = [None] * T
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        i, f, g, o = gates[t].split(H, dim=-1)
        m = mask[t][:, None].to(gates.dtype)
        dh = dh_c + dys[t]
        tc = torch.tanh(cs[t])
        do = dh * tc
        dc = dc_c + dh * o * (1.0 - tc * tc)
        dgates = m * torch.cat([(dc * g) * i * (1.0 - i),
                                (dc * cs_prev[t]) * f * (1.0 - f),
                                (dc * i) * (1.0 - g * g),
                                do * o * (1.0 - o)], dim=-1)
        dh_c = dgates @ w_t + (1.0 - m) * dh_c
        dc_c = m * (dc * f) + (1.0 - m) * dc_c
        dxp[t] = dgates
    dxp = torch.stack(dxp)
    return dxp, dw_hh(ys, dxp, reverse)


def dw_hh(ys: torch.Tensor, dxp: torch.Tensor, reverse: bool) -> torch.Tensor:
    """dW_hh = sum_t hs_prev[t]^T dxp[t], hs_prev the forward's previous
    output (one GEMM, outside the kernel)."""
    hs_prev = _prev_step(ys, reverse)
    H, G = ys.shape[-1], dxp.shape[-1]
    return hs_prev.reshape(-1, H).t() @ dxp.reshape(-1, G)


# kernel kinds of lstm_max_coresident
_FWD, _BWD = 0, 1


def _pick_units(H: int, B: int, max_coresident, kind: int) -> int:
    """Hidden units per block: the smallest power of two that divides H and
    leaves a grid that is co-resident on the card. ``max_coresident`` is a
    scan library's occupancy query (``lstm_`` or ``gru_max_coresident``)."""
    dev = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    U = 1
    while U <= _NT // 2:
        if H % U == 0 and H // U <= sms:
            out = ctypes.c_int(0)
            build.check(max_coresident(B, H, U, kind, ctypes.byref(out)),
                        "scan occupancy query")
            if H // U <= out.value:
                return U
        U *= 2
    raise ValueError(f"scan kernel: no co-resident grid for H={H}, B={B}")


def lstm_scan_fused(x_proj: torch.Tensor, w_hh: torch.Tensor,
                    mask: torch.Tensor, reverse: bool = False,
                    residuals: bool = False):
    """K2. x_proj (T, B, 4H) f32, w_hh (H, 4H) f32, mask (T, B) bool ->
    ys (T, B, H), or (ys, cs, gates) with ``residuals``. bf16 x_proj goes to
    ``lstm_scan_bf16`` (no residuals). CPU tensors take the plain version;
    CUDA tensors launch the kernel. Either way, inputs of another dtype or
    layout raise."""
    T, B, G = x_proj.shape
    H = G // 4
    if x_proj.dtype == torch.bfloat16 and not residuals:
        return lstm_scan_bf16(x_proj, w_hh, mask, reverse)
    build.check_inputs("lstm_scan_fused", x_proj,
                       ("x_proj", x_proj, (T, B, 4 * H), torch.float32),
                       ("w_hh", w_hh, (H, 4 * H), torch.float32),
                       ("mask", mask, (T, B), torch.bool))
    if x_proj.device.type == "cpu":
        if residuals:
            return lstm_scan_fwd_plain(x_proj, w_hh, mask, reverse)
        return lstm_scan_plain(x_proj, w_hh, mask, reverse)
    if x_proj.device.type != "cuda":
        raise ValueError(f"lstm_scan_fused: unsupported device {x_proj.device}")
    lib = build.load("lstm_scan", _SIGNATURES)
    U = _pick_units(H, B, lib.lstm_max_coresident, _FWD)
    dev = x_proj.device
    ys = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    cs = gates = None
    if residuals:
        cs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
        gates = torch.empty((T, B, G), dtype=torch.float32, device=dev)
    hbuf = torch.zeros((2, H, B), dtype=torch.float32, device=dev)
    m = mask.to(torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.lstm_fwd_launch(x_proj.data_ptr(), w_hh.data_ptr(), m.data_ptr(),
                             ys.data_ptr(), hbuf.data_ptr(),
                             cs.data_ptr() if residuals else None,
                             gates.data_ptr() if residuals else None,
                             T, B, H, U, int(reverse), stream)
    build.check(rc, "lstm_scan_fused launch")
    lstm_scan_fused.launches += 1
    return (ys, cs, gates) if residuals else ys


lstm_scan_fused.launches = 0


def lstm_scan_bf16(x_proj: torch.Tensor, w_hh: torch.Tensor,
                   mask: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """K2-bf16 (decode amp). x_proj (T, B, 4H) bf16, w_hh (H, 4H) f32, mask
    (T, B) bool -> ys (T, B, H) bf16; carries and gate math f32. CPU tensors
    take the plain version; CUDA tensors launch the tensor-core kernel
    (``scan_tc``), whose product equals the f32 one. Either way, inputs of
    another dtype or layout raise."""
    T, B, G = x_proj.shape
    H = G // 4
    build.check_inputs("lstm_scan_bf16", x_proj,
                       ("x_proj", x_proj, (T, B, 4 * H), torch.bfloat16),
                       ("w_hh", w_hh, (H, 4 * H), torch.float32),
                       ("mask", mask, (T, B), torch.bool))
    if x_proj.device.type == "cpu":
        return lstm_scan_plain(x_proj, w_hh, mask, reverse)
    if x_proj.device.type != "cuda":
        raise ValueError(f"lstm_scan_bf16: unsupported device {x_proj.device}")
    lib = build.load("lstm_scan", _SIGNATURES)
    ys, n = scan_tc.run(lib.lstm_tc_launch, lib.lstm_tc_max_groups, x_proj,
                        w_hh, (), mask, reverse, 4)
    lstm_scan_bf16.launches += n
    return ys


lstm_scan_bf16.launches = 0


def lstm_bwd_fused(gates: torch.Tensor, cs: torch.Tensor, ys: torch.Tensor,
                   mask: torch.Tensor, w_hh: torch.Tensor, dys: torch.Tensor,
                   reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2b. gates (T, B, 4H), cs / ys / dys (T, B, H), mask (T, B) bool,
    w_hh (H, 4H), all f32 -> (dxp (T, B, 4H), dW_hh (H, 4H)); dW_hh is one
    GEMM after the kernel. CPU tensors take the plain version; CUDA tensors
    launch the kernel. Either way, inputs of another dtype or layout
    raise."""
    T, B, G = gates.shape
    H = G // 4
    build.check_inputs("lstm_bwd_fused", gates,
                       ("gates", gates, (T, B, G), torch.float32),
                       ("cs", cs, (T, B, H), torch.float32),
                       ("ys", ys, (T, B, H), torch.float32),
                       ("dys", dys, (T, B, H), torch.float32),
                       ("mask", mask, (T, B), torch.bool),
                       ("w_hh", w_hh, (H, G), torch.float32))
    if gates.device.type == "cpu":
        return lstm_scan_bwd_plain(gates, cs, ys, mask, w_hh, dys, reverse)
    if gates.device.type != "cuda":
        raise ValueError(f"lstm_bwd_fused: unsupported device {gates.device}")
    lib = build.load("lstm_scan", _SIGNATURES)
    U = _pick_units(H, B, lib.lstm_max_coresident, _BWD)
    dev = gates.device
    dxp = torch.empty((T, B, G), dtype=torch.float32, device=dev)
    dgbuf = torch.zeros((2, H, B, 4), dtype=torch.float32, device=dev)
    m = mask.to(torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.lstm_bwd_launch(gates.data_ptr(), cs.data_ptr(), dys.data_ptr(),
                             m.data_ptr(), w_hh.data_ptr(), dxp.data_ptr(),
                             dgbuf.data_ptr(), T, B, H, U, int(reverse), stream)
    build.check(rc, "lstm_bwd_fused launch")
    lstm_bwd_fused.launches += 1
    return dxp, dw_hh(ys, dxp, reverse)


lstm_bwd_fused.launches = 0


class LSTMScan(torch.autograd.Function):
    """ys = scan(x_proj, w_hh, mask) with the hand-written backward.
    ``use_kernel`` picks K2 / K2b (CUDA tensors; bf16 x_proj takes K2's
    bf16 variant and has no backward) or the plain versions (CPU tensors,
    or the card with the kernels switched off). The forward keeps residuals
    only when a gradient is needed, so serving pays nothing extra."""

    @staticmethod
    def forward(ctx, x_proj, w_hh, mask, reverse: bool, use_kernel: bool):
        need = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        ctx.reverse, ctx.use_kernel = reverse, use_kernel
        if use_kernel:
            out = lstm_scan_fused(x_proj, w_hh, mask, reverse, residuals=need)
        elif need:
            out = lstm_scan_fwd_plain(x_proj, w_hh, mask, reverse)
        else:
            out = lstm_scan_plain(x_proj, w_hh, mask, reverse)
        if not need:
            return out
        ys, cs, gates = out
        ctx.save_for_backward(ys, cs, gates, mask, w_hh)
        return ys

    @staticmethod
    def backward(ctx, dys):
        ys, cs, gates, mask, w_hh = ctx.saved_tensors
        run = lstm_bwd_fused if ctx.use_kernel else lstm_scan_bwd_plain
        dxp, dw = run(gates, cs, ys, mask, w_hh, dys.contiguous(), ctx.reverse)
        return dxp, dw, None, None, None
