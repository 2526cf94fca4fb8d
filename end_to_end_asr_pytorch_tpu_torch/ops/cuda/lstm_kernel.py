"""K2 / K2b: masked LSTM time scan, forward and backward — wrappers for
``csrc/lstm_scan.cu``, their plain PyTorch versions, and the autograd
Function that joins them.

Replaces ``end_to_end_asr_pytorch_tpu/ops/pallas/lstm_kernel.py``:
``_run_fwd`` (forward, with the cell-state and gate residuals) and
``_run_bwd`` (reverse-time gate gradients), tied together by the
``jax.custom_vjp`` of ``lstm_scan_fused`` (``_fused_fwd`` / ``_fused_bwd``),
whose counterpart here is ``LSTMScan``. On the H100 both passes are bound by
the latency of their T serial steps, each a (B, H) x (H, 4H) product behind
one exchange across blocks; both run on the tensor cores of ``scan_tc``
(per layer, direction and group of batch rows a cluster or a cooperative
grid of blocks that hold their W_hh fragments in registers and split the
f32 carry into three bf16 parts, so the product equals the f32 one). dW_hh
is one ``torch.matmul`` outside the backward kernel, as the TPU wrapper
leaves it to XLA. The TPU kernels' UNROLL / B_TILE are TPU pipeline devices
and are not carried over; the port walks time by index in both directions
and makes no flipped copies.

Numerics: the TPU kernels pin Precision.DEFAULT (bf16 multiplies on a TPU,
f32 in CPU interpret mode). These kernels compute to f32 accuracy and are
held to the f32 plain versions. The forward also takes bf16 x_proj (the
TPU kernel's x_proj.dtype outputs): ``lstm_scan_bf16`` (K2-bf16, decode
amp) reads bf16 x_proj, keeps W_hh, the carries and the gate math in f32
and writes ys rounded to bf16; ``lstm_train_bf16`` (amp training) also
writes the residuals rounded to bf16, and ``lstm_bwd_bf16`` (K2b's bf16
variant) widens them, takes the carry product from the f32 gate gradients
and writes dxp rounded to bf16; dW_hh sums the exact products of the bf16
hs_prev and dxp in f32 (the JAX einsum's ``preferred_element_type``).
Their plain versions are ``lstm_scan_plain``, ``lstm_scan_fwd_plain`` and
``lstm_scan_bwd_plain`` on bf16 tensors, which follow the TPU kernel: the
JAX package's own CPU scan rounds the carries to bf16 each step, which the
kernel does not. A width H that is not a multiple of 4 is zero-padded
around the kernels (``scan_tc.pad_units``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build, scan_tc

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "lstm_tc_max_groups": (_I, [_I] * 7 + [ctypes.POINTER(_I)]),
    "lstm_tc_launch": (_I, [_P] * 6 + [_I] * 12 + [_P]),
    "lstm_tc_f32_max_groups": (_I, [_I] * 7 + [ctypes.POINTER(_I)]),
    "lstm_tc_f32_launch": (_I, [_P] * 8 + [_I] * 12 + [_P]),
    "lstm_tc_bwd_max_groups": (_I, [_I] * 7 + [ctypes.POINTER(_I)]),
    "lstm_tc_bwd_launch": (_I, [_P] * 8 + [_I] * 12 + [_P]),
    "lstm_tc_bf16_res_max_groups": (_I, [_I] * 7 + [ctypes.POINTER(_I)]),
    "lstm_tc_bf16_res_launch": (_I, [_P] * 8 + [_I] * 12 + [_P]),
    "lstm_tc_bwd_bf16_max_groups": (_I, [_I] * 7 + [ctypes.POINTER(_I)]),
    "lstm_tc_bwd_bf16_launch": (_I, [_P] * 8 + [_I] * 12 + [_P]),
}


def _scan(x_proj, w_hh, mask, reverse, h, c, residuals):
    """The recurrence in the carries' dtype; ys (and the residuals) in
    x_proj's."""
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
        return tuple(torch.stack(a).to(x_proj.dtype) for a in (ys, cs, gs))
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
    (i, f, g, o), each indexed by real time and in x_proj's dtype; the
    carries and the gate math are f32 (bf16 x_proj widened each step)."""
    B = x_proj.shape[1]
    H = w_hh.shape[0]
    z = torch.zeros((B, H), dtype=torch.float32, device=x_proj.device)
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
    recurrence of ``_bwd_kernel`` in f32 on the widened inputs. -> (dxp
    (T, B, 4H) in dys' dtype, dW_hh (H, 4H) f32); the carry takes the f32
    gate gradients, dW_hh the stored dxp."""
    T, B, G = gates.shape
    H = G // 4
    dt = dys.dtype
    gates, cs, dys = gates.float(), cs.float(), dys.float()
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
    dxp = torch.stack(dxp).to(dt)
    return dxp, dw_hh(ys, dxp, reverse)


def lstm_bwd_steps_plain(gates: torch.Tensor, cs: torch.Tensor,
                         mask: torch.Tensor, w_hh: torch.Tensor,
                         dys: torch.Tensor, reverse: bool = False
                         ) -> torch.Tensor:
    """The backward kernel's own output dxp (T, B, 4H, in dys' dtype) as
    K2b's tensor-core scan computes it: the carry product through
    ``scan_tc.split_product`` of the previous walked step's f32 gate
    gradients and W_hh^T, then the epilogue of ``LstmBwdCellT`` in its
    order (dh_carry = p + st_dh; st_dh = (1 - m) dh_carry; dc_carry = m dc
    f + (1 - m) dc_carry) on the widened inputs."""
    T, B, G = gates.shape
    H = G // 4
    dt = dys.dtype
    gates, cs, dys = gates.float(), cs.float(), dys.float()
    cs_prev = _prev_step(cs, reverse)
    st_dh = torch.zeros((B, H), dtype=gates.dtype, device=gates.device)
    dc_c = torch.zeros_like(st_dh)
    prev = torch.zeros((B, G), dtype=gates.dtype, device=gates.device)
    w_t = w_hh.t()
    dxp = torch.zeros_like(gates)
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        i, f, g, o = gates[t].split(H, dim=-1)
        m = mask[t][:, None].to(gates.dtype)
        dh_carry = scan_tc.split_product(prev, w_t) + st_dh
        dh = dh_carry + dys[t]
        tc = torch.tanh(cs[t])
        dc = dc_c + dh * o * (1.0 - tc * tc)
        dxp[t] = m * torch.cat([(dc * g) * i * (1.0 - i),
                                (dc * cs_prev[t]) * f * (1.0 - f),
                                (dc * i) * (1.0 - g * g),
                                (dh * tc) * o * (1.0 - o)], dim=-1)
        st_dh = (1.0 - m) * dh_carry
        dc_c = m * (dc * f) + (1.0 - m) * dc_c
        prev = dxp[t]
    return dxp.to(dt)


def dw_hh(ys: torch.Tensor, dxp: torch.Tensor, reverse: bool) -> torch.Tensor:
    """dW_hh = sum_t hs_prev[t]^T dxp[t], hs_prev the forward's previous
    output (one GEMM, outside the kernel): bf16 operands are widened, so
    their products are exact and summed in f32."""
    hs_prev = _prev_step(ys, reverse).float()
    H, G = ys.shape[-1], dxp.shape[-1]
    return hs_prev.reshape(-1, H).t() @ dxp.float().reshape(-1, G)


def lstm_scan_fused(x_proj: torch.Tensor, w_hh: torch.Tensor,
                    mask: torch.Tensor, reverse: bool = False,
                    residuals: bool = False):
    """K2. x_proj (T, B, 4H) f32, w_hh (H, 4H) f32, mask (T, B) bool ->
    ys (T, B, H), or (ys, cs, gates) with ``residuals``. bf16 x_proj goes to
    ``lstm_scan_bf16`` (serving) or, with residuals, ``lstm_train_bf16``.
    CPU tensors take the plain version; CUDA tensors launch the tensor-core
    scan (``lstm_fwd_tc``), once, or once per wave where a grid's groups do
    not all fit. Either way, inputs of another dtype or layout raise."""
    if x_proj.dtype == torch.bfloat16:
        run = lstm_train_bf16 if residuals else lstm_scan_bf16
        return run(x_proj, w_hh, mask, reverse)
    _check_fwd("lstm_scan_fused", x_proj, w_hh, mask, torch.float32)
    if x_proj.device.type == "cpu":
        if residuals:
            return lstm_scan_fwd_plain(x_proj, w_hh, mask, reverse)
        return lstm_scan_plain(x_proj, w_hh, mask, reverse)
    out, n = lstm_fwd_tc(x_proj, w_hh, mask, reverse, residuals)
    lstm_scan_fused.launches += n
    return out


lstm_scan_fused.launches = 0


def _check_fwd(what, x_proj, w_hh, mask, dtype):
    T, B, G = x_proj.shape
    H = G // 4
    build.check_inputs(what, x_proj,
                       ("x_proj", x_proj, (T, B, 4 * H), dtype),
                       ("w_hh", w_hh, (H, 4 * H), torch.float32),
                       ("mask", mask, (T, B), torch.bool))
    if x_proj.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x_proj.device}")


def lstm_fwd_tc(x_proj: torch.Tensor, w_hh: torch.Tensor,
                mask: torch.Tensor, reverse: bool = False,
                residuals: bool = False, mode: Optional[int] = None,
                rows: Optional[int] = None):
    """K2's launch on checked CUDA tensors -> (ys or (ys, cs, gates),
    launches): the tensor-core scan (``scan_tc.run``) in the design
    ``mode`` / ``rows`` (default: ``scan_tc.pick``'s); f32, bf16 serving
    or bf16 with residuals by x_proj's dtype, outputs in that dtype. H not
    a multiple of 4 is zero-padded around it. Counts nothing; the wrappers
    do."""
    T, B, G = x_proj.shape
    H = G // 4
    Hp = scan_tc.padded(H)
    if Hp != H:
        out, n = lstm_fwd_tc(scan_tc.pad_units(x_proj, 4, Hp),
                             scan_tc.pad_w(w_hh, 4, Hp), mask, reverse,
                             residuals, mode, rows)
        if not residuals:
            return scan_tc.unpad_units(out, 1, H), n
        ys, cs, gates = out
        return (scan_tc.unpad_units(ys, 1, H), scan_tc.unpad_units(cs, 1, H),
                scan_tc.unpad_units(gates, 4, H)), n
    lib = build.load("lstm_scan", _SIGNATURES)
    dt = x_proj.dtype
    res = ((torch.empty((T, B, H), dtype=dt, device=x_proj.device),
            torch.empty((T, B, G), dtype=dt, device=x_proj.device))
           if residuals else ())
    if dt == torch.float32:
        launch, query = lib.lstm_tc_f32_launch, lib.lstm_tc_f32_max_groups
        outs = tuple(t.data_ptr() for t in res) or (None, None)
    elif residuals:
        launch, query = (lib.lstm_tc_bf16_res_launch,
                         lib.lstm_tc_bf16_res_max_groups)
        outs = tuple(t.data_ptr() for t in res)
    else:
        launch, query, outs = lib.lstm_tc_launch, lib.lstm_tc_max_groups, ()
    ys, n = scan_tc.run(launch, query, x_proj, w_hh, (), mask, reverse, 4,
                        mode, rows, outs)
    return ((ys, *res) if residuals else ys), n


def lstm_scan_bf16(x_proj: torch.Tensor, w_hh: torch.Tensor,
                   mask: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """K2-bf16 (decode amp). x_proj (T, B, 4H) bf16, w_hh (H, 4H) f32, mask
    (T, B) bool -> ys (T, B, H) bf16; carries and gate math f32. CPU tensors
    take the plain version; CUDA tensors launch the tensor-core kernel
    (``scan_tc``), whose product equals the f32 one. Either way, inputs of
    another dtype or layout raise."""
    _check_fwd("lstm_scan_bf16", x_proj, w_hh, mask, torch.bfloat16)
    if x_proj.device.type == "cpu":
        return lstm_scan_plain(x_proj, w_hh, mask, reverse)
    ys, n = lstm_fwd_tc(x_proj, w_hh, mask, reverse)
    lstm_scan_bf16.launches += n
    return ys


lstm_scan_bf16.launches = 0


def lstm_train_bf16(x_proj: torch.Tensor, w_hh: torch.Tensor,
                    mask: torch.Tensor, reverse: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 with residuals in bf16 (amp training; JAX ``_run_fwd`` on bf16
    x_proj). x_proj (T, B, 4H) bf16, w_hh (H, 4H) f32 (bf16 values under
    amp), mask (T, B) bool -> (ys, cs, gates), all bf16, each rounded once
    where the kernel stores it; carries and gate math f32. CPU tensors take
    ``lstm_scan_fwd_plain``; CUDA tensors launch the tensor-core scan.
    Either way, inputs of another dtype or layout raise."""
    _check_fwd("lstm_train_bf16", x_proj, w_hh, mask, torch.bfloat16)
    if x_proj.device.type == "cpu":
        return lstm_scan_fwd_plain(x_proj, w_hh, mask, reverse)
    out, n = lstm_fwd_tc(x_proj, w_hh, mask, reverse, residuals=True)
    lstm_train_bf16.launches += n
    return out


lstm_train_bf16.launches = 0


def _check_bwd(what, gates, cs, ys, mask, w_hh, dys, dtype):
    T, B, G = gates.shape
    H = G // 4
    build.check_inputs(what, gates,
                       ("gates", gates, (T, B, G), dtype),
                       ("cs", cs, (T, B, H), dtype),
                       ("ys", ys, (T, B, H), dtype),
                       ("dys", dys, (T, B, H), dtype),
                       ("mask", mask, (T, B), torch.bool),
                       ("w_hh", w_hh, (H, G), torch.float32))
    if gates.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {gates.device}")


def lstm_bwd_fused(gates: torch.Tensor, cs: torch.Tensor, ys: torch.Tensor,
                   mask: torch.Tensor, w_hh: torch.Tensor, dys: torch.Tensor,
                   reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2b. gates (T, B, 4H), cs / ys / dys (T, B, H), mask (T, B) bool,
    w_hh (H, 4H), all f32 -> (dxp (T, B, 4H), dW_hh (H, 4H)); dW_hh is one
    GEMM after the kernel. bf16 residuals go to ``lstm_bwd_bf16``. CPU
    tensors take the plain version; CUDA tensors launch the tensor-core
    backward scan (``lstm_bwd_tc``). Either way, inputs of another dtype
    or layout raise."""
    if gates.dtype == torch.bfloat16:
        return lstm_bwd_bf16(gates, cs, ys, mask, w_hh, dys, reverse)
    _check_bwd("lstm_bwd_fused", gates, cs, ys, mask, w_hh, dys,
               torch.float32)
    if gates.device.type == "cpu":
        return lstm_scan_bwd_plain(gates, cs, ys, mask, w_hh, dys, reverse)
    dxp, n = lstm_bwd_tc(gates, cs, mask, w_hh, dys, reverse)
    lstm_bwd_fused.launches += n
    return dxp, dw_hh(ys, dxp, reverse)


lstm_bwd_fused.launches = 0


def lstm_bwd_bf16(gates: torch.Tensor, cs: torch.Tensor, ys: torch.Tensor,
                  mask: torch.Tensor, w_hh: torch.Tensor, dys: torch.Tensor,
                  reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2b in bf16 (amp training; JAX ``_run_bwd`` on bf16 residuals).
    gates (T, B, 4H), cs / ys / dys (T, B, H) bf16, mask (T, B) bool, w_hh
    (H, 4H) f32 -> (dxp (T, B, 4H) bf16, dW_hh (H, 4H) f32): the math in f32
    on the widened inputs, dxp rounded where the kernel stores it, dW_hh
    the f32 sum of the exact products of bf16 hs_prev and dxp. CPU tensors
    take ``lstm_scan_bwd_plain``; CUDA tensors launch the tensor-core
    backward scan. Either way, inputs of another dtype or layout raise."""
    _check_bwd("lstm_bwd_bf16", gates, cs, ys, mask, w_hh, dys,
               torch.bfloat16)
    if gates.device.type == "cpu":
        return lstm_scan_bwd_plain(gates, cs, ys, mask, w_hh, dys, reverse)
    dxp, n = lstm_bwd_tc(gates, cs, mask, w_hh, dys, reverse)
    lstm_bwd_bf16.launches += n
    return dxp, dw_hh(ys, dxp, reverse)


lstm_bwd_bf16.launches = 0


def lstm_bwd_tc(gates: torch.Tensor, cs: torch.Tensor, mask: torch.Tensor,
                w_hh: torch.Tensor, dys: torch.Tensor, reverse: bool = False,
                mode: Optional[int] = None, rows: Optional[int] = None
                ) -> Tuple[torch.Tensor, int]:
    """K2b's launch on checked CUDA tensors -> (dxp (T, B, 4H) in the
    residuals' dtype, launches): the tensor-core backward scan
    (``scan_tc.run_bwd``, f32 or bf16 by the residuals' dtype) in the
    design ``mode`` / ``rows`` (default: ``scan_tc.pick``'s, the grid
    first). H not a multiple of 4 is zero-padded around it. Counts
    nothing; the wrappers do."""
    T, B, G = gates.shape
    H = G // 4
    Hp = scan_tc.padded(H)
    if Hp != H:
        pu = scan_tc.pad_units
        dxp, n = lstm_bwd_tc(pu(gates, 4, Hp), pu(cs, 1, Hp), mask,
                             scan_tc.pad_w(w_hh, 4, Hp), pu(dys, 1, Hp),
                             reverse, mode, rows)
        return scan_tc.unpad_units(dxp, 4, H), n
    lib = build.load("lstm_scan", _SIGNATURES)
    dxp = torch.empty((T, B, G), dtype=gates.dtype, device=gates.device)
    m = mask.to(torch.float32)
    launch, query = ((lib.lstm_tc_bwd_launch, lib.lstm_tc_bwd_max_groups)
                     if gates.dtype == torch.float32 else
                     (lib.lstm_tc_bwd_bf16_launch,
                      lib.lstm_tc_bwd_bf16_max_groups))
    n = scan_tc.run_bwd(
        launch, query,
        tuple(t.data_ptr() for t in (gates, cs, dys, m, w_hh, dxp)),
        w_hh, T, B, 4, reverse, mode, rows)
    return dxp, n


class LSTMScan(torch.autograd.Function):
    """ys = scan(x_proj, w_hh, mask) with the hand-written backward.
    ``use_kernel`` picks K2 / K2b (CUDA tensors; bf16 x_proj takes their
    bf16 variants: K2-bf16 when serving, ``lstm_train_bf16`` and
    ``lstm_bwd_bf16`` under amp training) or the plain versions (CPU
    tensors, or the card with the kernels switched off). The forward keeps
    residuals only when a gradient is needed, so serving pays nothing
    extra. The gradients take the inputs' dtypes: dxp bf16 under amp,
    dW_hh f32."""

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
