"""K4 / K4b: masked GRU time scan, forward and backward — wrappers for
``csrc/gru_scan.cu``, their plain PyTorch versions, and the autograd
Function that joins them.

Replaces ``end_to_end_asr_pytorch_tpu/ops/pallas/gru_kernel.py``:
``_run_fwd`` (forward, with the gate and hp_n residuals) and ``_run_bwd``
(reverse-time gradients of x_proj and of the hidden projection), tied
together by the ``jax.custom_vjp`` of ``gru_scan_fused`` (``_g_fwd`` /
``_g_bwd``), whose counterpart here is ``GRUScan``. On the H100 both
passes are bound by the latency of their T serial steps, each a (B, H) x
(H, 3H) product behind one exchange across blocks; both run on the tensor
cores of ``scan_tc`` (per layer, direction and group of batch rows a
cluster or a cooperative grid of blocks that hold their W_hh fragments in
registers and split the f32 carry, or the backward's dhp, into three bf16
parts, so the product equals the f32 one; h through distributed shared
memory, dhp through L2 or distributed shared memory). dW_hh = hs_prev^T
dhp and db_hh = sum dhp are one ``torch.matmul`` and one sum outside the
backward kernel, as the TPU wrapper leaves them to XLA.
The TPU kernels' UNROLL / B_TILE are TPU pipeline devices and are not
carried over; time is walked by index in both directions, with no flipped
copies.

Numerics: the kernels compute in f32 throughout (no Precision.DEFAULT bf16
multiplies) and are held to the f32 plain versions. The forward also takes
bf16 x_proj (decode amp): ``gru_scan_bf16`` (K4-bf16) widens x_proj as it
reads it, keeps W_hh, b_hh, the carry and the gate math in f32 and writes ys
rounded to bf16, as the TPU kernel does; its plain version is
``gru_scan_plain`` on bf16 x_proj. K4 in f32, K4-bf16 and K2 share the
forward scan; only the gate epilogue differs.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build, scan_tc
from .lstm_kernel import _prev_step

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gru_tc_max_groups": (_I, [_I] * 7 + [ctypes.POINTER(_I)]),
    "gru_tc_launch": (_I, [_P] * 7 + [_I] * 12 + [_P]),
    "gru_tc_f32_max_groups": (_I, [_I] * 7 + [ctypes.POINTER(_I)]),
    "gru_tc_f32_launch": (_I, [_P] * 9 + [_I] * 12 + [_P]),
    "gru_tc_bwd_max_groups": (_I, [_I] * 7 + [ctypes.POINTER(_I)]),
    "gru_tc_bwd_launch": (_I, [_P] * 10 + [_I] * 12 + [_P]),
}


def _scan(x_proj, w_hh, b_hh, mask, reverse, h, residuals):
    """The recurrence in the carry's dtype; ys in x_proj's."""
    T = x_proj.shape[0]
    H = w_hh.shape[0]
    ys, gs, hps = [None] * T, [None] * T, [None] * T
    zero = torch.zeros((), dtype=h.dtype, device=x_proj.device)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        xp = x_proj[t].to(h.dtype)
        hp = h @ w_hh + b_hh
        r = torch.sigmoid(xp[:, :H] + hp[:, :H])
        z = torch.sigmoid(xp[:, H:2 * H] + hp[:, H:2 * H])
        hp_n = hp[:, 2 * H:]
        n = torch.tanh(xp[:, 2 * H:] + r * hp_n)
        h_new = (1.0 - z) * n + z * h
        m = mask[t][:, None]
        h = torch.where(m, h_new, h)
        ys[t] = torch.where(m, h_new, zero)
        if residuals:
            gs[t] = torch.cat([r, z, n], dim=-1)
            hps[t] = hp_n
    if residuals:
        return torch.stack(ys), torch.stack(gs), torch.stack(hps)
    return torch.stack(ys).to(x_proj.dtype)


def gru_scan_plain(x_proj: torch.Tensor, w_hh: torch.Tensor,
                   b_hh: torch.Tensor, mask: torch.Tensor,
                   reverse: bool = False,
                   h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain scan: x_proj (T, B, 3H), w_hh (H, 3H), b_hh (3H,), mask (T, B)
    bool -> ys (T, B, H) in x_proj's dtype. Padded steps emit zeros and hold
    the carry. Without an initial state the carry is f32 and bf16 x_proj is
    widened each step (K4's bf16 contract). Autograd runs through its loop
    (the path with an initial state)."""
    B = x_proj.shape[1]
    H = w_hh.shape[0]
    if h0 is None:
        h0 = torch.zeros((B, H), dtype=torch.float32, device=x_proj.device)
    return _scan(x_proj, w_hh, b_hh, mask, reverse, h0, False)


def gru_scan_fwd_plain(x_proj: torch.Tensor, w_hh: torch.Tensor,
                       b_hh: torch.Tensor, mask: torch.Tensor,
                       reverse: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel with residuals: -> ys (T, B, H),
    gates (T, B, 3H) post-activation (r, z, n), hp_n (T, B, H) the n third
    of h @ W_hh + b_hh, each indexed by real time."""
    B = x_proj.shape[1]
    H = w_hh.shape[0]
    z = torch.zeros((B, H), dtype=x_proj.dtype, device=x_proj.device)
    return _scan(x_proj, w_hh, b_hh, mask, reverse, z, True)


def gru_bwd_steps_plain(gates: torch.Tensor, hp_n: torch.Tensor,
                        ys: torch.Tensor, mask: torch.Tensor,
                        w_hh: torch.Tensor, dys: torch.Tensor,
                        reverse: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel's own outputs: the explicit
    reverse-time recurrence of ``_bwd_kernel``. -> (dxp, dhp), each
    (T, B, 3H); they differ only in the n third (dan against dan r)."""
    T, B, G = gates.shape
    H = G // 3
    hs_prev = _prev_step(ys, reverse)
    dh_c = torch.zeros((B, H), dtype=gates.dtype, device=gates.device)
    w_t = w_hh.t()
    dxp, dhp = [None] * T, [None] * T
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        r, z, n = gates[t].split(H, dim=-1)
        m = mask[t][:, None].to(gates.dtype)
        dh = dh_c + dys[t]
        dz = dh * (hs_prev[t] - n)
        dn = dh * (1.0 - z)
        dan = dn * (1.0 - n * n)
        dar = (dan * hp_n[t]) * r * (1.0 - r)
        daz = dz * z * (1.0 - z)
        dxp[t] = m * torch.cat([dar, daz, dan], dim=-1)
        dhp[t] = m * torch.cat([dar, daz, dan * r], dim=-1)
        dh_c = dhp[t] @ w_t + m * (dh * z) + (1.0 - m) * dh_c
    return torch.stack(dxp), torch.stack(dhp)


def dw_db(ys: torch.Tensor, dhp: torch.Tensor, reverse: bool
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dW_hh = sum_t hs_prev[t]^T dhp[t] (one GEMM) and db_hh = sum dhp,
    hs_prev the forward's previous output; outside the kernel."""
    hs_prev = _prev_step(ys, reverse)
    H, G = ys.shape[-1], dhp.shape[-1]
    return (hs_prev.reshape(-1, H).t() @ dhp.reshape(-1, G),
            dhp.sum(dim=(0, 1)))


def gru_scan_bwd_plain(gates: torch.Tensor, hp_n: torch.Tensor,
                       ys: torch.Tensor, mask: torch.Tensor,
                       w_hh: torch.Tensor, dys: torch.Tensor,
                       reverse: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``gru_bwd_fused``: -> (dxp (T, B, 3H),
    dW_hh (H, 3H), db_hh (3H,))."""
    dxp, dhp = gru_bwd_steps_plain(gates, hp_n, ys, mask, w_hh, dys, reverse)
    return (dxp, *dw_db(ys, dhp, reverse))


def _check_fwd(what, x_proj, w_hh, b_hh, mask, dtype):
    T, B, G = x_proj.shape
    H = G // 3
    build.check_inputs(what, x_proj,
                       ("x_proj", x_proj, (T, B, 3 * H), dtype),
                       ("w_hh", w_hh, (H, 3 * H), torch.float32),
                       ("b_hh", b_hh, (3 * H,), torch.float32),
                       ("mask", mask, (T, B), torch.bool))
    if x_proj.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x_proj.device}")
    return T, B, H


def gru_scan_fused(x_proj: torch.Tensor, w_hh: torch.Tensor,
                   b_hh: torch.Tensor, mask: torch.Tensor,
                   reverse: bool = False, residuals: bool = False):
    """K4. x_proj (T, B, 3H) f32, w_hh (H, 3H) f32, b_hh (3H,) f32, mask
    (T, B) bool -> ys (T, B, H), or (ys, gates, hp_n) with ``residuals``.
    bf16 x_proj goes to ``gru_scan_bf16`` (no residuals). CPU tensors take
    the plain version; CUDA tensors launch the tensor-core scan
    (``gru_fwd_tc``), once, or once per wave where a grid's groups do not
    all fit. Either way, inputs of another dtype or layout raise."""
    if x_proj.dtype == torch.bfloat16 and not residuals:
        return gru_scan_bf16(x_proj, w_hh, b_hh, mask, reverse)
    _check_fwd("gru_scan_fused", x_proj, w_hh, b_hh, mask, torch.float32)
    if x_proj.device.type == "cpu":
        if residuals:
            return gru_scan_fwd_plain(x_proj, w_hh, b_hh, mask, reverse)
        return gru_scan_plain(x_proj, w_hh, b_hh, mask, reverse)
    out, n = gru_fwd_tc(x_proj, w_hh, b_hh, mask, reverse, residuals)
    gru_scan_fused.launches += n
    return out


gru_scan_fused.launches = 0


def gru_fwd_tc(x_proj: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
               mask: torch.Tensor, reverse: bool = False,
               residuals: bool = False, mode: Optional[int] = None,
               rows: Optional[int] = None):
    """K4's launch on checked f32 CUDA tensors -> (ys or (ys, gates, hp_n),
    launches): the tensor-core scan (``scan_tc.run``) in the design
    ``mode`` / ``rows`` (default: ``scan_tc.pick``'s). Counts nothing;
    ``gru_scan_fused`` does."""
    T, B, G = x_proj.shape
    H = G // 3
    lib = build.load("gru_scan", _SIGNATURES)
    res = ((torch.empty((T, B, G), dtype=torch.float32, device=x_proj.device),
            torch.empty((T, B, H), dtype=torch.float32, device=x_proj.device))
           if residuals else ())
    ys, n = scan_tc.run(lib.gru_tc_f32_launch, lib.gru_tc_f32_max_groups,
                        x_proj, w_hh, (b_hh,), mask, reverse, 3, mode, rows,
                        tuple(t.data_ptr() for t in res) or (None, None))
    return ((ys, *res) if residuals else ys), n


def gru_scan_bf16(x_proj: torch.Tensor, w_hh: torch.Tensor,
                  b_hh: torch.Tensor, mask: torch.Tensor,
                  reverse: bool = False) -> torch.Tensor:
    """K4-bf16 (decode amp). x_proj (T, B, 3H) bf16, w_hh (H, 3H) and b_hh
    (3H,) f32, mask (T, B) bool -> ys (T, B, H) bf16; carry and gate math
    f32. CPU tensors take the plain version; CUDA tensors launch the
    tensor-core kernel (``scan_tc``). Either way, inputs of another dtype
    or layout raise."""
    T, B, H = _check_fwd("gru_scan_bf16", x_proj, w_hh, b_hh, mask,
                         torch.bfloat16)
    if x_proj.device.type == "cpu":
        return gru_scan_plain(x_proj, w_hh, b_hh, mask, reverse)
    lib = build.load("gru_scan", _SIGNATURES)
    ys, n = scan_tc.run(lib.gru_tc_launch, lib.gru_tc_max_groups, x_proj,
                        w_hh, (b_hh,), mask, reverse, 3)
    gru_scan_bf16.launches += n
    return ys


gru_scan_bf16.launches = 0


def gru_bwd_fused(gates: torch.Tensor, hp_n: torch.Tensor, ys: torch.Tensor,
                  mask: torch.Tensor, w_hh: torch.Tensor, dys: torch.Tensor,
                  reverse: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4b. gates (T, B, 3H), hp_n / ys / dys (T, B, H), mask (T, B) bool,
    w_hh (H, 3H), all f32 -> (dxp (T, B, 3H), dW_hh (H, 3H), db_hh (3H,));
    dW_hh and db_hh are one GEMM and one sum after the kernel. CPU tensors
    take the plain version; CUDA tensors launch the kernel. Either way,
    inputs of another dtype or layout raise."""
    T, B, G = gates.shape
    H = G // 3
    build.check_inputs("gru_bwd_fused", gates,
                       ("gates", gates, (T, B, 3 * H), torch.float32),
                       ("hp_n", hp_n, (T, B, H), torch.float32),
                       ("ys", ys, (T, B, H), torch.float32),
                       ("dys", dys, (T, B, H), torch.float32),
                       ("mask", mask, (T, B), torch.bool),
                       ("w_hh", w_hh, (H, 3 * H), torch.float32))
    if gates.device.type == "cpu":
        return gru_scan_bwd_plain(gates, hp_n, ys, mask, w_hh, dys, reverse)
    if gates.device.type != "cuda":
        raise ValueError(f"gru_bwd_fused: unsupported device {gates.device}")
    dxp, dhp, n = gru_bwd_tc(gates, hp_n, ys, mask, w_hh, dys, reverse)
    gru_bwd_fused.launches += n
    return (dxp, *dw_db(ys, dhp, reverse))


gru_bwd_fused.launches = 0


def gru_bwd_tc(gates: torch.Tensor, hp_n: torch.Tensor, ys: torch.Tensor,
               mask: torch.Tensor, w_hh: torch.Tensor, dys: torch.Tensor,
               reverse: bool = False, mode: Optional[int] = None,
               rows: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """K4b's launch on checked CUDA tensors -> (dxp, dhp, launches), each
    (T, B, 3H): the tensor-core backward scan (``scan_tc.run_bwd``) in the
    design ``mode`` / ``rows`` (default: ``scan_tc.pick``'s). Counts
    nothing; ``gru_bwd_fused`` does."""
    T, B, G = gates.shape
    lib = build.load("gru_scan", _SIGNATURES)
    dev = gates.device
    dxp = torch.empty((T, B, G), dtype=torch.float32, device=dev)
    dhp = torch.empty((T, B, G), dtype=torch.float32, device=dev)
    m = mask.to(torch.float32)
    n = scan_tc.run_bwd(
        lib.gru_tc_bwd_launch, lib.gru_tc_bwd_max_groups,
        tuple(t.data_ptr() for t in (gates, hp_n, ys, dys, m, w_hh, dxp,
                                     dhp)),
        w_hh, T, B, 3, reverse, mode, rows)
    return dxp, dhp, n


class GRUScan(torch.autograd.Function):
    """ys = scan(x_proj, w_hh, b_hh, mask) with the hand-written backward.
    ``use_kernel`` picks K4 / K4b (CUDA tensors; bf16 x_proj takes K4's
    bf16 variant and has no backward) or the plain versions (CPU tensors,
    or the card with the kernels switched off). The forward keeps residuals
    only when a gradient is needed, so serving pays nothing extra."""

    @staticmethod
    def forward(ctx, x_proj, w_hh, b_hh, mask, reverse: bool,
                use_kernel: bool):
        need = any(ctx.needs_input_grad[:3])
        ctx.reverse, ctx.use_kernel = reverse, use_kernel
        if use_kernel:
            out = gru_scan_fused(x_proj, w_hh, b_hh, mask, reverse,
                                 residuals=need)
        elif need:
            out = gru_scan_fwd_plain(x_proj, w_hh, b_hh, mask, reverse)
        else:
            out = gru_scan_plain(x_proj, w_hh, b_hh, mask, reverse)
        if not need:
            return out
        ys, gates, hp_n = out
        ctx.save_for_backward(ys, gates, hp_n, mask, w_hh)
        return ys

    @staticmethod
    def backward(ctx, dys):
        ys, gates, hp_n, mask, w_hh = ctx.saved_tensors
        run = gru_bwd_fused if ctx.use_kernel else gru_scan_bwd_plain
        dxp, dw, db = run(gates, hp_n, ys, mask, w_hh, dys.contiguous(),
                          ctx.reverse)
        return dxp, dw, db, None, None, None
