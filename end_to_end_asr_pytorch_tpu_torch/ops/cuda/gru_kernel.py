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
bf16 x_proj: ``gru_scan_bf16`` (K4-bf16, decode amp) widens x_proj as it
reads it, keeps W_hh, b_hh, the carry and the gate math in f32 and writes ys
rounded to bf16, as the TPU kernel does; ``gru_train_bf16`` (amp training)
also writes the gates and hp_n rounded to bf16, and ``gru_bwd_bf16`` (K4b's
bf16 variant) widens them, takes h_prev from the bf16 ys, writes dxp
rounded to bf16 and keeps dhp f32. Their plain versions are
``gru_scan_plain``, ``gru_scan_fwd_plain`` and ``gru_scan_bwd_plain`` on bf16
tensors. K4, its bf16 variants and K2 share the forward scan; only the
gate epilogue differs. A width H that is not a multiple of 4 is
zero-padded around the kernels (``scan_tc.pad_units``).
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
    "gru_tc_bf16_res_max_groups": (_I, [_I] * 7 + [ctypes.POINTER(_I)]),
    "gru_tc_bf16_res_launch": (_I, [_P] * 9 + [_I] * 12 + [_P]),
    "gru_tc_bwd_bf16_max_groups": (_I, [_I] * 7 + [ctypes.POINTER(_I)]),
    "gru_tc_bwd_bf16_launch": (_I, [_P] * 10 + [_I] * 12 + [_P]),
}


def _scan(x_proj, w_hh, b_hh, mask, reverse, h, residuals):
    """The recurrence in the carry's dtype; ys (and the residuals) in
    x_proj's."""
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
        return tuple(torch.stack(a).to(x_proj.dtype) for a in (ys, gs, hps))
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
    of h @ W_hh + b_hh, each indexed by real time and in x_proj's dtype;
    the carry and the gate math are f32 (bf16 x_proj widened each step)."""
    B = x_proj.shape[1]
    H = w_hh.shape[0]
    z = torch.zeros((B, H), dtype=torch.float32, device=x_proj.device)
    return _scan(x_proj, w_hh, b_hh, mask, reverse, z, True)


def gru_bwd_steps_plain(gates: torch.Tensor, hp_n: torch.Tensor,
                        ys: torch.Tensor, mask: torch.Tensor,
                        w_hh: torch.Tensor, dys: torch.Tensor,
                        reverse: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel's own outputs: the explicit
    reverse-time recurrence of ``_bwd_kernel`` in f32 on the widened inputs
    (h_prev the stored ys of the previous step). -> (dxp in ys' dtype, dhp
    f32), each (T, B, 3H); they differ only in the n third (dan against
    dan r)."""
    T, B, G = gates.shape
    H = G // 3
    dt = ys.dtype
    gates, hp_n, dys = gates.float(), hp_n.float(), dys.float()
    hs_prev = _prev_step(ys, reverse).float()
    dh_c = torch.zeros((B, H), dtype=torch.float32, device=gates.device)
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
    return torch.stack(dxp).to(dt), torch.stack(dhp)


def dw_db(ys: torch.Tensor, dhp: torch.Tensor, reverse: bool
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dW_hh = sum_t hs_prev[t]^T dhp[t] (one GEMM) and db_hh = sum dhp,
    hs_prev the forward's previous output (widened from bf16 under amp);
    outside the kernel."""
    hs_prev = _prev_step(ys, reverse).float()
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


def gru_scan_fused(x_proj: torch.Tensor, w_hh: torch.Tensor,
                   b_hh: torch.Tensor, mask: torch.Tensor,
                   reverse: bool = False, residuals: bool = False):
    """K4. x_proj (T, B, 3H) f32, w_hh (H, 3H) f32, b_hh (3H,) f32, mask
    (T, B) bool -> ys (T, B, H), or (ys, gates, hp_n) with ``residuals``.
    bf16 x_proj goes to ``gru_scan_bf16`` (serving) or, with residuals,
    ``gru_train_bf16``. CPU tensors take the plain version; CUDA tensors
    launch the tensor-core scan (``gru_fwd_tc``), once, or once per wave
    where a grid's groups do not all fit. Either way, inputs of another
    dtype or layout raise."""
    if x_proj.dtype == torch.bfloat16:
        run = gru_train_bf16 if residuals else gru_scan_bf16
        return run(x_proj, w_hh, b_hh, mask, reverse)
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
    """K4's launch on checked CUDA tensors -> (ys or (ys, gates, hp_n),
    launches): the tensor-core scan (``scan_tc.run``) in the design
    ``mode`` / ``rows`` (default: ``scan_tc.pick``'s); f32, bf16 serving
    or bf16 with residuals by x_proj's dtype, outputs in that dtype. H not
    a multiple of 4 is zero-padded around it. Counts nothing; the wrappers
    do."""
    T, B, G = x_proj.shape
    H = G // 3
    Hp = scan_tc.padded(H)
    if Hp != H:
        out, n = gru_fwd_tc(scan_tc.pad_units(x_proj, 3, Hp),
                            scan_tc.pad_w(w_hh, 3, Hp),
                            scan_tc.pad_units(b_hh, 3, Hp), mask, reverse,
                            residuals, mode, rows)
        if not residuals:
            return scan_tc.unpad_units(out, 1, H), n
        ys, gates, hp_n = out
        return (scan_tc.unpad_units(ys, 1, H),
                scan_tc.unpad_units(gates, 3, H),
                scan_tc.unpad_units(hp_n, 1, H)), n
    lib = build.load("gru_scan", _SIGNATURES)
    dt = x_proj.dtype
    res = ((torch.empty((T, B, G), dtype=dt, device=x_proj.device),
            torch.empty((T, B, H), dtype=dt, device=x_proj.device))
           if residuals else ())
    if dt == torch.float32:
        launch, query = lib.gru_tc_f32_launch, lib.gru_tc_f32_max_groups
        outs = tuple(t.data_ptr() for t in res) or (None, None)
    elif residuals:
        launch, query = (lib.gru_tc_bf16_res_launch,
                         lib.gru_tc_bf16_res_max_groups)
        outs = tuple(t.data_ptr() for t in res)
    else:
        launch, query, outs = lib.gru_tc_launch, lib.gru_tc_max_groups, ()
    ys, n = scan_tc.run(launch, query, x_proj, w_hh, (b_hh,), mask, reverse,
                        3, mode, rows, outs)
    return ((ys, *res) if residuals else ys), n


def gru_scan_bf16(x_proj: torch.Tensor, w_hh: torch.Tensor,
                  b_hh: torch.Tensor, mask: torch.Tensor,
                  reverse: bool = False) -> torch.Tensor:
    """K4-bf16 (decode amp). x_proj (T, B, 3H) bf16, w_hh (H, 3H) and b_hh
    (3H,) f32, mask (T, B) bool -> ys (T, B, H) bf16; carry and gate math
    f32. CPU tensors take the plain version; CUDA tensors launch the
    tensor-core kernel (``scan_tc``). Either way, inputs of another dtype
    or layout raise."""
    _check_fwd("gru_scan_bf16", x_proj, w_hh, b_hh, mask, torch.bfloat16)
    if x_proj.device.type == "cpu":
        return gru_scan_plain(x_proj, w_hh, b_hh, mask, reverse)
    ys, n = gru_fwd_tc(x_proj, w_hh, b_hh, mask, reverse)
    gru_scan_bf16.launches += n
    return ys


gru_scan_bf16.launches = 0


def gru_train_bf16(x_proj: torch.Tensor, w_hh: torch.Tensor,
                   b_hh: torch.Tensor, mask: torch.Tensor,
                   reverse: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 with residuals in bf16 (amp training; JAX ``_run_fwd`` on bf16
    x_proj). x_proj (T, B, 3H) bf16, w_hh (H, 3H) and b_hh (3H,) f32, mask
    (T, B) bool -> (ys, gates, hp_n), all bf16, each rounded once where the
    kernel stores it; the carry and the gate math f32. CPU tensors take
    ``gru_scan_fwd_plain``; CUDA tensors launch the tensor-core scan.
    Either way, inputs of another dtype or layout raise."""
    _check_fwd("gru_train_bf16", x_proj, w_hh, b_hh, mask, torch.bfloat16)
    if x_proj.device.type == "cpu":
        return gru_scan_fwd_plain(x_proj, w_hh, b_hh, mask, reverse)
    out, n = gru_fwd_tc(x_proj, w_hh, b_hh, mask, reverse, residuals=True)
    gru_train_bf16.launches += n
    return out


gru_train_bf16.launches = 0


def _check_bwd(what, gates, hp_n, ys, mask, w_hh, dys, dtype):
    T, B, G = gates.shape
    H = G // 3
    build.check_inputs(what, gates,
                       ("gates", gates, (T, B, 3 * H), dtype),
                       ("hp_n", hp_n, (T, B, H), dtype),
                       ("ys", ys, (T, B, H), dtype),
                       ("dys", dys, (T, B, H), dtype),
                       ("mask", mask, (T, B), torch.bool),
                       ("w_hh", w_hh, (H, 3 * H), torch.float32))
    if gates.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {gates.device}")


def gru_bwd_fused(gates: torch.Tensor, hp_n: torch.Tensor, ys: torch.Tensor,
                  mask: torch.Tensor, w_hh: torch.Tensor, dys: torch.Tensor,
                  reverse: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4b. gates (T, B, 3H), hp_n / ys / dys (T, B, H), mask (T, B) bool,
    w_hh (H, 3H), all f32 -> (dxp (T, B, 3H), dW_hh (H, 3H), db_hh (3H,));
    dW_hh and db_hh are one GEMM and one sum after the kernel. bf16
    residuals go to ``gru_bwd_bf16``. CPU tensors take the plain version;
    CUDA tensors launch the kernel. Either way, inputs of another dtype or
    layout raise."""
    if gates.dtype == torch.bfloat16:
        return gru_bwd_bf16(gates, hp_n, ys, mask, w_hh, dys, reverse)
    _check_bwd("gru_bwd_fused", gates, hp_n, ys, mask, w_hh, dys,
               torch.float32)
    if gates.device.type == "cpu":
        return gru_scan_bwd_plain(gates, hp_n, ys, mask, w_hh, dys, reverse)
    dxp, dhp, n = gru_bwd_tc(gates, hp_n, ys, mask, w_hh, dys, reverse)
    gru_bwd_fused.launches += n
    return (dxp, *dw_db(ys, dhp, reverse))


gru_bwd_fused.launches = 0


def gru_bwd_bf16(gates: torch.Tensor, hp_n: torch.Tensor, ys: torch.Tensor,
                 mask: torch.Tensor, w_hh: torch.Tensor, dys: torch.Tensor,
                 reverse: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4b in bf16 (amp training; JAX ``_run_bwd`` on bf16 residuals).
    gates (T, B, 3H), hp_n / ys / dys (T, B, H) bf16, mask (T, B) bool,
    w_hh (H, 3H) f32 -> (dxp (T, B, 3H) bf16, dW_hh (H, 3H), db_hh (3H,)
    f32): the math in f32 on the widened inputs, h_prev the bf16 ys of the
    previous step, dxp rounded where the kernel stores it, dW_hh and db_hh
    from the f32 dhp. CPU tensors take ``gru_scan_bwd_plain``; CUDA tensors
    launch the tensor-core backward scan. Either way, inputs of another
    dtype or layout raise."""
    _check_bwd("gru_bwd_bf16", gates, hp_n, ys, mask, w_hh, dys,
               torch.bfloat16)
    if gates.device.type == "cpu":
        return gru_scan_bwd_plain(gates, hp_n, ys, mask, w_hh, dys, reverse)
    dxp, dhp, n = gru_bwd_tc(gates, hp_n, ys, mask, w_hh, dys, reverse)
    gru_bwd_bf16.launches += n
    return (dxp, *dw_db(ys, dhp, reverse))


gru_bwd_bf16.launches = 0


def gru_bwd_tc(gates: torch.Tensor, hp_n: torch.Tensor, ys: torch.Tensor,
               mask: torch.Tensor, w_hh: torch.Tensor, dys: torch.Tensor,
               reverse: bool = False, mode: Optional[int] = None,
               rows: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """K4b's launch on checked CUDA tensors -> (dxp in the residuals'
    dtype, dhp f32, launches), each (T, B, 3H): the tensor-core backward
    scan (``scan_tc.run_bwd``, f32 or bf16 by the residuals' dtype) in the
    design ``mode`` / ``rows`` (default: ``scan_tc.pick``'s). H not a
    multiple of 4 is zero-padded around it. Counts nothing; the wrappers
    do."""
    T, B, G = gates.shape
    H = G // 3
    Hp = scan_tc.padded(H)
    if Hp != H:
        pu = scan_tc.pad_units
        dxp, dhp, n = gru_bwd_tc(pu(gates, 3, Hp), pu(hp_n, 1, Hp),
                                 pu(ys, 1, Hp), mask,
                                 scan_tc.pad_w(w_hh, 3, Hp), pu(dys, 1, Hp),
                                 reverse, mode, rows)
        return (scan_tc.unpad_units(dxp, 3, H),
                scan_tc.unpad_units(dhp, 3, H), n)
    lib = build.load("gru_scan", _SIGNATURES)
    dev = gates.device
    dxp = torch.empty((T, B, G), dtype=gates.dtype, device=dev)
    dhp = torch.empty((T, B, G), dtype=torch.float32, device=dev)
    m = mask.to(torch.float32)
    launch, query = ((lib.gru_tc_bwd_launch, lib.gru_tc_bwd_max_groups)
                     if gates.dtype == torch.float32 else
                     (lib.gru_tc_bwd_bf16_launch,
                      lib.gru_tc_bwd_bf16_max_groups))
    n = scan_tc.run_bwd(
        launch, query,
        tuple(t.data_ptr() for t in (gates, hp_n, ys, dys, m, w_hh, dxp,
                                     dhp)),
        w_hh, T, B, 3, reverse, mode, rows)
    return dxp, dhp, n


class GRUScan(torch.autograd.Function):
    """ys = scan(x_proj, w_hh, b_hh, mask) with the hand-written backward.
    ``use_kernel`` picks K4 / K4b (CUDA tensors; bf16 x_proj takes their
    bf16 variants: K4-bf16 when serving, ``gru_train_bf16`` and
    ``gru_bwd_bf16`` under amp training) or the plain versions (CPU
    tensors, or the card with the kernels switched off). The forward keeps
    residuals only when a gradient is needed, so serving pays nothing
    extra. The gradients take the inputs' dtypes: dxp bf16 under amp,
    dW_hh and db_hh f32."""

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
