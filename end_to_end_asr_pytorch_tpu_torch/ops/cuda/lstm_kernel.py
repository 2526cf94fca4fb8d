"""K2 (forward): masked LSTM time scan — wrapper for ``csrc/lstm_scan.cu``
and its plain PyTorch version.

Replaces ``end_to_end_asr_pytorch_tpu/ops/pallas/lstm_kernel.py:_run_fwd``
(through ``lstm_scan_fused``). On the H100 the scan is bound by its T serial
(B, H) x (H, 4H) f32 products; the kernel is one persistent cooperative
launch per (layer, direction) that keeps W_hh and the cell state in shared
memory and synchronises the grid once per step (see the CUDA source). The
TPU kernel's UNROLL / B_TILE are TPU pipeline devices and are not carried
over; its residual outputs (cell states, gates) and the backward kernel
belong to training and are not ported yet.

Numerics: the TPU kernel pins Precision.DEFAULT (bf16 multiplies on a TPU,
f32 in CPU interpret mode). This kernel is f32 throughout and is held to the
f32 plain scan.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

_NT = 256  # threads per block in the kernel
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "lstm_max_coresident": (_I, [_I, _I, _I, ctypes.POINTER(_I)]),
    "lstm_fwd_launch": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
}


def lstm_scan_plain(x_proj: torch.Tensor, w_hh: torch.Tensor,
                    mask: torch.Tensor, reverse: bool = False,
                    h0: Optional[torch.Tensor] = None,
                    c0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: x_proj (T, B, 4H), w_hh (H, 4H), mask (T, B) bool ->
    ys (T, B, H). Padded steps emit zeros and hold the carry."""
    T, B, _ = x_proj.shape
    H = w_hh.shape[0]
    h = torch.zeros((B, H), dtype=x_proj.dtype, device=x_proj.device) \
        if h0 is None else h0
    c = torch.zeros((B, H), dtype=x_proj.dtype, device=x_proj.device) \
        if c0 is None else c0
    ys = [None] * T
    zero = torch.zeros((), dtype=x_proj.dtype, device=x_proj.device)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = x_proj[t] + h @ w_hh
        i, f, g, o = gates.split(H, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = mask[t][:, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        ys[t] = torch.where(m, h_new, zero)
    return torch.stack(ys)


def _pick_units(H: int, B: int, lib) -> int:
    """Hidden units per block: the smallest power of two that divides H and
    leaves a grid that is co-resident on the card."""
    dev = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    U = 1
    while U <= _NT // 2:
        if H % U == 0 and H // U <= sms:
            out = ctypes.c_int(0)
            build.check(lib.lstm_max_coresident(B, H, U, ctypes.byref(out)),
                        "lstm occupancy query")
            if H // U <= out.value:
                return U
        U *= 2
    raise ValueError(f"lstm_scan_fused: no co-resident grid for H={H}, B={B}")


def lstm_scan_fused(x_proj: torch.Tensor, w_hh: torch.Tensor,
                    mask: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """x_proj (T, B, 4H) f32, w_hh (H, 4H) f32, mask (T, B) bool ->
    ys (T, B, H). CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if x_proj.device.type == "cpu":
        return lstm_scan_plain(x_proj, w_hh, mask, reverse)
    if x_proj.device.type != "cuda":
        raise ValueError(f"lstm_scan_fused: unsupported device {x_proj.device}")
    T, B, G = x_proj.shape
    H = G // 4
    for name, t, shape, dt in (("x_proj", x_proj, (T, B, 4 * H), torch.float32),
                               ("w_hh", w_hh, (H, 4 * H), torch.float32),
                               ("mask", mask, (T, B), torch.bool)):
        if (t.device != x_proj.device or t.dtype != dt
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"lstm_scan_fused: {name} must be a contiguous "
                             f"{dt} {shape} tensor on {x_proj.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    lib = build.load("lstm_scan", _SIGNATURES)
    U = _pick_units(H, B, lib)
    ys = torch.empty((T, B, H), dtype=torch.float32, device=x_proj.device)
    hbuf = torch.zeros((2, H, B), dtype=torch.float32, device=x_proj.device)
    m = mask.to(torch.float32)
    stream = torch.cuda.current_stream(x_proj.device).cuda_stream
    rc = lib.lstm_fwd_launch(x_proj.data_ptr(), w_hh.data_ptr(), m.data_ptr(),
                             ys.data_ptr(), hbuf.data_ptr(), T, B, H, U,
                             int(reverse), stream)
    build.check(rc, "lstm_scan_fused launch")
    lstm_scan_fused.launches += 1
    return ys


lstm_scan_fused.launches = 0
