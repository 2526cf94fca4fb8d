"""K5: one beam step of single-head location attention — wrapper for
``csrc/loc_att.cu`` and its plain PyTorch version.

Replaces ``end_to_end_asr_pytorch_tpu/ops/pallas/att_kernel.py``
``loc_attention_fused`` with the same contract: qb (B, K, d) query
projection plus bias, keys (B, T, d), fsm (B, K, T, F) location-conv
features, w_f (F, d), v (d,) energy vector, vals (B, T, vdim), enc_len (B,)
-> (ctx (B, K, vdim), align (B, K, T)). Frames at or past ``enc_len`` get
the energy -1e30 before the softmax; ``enc_len`` is not clamped, so a
zero-length row gets a uniform alignment, as in the reference. On the H100
the kernel is bound by its f32 operations, just above its bytes (see the
CUDA source).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

NEG_INF = -1e30
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "loc_att_launch": (_I, [_P] * 9 + [_I] * 6 + [ctypes.c_float, _P]),
}


def loc_attention_plain(qb: torch.Tensor, keys: torch.Tensor,
                        fsm: torch.Tensor, w_f: torch.Tensor,
                        v: torch.Tensor, vals: torch.Tensor,
                        enc_len: torch.Tensor, temperature: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel, the TPU kernel's arithmetic."""
    T = keys.shape[1]
    f = fsm @ w_f                                           # (B, K, T, d)
    th = torch.tanh(qb[:, :, None, :] + keys[:, None] + f)
    energy = (th @ v) * (1.0 / temperature)                 # (B, K, T)
    mask = torch.arange(T, device=qb.device)[None, :] < enc_len[:, None]
    energy = torch.where(mask[:, None], energy,
                         torch.full((), NEG_INF, device=qb.device))
    align = torch.softmax(energy, dim=-1)
    return align @ vals, align


def loc_attention_fused(qb: torch.Tensor, keys: torch.Tensor,
                        fsm: torch.Tensor, w_f: torch.Tensor,
                        v: torch.Tensor, vals: torch.Tensor,
                        enc_len: torch.Tensor, temperature: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5, every float input f32 and contiguous, enc_len int32. CPU tensors
    take the plain version; CUDA tensors launch the kernel. Either way,
    inputs of another dtype or layout raise."""
    B, K, d = qb.shape
    T, F, vdim = keys.shape[1], fsm.shape[-1], vals.shape[-1]
    f32 = torch.float32
    build.check_inputs("loc_attention_fused", qb,
                       ("qb", qb, (B, K, d), f32),
                       ("keys", keys, (B, T, d), f32),
                       ("fsm", fsm, (B, K, T, F), f32),
                       ("w_f", w_f, (F, d), f32),
                       ("v", v, (d,), f32),
                       ("vals", vals, (B, T, vdim), f32),
                       ("enc_len", enc_len, (B,), torch.int32))
    if qb.device.type == "cpu":
        return loc_attention_plain(qb, keys, fsm, w_f, v, vals, enc_len,
                                   temperature)
    if qb.device.type != "cuda":
        raise ValueError(f"loc_attention_fused: unsupported device {qb.device}")
    lib = build.load("loc_att", _SIGNATURES)
    ctx = torch.empty((B, K, vdim), dtype=f32, device=qb.device)
    align = torch.empty((B, K, T), dtype=f32, device=qb.device)
    stream = torch.cuda.current_stream(qb.device).cuda_stream
    rc = lib.loc_att_launch(qb.data_ptr(), keys.data_ptr(), fsm.data_ptr(),
                            w_f.data_ptr(), v.data_ptr(), vals.data_ptr(),
                            enc_len.data_ptr(), ctx.data_ptr(),
                            align.data_ptr(), B, K, T, d, F, vdim,
                            1.0 / temperature, stream)
    build.check(rc, "loc_attention_fused launch")
    loc_attention_fused.launches += 1
    return ctx, align


loc_attention_fused.launches = 0
