"""K7: the training step of single-head location attention, forward and
hand-written backward — wrappers for ``csrc/loc_att_train.cu``, their plain
PyTorch versions, and the autograd Function that joins them.

Replaces ``end_to_end_asr_pytorch_tpu/ops/pallas/att_train_kernel.py``:
``_fwd_call`` (forward) and ``_vjp_bwd`` (backward), tied together by the
``jax.custom_vjp`` of ``loc_att_train``, whose counterpart here is
``LocAttTrain``. Inputs: q (B, d) query projection plus bias, keys (B, T, d),
f (B, T, d) location features already projected by w_f, v (d,) energy
vector, vals (B, T, vdim), enc_len (B,) int32 (the caller clamps it to at
least 1). The backward recomputes tanh from the saved inputs and returns
one (B, T, d) gradient for both keys and f, which enter the chain as a sum.
On the H100 both kernels are bound by bytes (see the CUDA source). The TPU
kernel's 8-row blocking is a TPU pipeline device and is not carried over.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

NEG_INF = -1e30
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "loc_att_fwd_launch": (_I, [_P] * 8 + [_I] * 4 + [_F, _P]),
    "loc_att_bwd_launch": (_I, [_P] * 14 + [_I] * 4 + [_F, _P]),
}


def _tanh_chain(q, keys, f):
    return torch.tanh(q[:, None, :] + keys + f)              # (B, T, d)


def loc_att_fwd_plain(q: torch.Tensor, keys: torch.Tensor, f: torch.Tensor,
                      v: torch.Tensor, vals: torch.Tensor,
                      enc_len: torch.Tensor, temperature: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel -> (ctx (B, vdim), align (B, T)).
    Differentiable, so autograd through it checks the hand VJP."""
    T = keys.shape[1]
    energy = (_tanh_chain(q, keys, f) @ v) * (1.0 / temperature)
    mask = torch.arange(T, device=q.device)[None, :] < enc_len[:, None]
    energy = torch.where(mask, energy, torch.full((), NEG_INF, device=q.device))
    align = torch.softmax(energy, dim=-1)
    return (align[:, None, :] @ vals)[:, 0], align


def loc_att_bwd_plain(q: torch.Tensor, keys: torch.Tensor, f: torch.Tensor,
                      v: torch.Tensor, vals: torch.Tensor,
                      enc_len: torch.Tensor, align: torch.Tensor,
                      dctx: torch.Tensor, dalign: torch.Tensor,
                      temperature: float):
    """Plain version of the backward kernel, the TPU kernel's formulas ->
    (dq (B, d), dtarg (B, T, d), dvals (B, T, vdim), dv (d,))."""
    th = _tanh_chain(q, keys, f)
    dal = dalign + (vals @ dctx[:, :, None])[..., 0]         # (B, T)
    s = torch.sum(dal * align, dim=1, keepdim=True)
    dener = align * (dal - s) * (1.0 / temperature)
    dtarg = dener[:, :, None] * v * (1.0 - th * th)
    dvals = align[:, :, None] * dctx[:, None, :]
    dv = torch.einsum("bt,btd->d", dener, th)
    return dtarg.sum(dim=1), dtarg, dvals, dv


def _check(what, q, keys, f, v, vals, enc_len):
    B, T, d = keys.shape
    f32 = torch.float32
    build.check_inputs(what, q, ("q", q, (B, d), f32),
                       ("keys", keys, (B, T, d), f32),
                       ("f", f, (B, T, d), f32), ("v", v, (d,), f32),
                       ("vals", vals, (B, T, vals.shape[-1]), f32),
                       ("enc_len", enc_len, (B,), torch.int32))
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {q.device}")


def loc_att_fwd_fused(q: torch.Tensor, keys: torch.Tensor, f: torch.Tensor,
                      v: torch.Tensor, vals: torch.Tensor,
                      enc_len: torch.Tensor, temperature: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7 forward. CPU tensors take the plain version; CUDA tensors launch
    the kernel. Either way, inputs of another dtype or layout raise."""
    _check("loc_att_fwd_fused", q, keys, f, v, vals, enc_len)
    if q.device.type == "cpu":
        return loc_att_fwd_plain(q, keys, f, v, vals, enc_len, temperature)
    B, T, d = keys.shape
    vdim = vals.shape[-1]
    lib = build.load("loc_att_train", _SIGNATURES)
    ctx = torch.empty((B, vdim), dtype=torch.float32, device=q.device)
    align = torch.empty((B, T), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.loc_att_fwd_launch(q.data_ptr(), keys.data_ptr(), f.data_ptr(),
                                v.data_ptr(), vals.data_ptr(),
                                enc_len.data_ptr(), ctx.data_ptr(),
                                align.data_ptr(), B, T, d, vdim,
                                1.0 / temperature, stream)
    build.check(rc, "loc_att_fwd_fused launch")
    loc_att_fwd_fused.launches += 1
    return ctx, align


loc_att_fwd_fused.launches = 0


def loc_att_bwd_fused(q: torch.Tensor, keys: torch.Tensor, f: torch.Tensor,
                      v: torch.Tensor, vals: torch.Tensor,
                      enc_len: torch.Tensor, align: torch.Tensor,
                      dctx: torch.Tensor, dalign: torch.Tensor,
                      temperature: float):
    """K7 backward -> (dq, dtarg, dvals, dv). CPU tensors take the plain
    version; CUDA tensors launch the kernel (one call: the per-utterance
    backward, then the ordered sum of dv over the batch). Either way,
    inputs of another dtype or layout raise."""
    _check("loc_att_bwd_fused", q, keys, f, v, vals, enc_len)
    B, T, d = keys.shape
    vdim = vals.shape[-1]
    build.check_inputs("loc_att_bwd_fused", q,
                       ("align", align, (B, T), torch.float32),
                       ("dctx", dctx, (B, vdim), torch.float32),
                       ("dalign", dalign, (B, T), torch.float32))
    if q.device.type == "cpu":
        return loc_att_bwd_plain(q, keys, f, v, vals, enc_len, align, dctx,
                                 dalign, temperature)
    lib = build.load("loc_att_train", _SIGNATURES)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                       device=q.device)
    dq, dtarg, dvals = empty(B, d), empty(B, T, d), empty(B, T, vdim)
    dv_part, dv = empty(B, d), empty(d)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.loc_att_bwd_launch(q.data_ptr(), keys.data_ptr(), f.data_ptr(),
                                v.data_ptr(), vals.data_ptr(),
                                enc_len.data_ptr(), align.data_ptr(),
                                dctx.data_ptr(), dalign.data_ptr(),
                                dq.data_ptr(), dtarg.data_ptr(),
                                dvals.data_ptr(), dv_part.data_ptr(),
                                dv.data_ptr(), B, T, d, vdim,
                                1.0 / temperature, stream)
    build.check(rc, "loc_att_bwd_fused launch")
    loc_att_bwd_fused.launches += 1
    return dq, dtarg, dvals, dv


loc_att_bwd_fused.launches = 0


class LocAttTrain(torch.autograd.Function):
    """(ctx, align) of the training attention step with the hand-written
    backward. ``use_kernel`` picks K7 (CUDA tensors; it raises unless the
    inputs are f32 and contiguous) or the plain versions (CPU tensors, or
    the card with the kernels switched off). Saves the inputs and align,
    no tanh."""

    @staticmethod
    def forward(ctx, q, keys, f, v, vals, enc_len, temperature: float,
                use_kernel: bool):
        run = loc_att_fwd_fused if use_kernel else loc_att_fwd_plain
        out, align = run(q, keys, f, v, vals, enc_len, temperature)
        ctx.save_for_backward(q, keys, f, v, vals, enc_len, align)
        ctx.temperature, ctx.use_kernel = temperature, use_kernel
        return out, align

    @staticmethod
    def backward(ctx, dctx, dalign):
        q, keys, f, v, vals, enc_len, align = ctx.saved_tensors
        run = loc_att_bwd_fused if ctx.use_kernel else loc_att_bwd_plain
        dq, dtarg, dvals, dv = run(q, keys, f, v, vals, enc_len, align,
                                   dctx.contiguous(), dalign.contiguous(),
                                   ctx.temperature)
        return dq, dtarg, dtarg, dv, dvals, None, None, None
