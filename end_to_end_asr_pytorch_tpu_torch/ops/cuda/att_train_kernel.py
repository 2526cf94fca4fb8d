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

Amp training hands the TPU kernel bf16 q, keys, f, v and vals; its
gradients come back in those dtypes. Here ``loc_att_fwd_bf16`` and
``loc_att_bwd_bf16`` launch the bf16 instantiation of the same kernels, and
``LocAttTrain`` picks the variant by the inputs' dtype. The plain versions
take either dtype and round where the TPU kernel rounds on bf16 inputs in
interpret mode, the reference the port is held to: q + keys and then + f
each rounded to bf16, tanh of that kept in f32 (XLA carries the bf16 tanh
in f32 there), align rounded to bf16 for the context, dctx for dal and
dener for dv; ctx and align f32; dq (the f32 sum of the unrounded dtarg),
dtarg, dvals (align * dctx in f32) and dv rounded to bf16 once.
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
    "loc_att_fwd_bf16_launch": (_I, [_P] * 8 + [_I] * 4 + [_F, _P]),
    "loc_att_bwd_bf16_launch": (_I, [_P] * 14 + [_I] * 4 + [_F, _P]),
}
BF16 = torch.bfloat16


def _tanh_chain(q, keys, f):
    """(B, T, d) f32; bf16 inputs add in bf16 (two roundings) and take the
    tanh of that in f32."""
    return torch.tanh((q[:, None, :] + keys + f).float())


def _as(x, dtype):
    """x as a product's operand of ``dtype`` sees it: rounded to bf16 and
    widened for bf16, x itself for f32."""
    return x.to(dtype).float()


def loc_att_fwd_plain(q: torch.Tensor, keys: torch.Tensor, f: torch.Tensor,
                      v: torch.Tensor, vals: torch.Tensor,
                      enc_len: torch.Tensor, temperature: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel (f32 or bf16 inputs) -> (ctx
    (B, vdim), align (B, T)), both f32. Differentiable, so autograd through
    it checks the hand VJP."""
    T = keys.shape[1]
    energy = (_tanh_chain(q, keys, f) @ v.float()) * (1.0 / temperature)
    mask = torch.arange(T, device=q.device)[None, :] < enc_len[:, None]
    energy = torch.where(mask, energy, torch.full((), NEG_INF, device=q.device))
    align = torch.softmax(energy, dim=-1)
    return (_as(align, vals.dtype)[:, None, :] @ vals.float())[:, 0], align


def loc_att_bwd_plain(q: torch.Tensor, keys: torch.Tensor, f: torch.Tensor,
                      v: torch.Tensor, vals: torch.Tensor,
                      enc_len: torch.Tensor, align: torch.Tensor,
                      dctx: torch.Tensor, dalign: torch.Tensor,
                      temperature: float):
    """Plain version of the backward kernel, the TPU kernel's formulas ->
    (dq (B, d), dtarg (B, T, d), dvals (B, T, vdim), dv (d,)) in the
    inputs' dtype, computed in f32."""
    th = _tanh_chain(q, keys, f)
    dal = dalign + (vals.float() @ _as(dctx, vals.dtype)[:, :, None])[..., 0]
    s = torch.sum(dal * align, dim=1, keepdim=True)
    dener = align * (dal - s) * (1.0 / temperature)          # (B, T)
    dtarg = dener[:, :, None] * v.float() * (1.0 - th * th)
    dvals = align[:, :, None] * dctx[:, None, :]
    dv = torch.einsum("bt,btd->d", _as(dener, keys.dtype), th)
    return (dtarg.sum(dim=1).to(q.dtype), dtarg.to(keys.dtype),
            dvals.to(vals.dtype), dv.to(v.dtype))


def _check(what, dtype, q, keys, f, v, vals, enc_len):
    B, T, d = keys.shape
    build.check_inputs(what, q, ("q", q, (B, d), dtype),
                       ("keys", keys, (B, T, d), dtype),
                       ("f", f, (B, T, d), dtype), ("v", v, (d,), dtype),
                       ("vals", vals, (B, T, vals.shape[-1]), dtype),
                       ("enc_len", enc_len, (B,), torch.int32))
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {q.device}")


def _fwd(wrapper, launcher, dtype, q, keys, f, v, vals, enc_len,
         temperature):
    """The forward of ``dtype`` inputs: the plain version on the CPU, else
    the kernel ``launcher``, counted on ``wrapper``."""
    _check(wrapper.__name__, dtype, q, keys, f, v, vals, enc_len)
    if q.device.type == "cpu":
        return loc_att_fwd_plain(q, keys, f, v, vals, enc_len, temperature)
    B, T, d = keys.shape
    vdim = vals.shape[-1]
    lib = build.load("loc_att_train", _SIGNATURES)
    ctx = torch.empty((B, vdim), dtype=torch.float32, device=q.device)
    align = torch.empty((B, T), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = getattr(lib, launcher)(q.data_ptr(), keys.data_ptr(), f.data_ptr(),
                                v.data_ptr(), vals.data_ptr(),
                                enc_len.data_ptr(), ctx.data_ptr(),
                                align.data_ptr(), B, T, d, vdim,
                                1.0 / temperature, stream)
    build.check(rc, f"{wrapper.__name__} launch")
    wrapper.launches += 1
    return ctx, align


def _bwd(wrapper, launcher, dtype, q, keys, f, v, vals, enc_len, align,
         dctx, dalign, temperature):
    """The backward of ``dtype`` inputs (f32 align, dctx and dalign): the
    plain version on the CPU, else the kernel ``launcher``, counted on
    ``wrapper``."""
    what = wrapper.__name__
    _check(what, dtype, q, keys, f, v, vals, enc_len)
    B, T, d = keys.shape
    vdim = vals.shape[-1]
    build.check_inputs(what, q, ("align", align, (B, T), torch.float32),
                       ("dctx", dctx, (B, vdim), torch.float32),
                       ("dalign", dalign, (B, T), torch.float32))
    if q.device.type == "cpu":
        return loc_att_bwd_plain(q, keys, f, v, vals, enc_len, align, dctx,
                                 dalign, temperature)
    lib = build.load("loc_att_train", _SIGNATURES)
    empty = lambda *shape: torch.empty(shape, dtype=dtype, device=q.device)
    dq, dtarg, dvals = empty(B, d), empty(B, T, d), empty(B, T, vdim)
    dv = empty(d)
    dv_part = torch.empty((B, d), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = getattr(lib, launcher)(q.data_ptr(), keys.data_ptr(), f.data_ptr(),
                                v.data_ptr(), vals.data_ptr(),
                                enc_len.data_ptr(), align.data_ptr(),
                                dctx.data_ptr(), dalign.data_ptr(),
                                dq.data_ptr(), dtarg.data_ptr(),
                                dvals.data_ptr(), dv_part.data_ptr(),
                                dv.data_ptr(), B, T, d, vdim,
                                1.0 / temperature, stream)
    build.check(rc, f"{what} launch")
    wrapper.launches += 1
    return dq, dtarg, dvals, dv


def loc_att_fwd_fused(q: torch.Tensor, keys: torch.Tensor, f: torch.Tensor,
                      v: torch.Tensor, vals: torch.Tensor,
                      enc_len: torch.Tensor, temperature: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7 forward. CPU tensors take the plain version; CUDA tensors launch
    the kernel. Either way, inputs of another dtype or layout raise."""
    return _fwd(loc_att_fwd_fused, "loc_att_fwd_launch", torch.float32, q,
                keys, f, v, vals, enc_len, temperature)


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
    return _bwd(loc_att_bwd_fused, "loc_att_bwd_launch", torch.float32, q,
                keys, f, v, vals, enc_len, align, dctx, dalign, temperature)


loc_att_bwd_fused.launches = 0


def loc_att_fwd_bf16(q: torch.Tensor, keys: torch.Tensor, f: torch.Tensor,
                     v: torch.Tensor, vals: torch.Tensor,
                     enc_len: torch.Tensor, temperature: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7 forward on bf16 q, keys, f, v and vals (amp training) -> f32 ctx
    and align. CPU tensors take the plain version; CUDA tensors launch the
    kernel. Either way, inputs of another dtype or layout raise."""
    return _fwd(loc_att_fwd_bf16, "loc_att_fwd_bf16_launch", BF16, q, keys,
                f, v, vals, enc_len, temperature)


loc_att_fwd_bf16.launches = 0


def loc_att_bwd_bf16(q: torch.Tensor, keys: torch.Tensor, f: torch.Tensor,
                     v: torch.Tensor, vals: torch.Tensor,
                     enc_len: torch.Tensor, align: torch.Tensor,
                     dctx: torch.Tensor, dalign: torch.Tensor,
                     temperature: float):
    """K7 backward on bf16 inputs and f32 align, dctx and dalign -> bf16
    (dq, dtarg, dvals, dv). CPU tensors take the plain version; CUDA
    tensors launch the kernel. Either way, inputs of another dtype or
    layout raise."""
    return _bwd(loc_att_bwd_bf16, "loc_att_bwd_bf16_launch", BF16, q, keys,
                f, v, vals, enc_len, align, dctx, dalign, temperature)


loc_att_bwd_bf16.launches = 0


class LocAttTrain(torch.autograd.Function):
    """(ctx, align) of the training attention step with the hand-written
    backward. ``use_kernel`` picks K7 (CUDA tensors: the f32 kernels, or
    the bf16 ones for bf16 inputs; they raise unless the inputs are all of
    one of those dtypes and contiguous) or the plain versions (CPU tensors,
    or the card with the kernels switched off). Saves the inputs and align,
    no tanh."""

    @staticmethod
    def forward(ctx, q, keys, f, v, vals, enc_len, temperature: float,
                use_kernel: bool):
        bf16 = q.dtype == BF16
        run = (loc_att_fwd_bf16 if bf16 else loc_att_fwd_fused) \
            if use_kernel else loc_att_fwd_plain
        out, align = run(q, keys, f, v, vals, enc_len, temperature)
        ctx.save_for_backward(q, keys, f, v, vals, enc_len, align)
        ctx.temperature, ctx.use_kernel = temperature, use_kernel
        return out, align

    @staticmethod
    def backward(ctx, dctx, dalign):
        q, keys, f, v, vals, enc_len, align = ctx.saved_tensors
        bf16 = q.dtype == BF16
        run = (loc_att_bwd_bf16 if bf16 else loc_att_bwd_fused) \
            if ctx.use_kernel else loc_att_bwd_plain
        dq, dtarg, dvals, dv = run(q, keys, f, v, vals, enc_len, align,
                                   dctx.contiguous(), dalign.contiguous(),
                                   ctx.temperature)
        return dq, dtarg, dtarg, dv, dvals, None, None, None
