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
On the H100 both kernels are bound by bytes, and held back by the latency
of each block's chain of loads and cluster barriers (see the CUDA source).
Each runs one cluster of ``pick_clusters`` blocks per utterance, the frames
that can carry weight split into contiguous slices, one per block;
``loc_att_fwd_split`` and ``loc_att_bwd_split`` spell out that arithmetic
(the per-slice sums, and their combine in rank order). Rows are read four
elements at a time where d and vdim are multiples of 4 and the rows are so
aligned, else by the scalar variant of the same kernels. The TPU kernel's
8-row blocking is a TPU pipeline device and is not carried over.

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
from typing import Callable, Dict, Optional, Tuple

import torch

from . import build

NEG_INF = -1e30
MAX_CLUSTER = 16    # blocks per cluster (the H100's non-portable size)
SLICE_FRAMES = 16   # frames per block at least, where T allows
# blocks per SM that a launch aims at: each block waits on memory and on
# its cluster's barriers more than it computes, and on the H100 every
# kernel of K7 ran fastest at about 1.5 (192 blocks at B=32, 256 at B=128;
# chip_smoke.py's k7 sweep over cluster sizes)
FILL = 1.5
# kernel variants, as the CUDA source numbers them: bit 0 the backward,
# bit 1 bf16 inputs, bit 2 the scalar variant (rows read one element at a
# time)
BWD, BF16_IN, SCALAR = 1, 2, 4
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "loc_att_train_max_clusters": (_I, [_I] * 5 + [ctypes.POINTER(_I)]),
    "loc_att_fwd_launch": (_I, [_P] * 9 + [_I] * 6 + [_F, _P]),
    "loc_att_bwd_launch": (_I, [_P] * 16 + [_I] * 6 + [_F, _P]),
    "loc_att_fwd_bf16_launch": (_I, [_P] * 9 + [_I] * 6 + [_F, _P]),
    "loc_att_bwd_bf16_launch": (_I, [_P] * 16 + [_I] * 6 + [_F, _P]),
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


def _cuts(n_len: int, T: int, C: int):
    """The frames whose alignment can be non-zero, [0, nw) (those below the
    length; all T for a zero-length row), cut into C slices of ceil(nw /
    C): the valid frame count n and the slices' (start, end), empty past
    nw."""
    n = min(max(n_len, 0), T)
    nw = n if n > 0 else T
    ts = -(-nw // C)
    return n, [(min(nw, r * ts), min(nw, r * ts + ts)) for r in range(C)]


def loc_att_fwd_split(q: torch.Tensor, keys: torch.Tensor, f: torch.Tensor,
                      v: torch.Tensor, vals: torch.Tensor,
                      enc_len: torch.Tensor, temperature: float, C: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's arithmetic in clusters of C blocks, spelled out
    (f32 or bf16 inputs, as ``loc_att_fwd_plain``): per row, each slice's
    energies (-1e30 at or past the length) and its max m_r; M = max m_r;
    s_r = sum exp(e - M) over the slice, S = the s_r summed in rank order;
    align = exp(e - M) / S on the slices, 0 past them; each slice's
    context sum as(align_t) vals_t from that final align; ctx = the
    slices' contexts summed in rank order. A slice without a frame gives
    m_r = -FLT_MAX, s_r = 0 and a zero context."""
    B, T, _ = keys.shape
    lowest = torch.finfo(torch.float32).min
    f32 = dict(dtype=torch.float32, device=q.device)
    energy = (_tanh_chain(q, keys, f) @ v.float()) * (1.0 / temperature)
    ctx = torch.zeros(B, vals.shape[-1], **f32)
    align = torch.zeros(B, T, **f32)
    for b in range(B):
        n, cuts = _cuts(int(enc_len[b]), T, C)
        e = energy[b].clone()
        e[n:] = NEG_INF
        M = torch.full((), lowest, **f32)
        for lo, hi in cuts:
            if hi > lo:
                M = torch.maximum(M, e[lo:hi].max())
        p = [torch.exp(e[lo:hi] - M) for lo, hi in cuts]
        S = torch.zeros((), **f32)
        for p_r in p:
            S = S + p_r.sum()
        for (lo, hi), p_r in zip(cuts, p):
            align[b, lo:hi] = p_r / S
            ctx[b] += _as(align[b, lo:hi], vals.dtype) @ vals[b, lo:hi].float()
    return ctx, align


def loc_att_bwd_split(q: torch.Tensor, keys: torch.Tensor, f: torch.Tensor,
                      v: torch.Tensor, vals: torch.Tensor,
                      enc_len: torch.Tensor, align: torch.Tensor,
                      dctx: torch.Tensor, dalign: torch.Tensor,
                      temperature: float, C: int):
    """The backward kernel's arithmetic in clusters of C blocks, spelled
    out (as ``loc_att_bwd_plain``: f32 sums, results in the inputs' dtype):
    per row, dal = dalign + vals . as(dctx) on each slice; its partial
    sum dal . align, summed in rank order into s; dener = align (dal - s)
    / tau on the slices (0 past them); dtarg = dener v (1 - th^2) and
    dvals = align dctx on the slices, 0 past them; per slice the dq
    partial sum dtarg and the dv partial sum as(dener) th, each summed over
    the slices in rank order (dq rounded once); dv = the rows' dv summed
    in order of b."""
    B, T, d = keys.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    th = _tanh_chain(q, keys, f)
    dq = torch.zeros(B, d, **f32)
    dtarg = torch.zeros(B, T, d, **f32)
    dvals = torch.zeros(B, T, vals.shape[-1], **f32)
    dv = torch.zeros(d, **f32)
    dc = _as(dctx, vals.dtype)
    for b in range(B):
        _, cuts = _cuts(int(enc_len[b]), T, C)
        dal = [dalign[b, lo:hi] + vals[b, lo:hi].float() @ dc[b]
               for lo, hi in cuts]
        s = torch.zeros((), **f32)
        for (lo, hi), dal_r in zip(cuts, dal):
            s = s + (dal_r * align[b, lo:hi]).sum()
        dv_b = torch.zeros(d, **f32)
        for (lo, hi), dal_r in zip(cuts, dal):
            den = align[b, lo:hi] * (dal_r - s) * (1.0 / temperature)
            th_r = th[b, lo:hi]
            dtarg[b, lo:hi] = den[:, None] * v.float() * (1.0 - th_r * th_r)
            dvals[b, lo:hi] = align[b, lo:hi, None] * dctx[b]
            dq[b] += dtarg[b, lo:hi].sum(0)
            dv_b += _as(den, keys.dtype) @ th_r
        dv += dv_b
    return (dq.to(q.dtype), dtarg.to(keys.dtype), dvals.to(vals.dtype),
            dv.to(v.dtype))


def clusters(T: int) -> int:
    """Blocks per utterance at most, for T frames: T / 16 rounded up, at
    most 16, lowered until no slice of ceil(T / C) frames is empty."""
    C = max(1, min(MAX_CLUSTER, -(-T // SLICE_FRAMES)))
    while C > 1 and (C - 1) * -(-T // C) >= T:
        C -= 1
    return C


_resident: Dict[tuple, int] = {}
_picked: Dict[tuple, int] = {}


def pick_clusters(query: Callable, kind: int, B: int, T: int, d: int,
                  vdim: int, n_sm: Optional[int] = None) -> int:
    """Blocks per utterance for kernel ``kind`` at batch B: of the C <=
    clusters(T) whose clusters take the fewest waves, ceil(B / R) (R:
    clusters resident at once, from the library's
    ``loc_att_train_max_clusters``), the one whose B C blocks come nearest
    FILL blocks per SM of the card's n_sm, the larger C on a tie. Cached
    per shape, kind and device (the step launches K7 96 times per training
    step)."""
    dev = torch.cuda.current_device() if torch.cuda.is_available() else -1
    shape = (query.__name__, kind, B, T, d, vdim, dev)
    if shape in _picked:
        return _picked[shape]
    if n_sm is None:
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    best = None
    for C in range(clusters(T), 0, -1):
        key = (query.__name__, kind, T, d, vdim, C, dev)
        if key not in _resident:
            out = ctypes.c_int(0)
            build.check(query(kind, T, d, vdim, C, ctypes.byref(out)),
                        "K7 occupancy query")
            _resident[key] = out.value
        if _resident[key] < 1:
            continue
        cost = (-(-B // _resident[key]), abs(B * C / n_sm - FILL))
        if best is None or cost < best[0]:
            best = (cost, C)
    if best is None:
        raise ValueError(f"K7: no cluster fits T={T}, d={d}, vdim={vdim}")
    _picked[shape] = best[1]
    return best[1]


def _kind(backward: bool, dtype, d: int, vdim: int, *rows) -> int:
    """The kernel variant for these inputs: the 4-element one where d and
    vdim are multiples of 4 and every row tensor starts on 4 elements."""
    vec = d % 4 == 0 and vdim % 4 == 0 and all(
        t.data_ptr() % (4 * t.element_size()) == 0 for t in rows)
    return (BWD if backward else 0) | (BF16_IN if dtype == BF16 else 0) | (
        0 if vec else SCALAR)


def _ptr(t: Optional[torch.Tensor], n: int) -> Optional[int]:
    """The device address of an optional output of n int32, None (NULL)
    where absent."""
    if t is None:
        return None
    if (t.dtype != torch.int32 or not t.is_contiguous() or not t.is_cuda
            or t.numel() < n):
        raise ValueError(f"sm_ids must be a contiguous int32 CUDA tensor of "
                         f"at least {n} elements")
    return t.data_ptr()


_tickets: Dict[tuple, torch.Tensor] = {}


def _ticket(device, stream: int) -> torch.Tensor:
    """The backward's counter of finished clusters on ``stream``: zeroed
    once, left at 0 by every launch."""
    key = (device, stream)
    if key not in _tickets:
        _tickets[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _tickets[key]


def _check(what, dtype, q, keys, f, v, vals, enc_len):
    B, T, d = keys.shape
    build.check_inputs(what, q, ("q", q, (B, d), dtype),
                       ("keys", keys, (B, T, d), dtype),
                       ("f", f, (B, T, d), dtype), ("v", v, (d,), dtype),
                       ("vals", vals, (B, T, vals.shape[-1]), dtype),
                       ("enc_len", enc_len, (B,), torch.int32))
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {q.device}")


def loc_att_fwd_tc(q: torch.Tensor, keys: torch.Tensor, f: torch.Tensor,
                   v: torch.Tensor, vals: torch.Tensor, enc_len: torch.Tensor,
                   temperature: float, clusters: Optional[int] = None,
                   sm_ids: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's launch on checked CUDA tensors (f32, or bf16
    for the bf16 instantiation) -> (ctx, align), in clusters of
    ``clusters`` blocks per utterance (default: ``pick_clusters``').
    ``sm_ids``, an int32 tensor of B * clusters, receives the SM each
    block ran on. Counts nothing; the wrappers do."""
    B, T, d = keys.shape
    vdim = vals.shape[-1]
    lib = build.load("loc_att_train", _SIGNATURES)
    kind = _kind(False, q.dtype, d, vdim, q, keys, f, v, vals)
    if clusters is None:
        clusters = pick_clusters(lib.loc_att_train_max_clusters, kind, B, T,
                                 d, vdim)
    ctx = torch.empty((B, vdim), dtype=torch.float32, device=q.device)
    align = torch.empty((B, T), dtype=torch.float32, device=q.device)
    launch = (lib.loc_att_fwd_bf16_launch if q.dtype == BF16
              else lib.loc_att_fwd_launch)
    rc = launch(q.data_ptr(), keys.data_ptr(), f.data_ptr(), v.data_ptr(),
                vals.data_ptr(), enc_len.data_ptr(), ctx.data_ptr(),
                align.data_ptr(), _ptr(sm_ids, B * clusters), B, T, d, vdim,
                clusters, int(not kind & SCALAR), 1.0 / temperature,
                torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "K7 forward launch")
    return ctx, align


def loc_att_bwd_tc(q: torch.Tensor, keys: torch.Tensor, f: torch.Tensor,
                   v: torch.Tensor, vals: torch.Tensor, enc_len: torch.Tensor,
                   align: torch.Tensor, dctx: torch.Tensor,
                   dalign: torch.Tensor, temperature: float,
                   clusters: Optional[int] = None,
                   sm_ids: Optional[torch.Tensor] = None):
    """The backward kernel's launch on checked CUDA tensors -> (dq, dtarg,
    dvals, dv) in the inputs' dtype, in clusters of ``clusters`` blocks per
    utterance (default: ``pick_clusters``'), ``sm_ids`` as the forward's.
    Counts nothing."""
    B, T, d = keys.shape
    vdim = vals.shape[-1]
    lib = build.load("loc_att_train", _SIGNATURES)
    kind = _kind(True, q.dtype, d, vdim, q, keys, f, v, vals)
    if clusters is None:
        clusters = pick_clusters(lib.loc_att_train_max_clusters, kind, B, T,
                                 d, vdim)
    empty = lambda *shape: torch.empty(shape, dtype=q.dtype, device=q.device)
    dq, dtarg, dvals, dv = empty(B, d), empty(B, T, d), empty(B, T, vdim), \
        empty(d)
    dvb = torch.empty((B, d), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    launch = (lib.loc_att_bwd_bf16_launch if q.dtype == BF16
              else lib.loc_att_bwd_launch)
    rc = launch(q.data_ptr(), keys.data_ptr(), f.data_ptr(), v.data_ptr(),
                vals.data_ptr(), enc_len.data_ptr(), align.data_ptr(),
                dctx.data_ptr(), dalign.data_ptr(), dq.data_ptr(),
                dtarg.data_ptr(), dvals.data_ptr(), dv.data_ptr(),
                dvb.data_ptr(), _ticket(q.device, stream).data_ptr(),
                _ptr(sm_ids, B * clusters), B, T, d, vdim, clusters,
                int(not kind & SCALAR), 1.0 / temperature, stream)
    build.check(rc, "K7 backward launch")
    return dq, dtarg, dvals, dv


def _fwd(wrapper, dtype, q, keys, f, v, vals, enc_len, temperature):
    """The forward of ``dtype`` inputs: the plain version on the CPU, else
    the kernel, counted on ``wrapper``."""
    _check(wrapper.__name__, dtype, q, keys, f, v, vals, enc_len)
    if q.device.type == "cpu":
        return loc_att_fwd_plain(q, keys, f, v, vals, enc_len, temperature)
    out = loc_att_fwd_tc(q, keys, f, v, vals, enc_len, temperature)
    wrapper.launches += 1
    return out


def _bwd(wrapper, dtype, q, keys, f, v, vals, enc_len, align, dctx, dalign,
         temperature):
    """The backward of ``dtype`` inputs (f32 align, dctx and dalign): the
    plain version on the CPU, else the kernel, counted on ``wrapper``."""
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
    out = loc_att_bwd_tc(q, keys, f, v, vals, enc_len, align, dctx, dalign,
                         temperature)
    wrapper.launches += 1
    return out


def loc_att_fwd_fused(q: torch.Tensor, keys: torch.Tensor, f: torch.Tensor,
                      v: torch.Tensor, vals: torch.Tensor,
                      enc_len: torch.Tensor, temperature: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7 forward. CPU tensors take the plain version; CUDA tensors launch
    the kernel. Either way, inputs of another dtype or layout raise."""
    return _fwd(loc_att_fwd_fused, torch.float32, q, keys, f, v, vals,
                enc_len, temperature)


loc_att_fwd_fused.launches = 0


def loc_att_bwd_fused(q: torch.Tensor, keys: torch.Tensor, f: torch.Tensor,
                      v: torch.Tensor, vals: torch.Tensor,
                      enc_len: torch.Tensor, align: torch.Tensor,
                      dctx: torch.Tensor, dalign: torch.Tensor,
                      temperature: float):
    """K7 backward -> (dq, dtarg, dvals, dv). CPU tensors take the plain
    version; CUDA tensors launch the kernel (one launch: the last cluster
    to finish sums dv over the batch in order). Either way, inputs of
    another dtype or layout raise."""
    return _bwd(loc_att_bwd_fused, torch.float32, q, keys, f, v, vals,
                enc_len, align, dctx, dalign, temperature)


loc_att_bwd_fused.launches = 0


def loc_att_fwd_bf16(q: torch.Tensor, keys: torch.Tensor, f: torch.Tensor,
                     v: torch.Tensor, vals: torch.Tensor,
                     enc_len: torch.Tensor, temperature: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7 forward on bf16 q, keys, f, v and vals (amp training) -> f32 ctx
    and align. CPU tensors take the plain version; CUDA tensors launch the
    kernel. Either way, inputs of another dtype or layout raise."""
    return _fwd(loc_att_fwd_bf16, BF16, q, keys, f, v, vals, enc_len,
                temperature)


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
    return _bwd(loc_att_bwd_bf16, BF16, q, keys, f, v, vals, enc_len, align,
                dctx, dalign, temperature)


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
