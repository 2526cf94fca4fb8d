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
CUDA source). It runs one cluster of ``pick_slices`` blocks per utterance,
each block a slice of the frames for all K hypotheses; the slices'
softmax partials are combined as ``loc_attention_split`` spells out.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch

from . import build

NEG_INF = -1e30
MAX_SLICES = 8      # blocks per cluster (the portable size)
SLICE_FRAMES = 16   # frames per block at least, where T allows
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "loc_att_max_clusters": (_I, [_I] * 6 + [ctypes.POINTER(_I)]),
    "loc_att_launch": (_I, [_P] * 9 + [_I] * 7 + [ctypes.c_float, _P]),
}


def slices(T: int) -> int:
    """Blocks per utterance (the kernel's cluster) for T frames: T / 16
    rounded up, at most 8, lowered until no slice of ceil(T / C) frames is
    empty."""
    C = max(1, min(MAX_SLICES, -(-T // SLICE_FRAMES)))
    while C > 1 and (C - 1) * -(-T // C) >= T:
        C -= 1
    return C


_resident: Dict[tuple, int] = {}
_picked: Dict[tuple, int] = {}


def pick_slices(query: Callable, B: int, K: int, T: int, d: int, F: int,
                vdim: int) -> int:
    """Blocks per utterance for a launch at batch B: the C <= slices(T)
    that minimises the card's waves of clusters times the frames of a
    block, ceil(B / resident(C)) ceil(T / C), the larger C on a tie.
    ``query`` is the library's ``loc_att_max_clusters`` (clusters that can
    be resident at once). On an H100 at B=32, T=176: 30 clusters of 8 are
    resident but 32 of 7, so 7 runs in one wave. Cached per shape (the
    beam loop asks once per step)."""
    dev = torch.cuda.current_device() if torch.cuda.is_available() else -1
    shape = (query.__name__, B, K, T, d, F, vdim, dev)
    if shape in _picked:
        return _picked[shape]
    best = None
    for C in range(slices(T), 0, -1):
        key = (query.__name__, K, T, d, F, vdim, C, dev)
        if key not in _resident:
            out = ctypes.c_int(0)
            build.check(query(K, T, d, F, vdim, C, ctypes.byref(out)),
                        "loc_attention_fused occupancy query")
            _resident[key] = out.value
        if _resident[key] < 1:
            continue
        cost = -(-B // _resident[key]) * -(-T // C)
        if best is None or cost < best[0]:
            best = (cost, C)
    if best is None:
        raise ValueError(f"loc_attention_fused: no cluster fits K={K}, "
                         f"T={T}, d={d}, F={F}, vdim={vdim}")
    _picked[shape] = best[1]
    return best[1]


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


def loc_attention_split(qb: torch.Tensor, keys: torch.Tensor,
                        fsm: torch.Tensor, w_f: torch.Tensor,
                        v: torch.Tensor, vals: torch.Tensor,
                        enc_len: torch.Tensor, temperature: float, C: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic, spelled out: per row, the frames whose
    alignment can be non-zero (those below enc_len; every frame of a
    zero-length row), nw of them, cut into C slices of ceil(nw / C); each
    slice's energies (-1e30 at or past enc_len), its max m_r, its sum s_r
    = sum exp(e - m_r) and its partial context sum exp(e - m_r) vals; a
    slice without a frame gives m_r = -FLT_MAX, s_r = 0 and a zero
    context. Then M = max m_r, S = sum s_r exp(m_r - M), ctx = sum
    exp(m_r - M) ctx_r / S, and align = exp(e - M) / S on the nw frames,
    0 past them."""
    B, K, _ = qb.shape
    T = keys.shape[1]
    lowest = torch.finfo(torch.float32).min
    f = fsm @ w_f
    th = torch.tanh(qb[:, :, None, :] + keys[:, None] + f)
    energy = (th @ v) * (1.0 / temperature)                 # (B, K, T)
    ctx = torch.zeros(B, K, vals.shape[-1], dtype=qb.dtype)
    align = torch.zeros(B, K, T, dtype=qb.dtype)
    for b in range(B):
        n = min(max(int(enc_len[b]), 0), T)
        nw = n if n > 0 else T
        e = energy[b].clone()
        e[:, n:] = NEG_INF
        ts = -(-nw // C)
        m, s, part = [], [], []
        for r in range(C):
            lo, hi = min(nw, r * ts), min(nw, r * ts + ts)
            if lo == hi:
                m.append(torch.full((K,), lowest))
                s.append(torch.zeros(K))
                part.append(torch.zeros_like(ctx[b]))
                continue
            m_r = e[:, lo:hi].amax(-1)
            p = torch.exp(e[:, lo:hi] - m_r[:, None])
            m.append(m_r)
            s.append(p.sum(-1))
            part.append(p @ vals[b, lo:hi])
        m, s, part = torch.stack(m), torch.stack(s), torch.stack(part)
        M = m.amax(0)                                       # (K,)
        wgt = torch.exp(m - M)
        S = (s * wgt).sum(0)
        ctx[b] = (part * wgt[..., None]).sum(0) / S[:, None]
        align[b, :, :nw] = torch.exp(e[:, :nw] - M[:, None]) / S[:, None]
    return ctx, align


def loc_attention_fused(qb: torch.Tensor, keys: torch.Tensor,
                        fsm: torch.Tensor, w_f: torch.Tensor,
                        v: torch.Tensor, vals: torch.Tensor,
                        enc_len: torch.Tensor, temperature: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5, every float input f32 and contiguous, enc_len int32. CPU tensors
    take the plain version; CUDA tensors launch the kernel, one cluster of
    ``pick_slices`` blocks per utterance. Either way, inputs of another
    dtype or layout raise."""
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
    out = loc_att_tc(qb, keys, fsm, w_f, v, vals, enc_len, temperature)
    loc_attention_fused.launches += 1
    return out


loc_attention_fused.launches = 0


def loc_att_tc(qb: torch.Tensor, keys: torch.Tensor, fsm: torch.Tensor,
               w_f: torch.Tensor, v: torch.Tensor, vals: torch.Tensor,
               enc_len: torch.Tensor, temperature: float,
               slices: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's launch on checked CUDA tensors -> (ctx, align), in clusters of
    ``slices`` blocks per utterance (default: ``pick_slices``'). Counts
    nothing; ``loc_attention_fused`` does."""
    B, K, d = qb.shape
    T, F, vdim = keys.shape[1], fsm.shape[-1], vals.shape[-1]
    lib = build.load("loc_att", _SIGNATURES)
    if slices is None:
        slices = pick_slices(lib.loc_att_max_clusters, B, K, T, d, F, vdim)
    ctx = torch.empty((B, K, vdim), dtype=torch.float32, device=qb.device)
    align = torch.empty((B, K, T), dtype=torch.float32, device=qb.device)
    stream = torch.cuda.current_stream(qb.device).cuda_stream
    rc = lib.loc_att_launch(qb.data_ptr(), keys.data_ptr(), fsm.data_ptr(),
                            w_f.data_ptr(), v.data_ptr(), vals.data_ptr(),
                            enc_len.data_ptr(), ctx.data_ptr(),
                            align.data_ptr(), B, K, T, d, F, vdim, slices,
                            1.0 / temperature, stream)
    build.check(rc, "loc_attention_fused launch")
    return ctx, align
