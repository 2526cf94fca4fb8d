"""K8: the tail of one beam step, fused — wrapper for ``csrc/beam_step.cu``
and its plain PyTorch version.

Replaces ``end_to_end_asr_pytorch_tpu/ops/pallas/beam_step_kernel.py``
``fused_score_select``: everything ``decode/beam.py``'s step does after the
model and LM calls when CTC scores the full vocabulary, in f32 — the
log-softmax of both heads, the eos scores merged into the finished set, the
continuation scores with the CTC prefix psi, the joint top-K over K x V and
the winners' CTC states. The contract is the TPU kernel's without its
layout (the 128-lane vocabulary padding, the padded T and the (B, V, T)
transpose are Mosaic's): it reads what the beam carries,

  logits, lm_logits (B, K, V) f32 (lm_logits None: no LM); base, fin_norm
  (B, K) f32; valid (B, K) bool; last, fin_meta (B, K) int64; r (B, K, T, 2)
  f32 (non-blank / blank); ctc_lp (B, T, V) f32, padded frames blank-only;
  min_len, max_len (B,) int32; the step t and the weights aw, cw, lw,

and returns the TPU kernel's eight outputs (its r_nb / r_b stacked as the
carry's r) plus ``psi_pick``, the winners' psi, which the beam's exact early
exit reads: ``BeamStepOut``. Every top-K is a stable descending sort (ties
to the lowest index), so dead slots gather the states they gather in the
plain beam. On the H100 the kernel is bound by its bytes (see the CUDA
source): it runs a cluster of C blocks per utterance, each a slice of the
vocabulary (``clusters``), and takes the beam's loop-invariant probs =
exp(ctc_lp) beside ctc_lp. ``split_top_k`` and ``combined_log_norm`` spell
out how the slices' top-K candidates and row normalisers are combined.
``beam_step_plain`` is also the beam's step tail wherever the kernel is
not taken (amp, no CTC, ``fused_step: false``), so the beam holds one eager
copy of it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import build
from .. import ctc_prefix

NEG_INF = -1e30
MAX_K = 256  # the packed finished-set metadata: (step << 8) | slot
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "beam_step_launch": (_I, [_P] * 20 + [_I] * 6 + [_F] * 3 + [_I] * 3
                         + [_P]),
    "beam_step_max_clusters": (_I, [_I] * 4 + [ctypes.POINTER(_I)]),
}
MAX_CLUSTER = 16       # blocks per cluster (the H100's non-portable size)
SLICE = 320            # vocabulary columns per block of a cluster, at most


class BeamStepOut(NamedTuple):
    v_idx: torch.Tensor      # (B, K) int64 winner tokens
    k_idx: torch.Tensor      # (B, K) int64 winner parent slots
    new_valid: torch.Tensor  # (B, K) bool
    new_base: torch.Tensor   # (B, K) f32 carried score without cw * psi
    fin_norm: torch.Tensor   # (B, K) f32 merged finished scores
    fin_meta: torch.Tensor   # (B, K) int64 (step << 8) | slot
    r: Optional[torch.Tensor]  # (B, K, T, 2) f32 winners' CTC states
    psi_pick: torch.Tensor   # (B, K) f32 winners' psi


def top_k(x: torch.Tensor, k: int):
    """Top-k over the last axis with ``lax.top_k``'s tie order (lowest index
    first among equal values)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def gather_k(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, K, ...) gathered along the beam axis by idx (B, K)."""
    i = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand(
        idx.shape + x.shape[2:])
    return torch.gather(x, 1, i)


def logsumexp(x: torch.Tensor) -> torch.Tensor:
    """logsumexp over the last axis, kept, written as the JAX package's
    (max shift, a non-finite max taken as 0)."""
    m = torch.amax(x, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.log(torch.sum(torch.exp(x - m), dim=-1, keepdim=True)) + m


def beam_step_plain(t: int, logits: torch.Tensor,
                    lm_logits: Optional[torch.Tensor], base: torch.Tensor,
                    valid: torch.Tensor, last: torch.Tensor,
                    fin_norm: torch.Tensor, fin_meta: torch.Tensor,
                    r: Optional[torch.Tensor], ctc_lp: Optional[torch.Tensor],
                    min_len: torch.Tensor, max_len: torch.Tensor, *,
                    aw: float, cw: float, lw: float, eos: int, pad: int,
                    blank: int = 0, probs: Optional[torch.Tensor] = None,
                    blank_lp: Optional[torch.Tensor] = None,
                    psi_kernel: bool = False,
                    fold_lse: bool = False) -> BeamStepOut:
    """Plain version of the kernel, and the beam's step tail on every route
    the kernel does not take (``decode/beam.py``). Beyond the kernel's
    contract: ``ctc_lp`` and ``r`` None decode without CTC (psi 0, no
    state); ``probs`` = exp(ctc_lp) (bf16 under amp) and the clamped blank
    column ``blank_lp`` may be passed precomputed; ``psi_kernel`` sends the
    full-vocab psi to K6; ``fold_lse`` (amp) leaves both heads unnormalised
    and subtracts their weighted normalisers as one per-hypothesis shift."""
    B, K, V = logits.shape
    dev = logits.device
    if fold_lse:
        logp_att = logits
        shift = aw * logsumexp(logits)[..., 0]
    else:
        logp_att = F.log_softmax(logits, -1)
    if lm_logits is None:
        logp_lm = torch.zeros((B, K, V), device=dev)
    elif fold_lse:
        logp_lm = lm_logits
        shift = shift + lw * logsumexp(lm_logits)[..., 0]
    else:
        logp_lm = F.log_softmax(lm_logits, -1)

    # eos scores, merged into the finished set
    ctc_eos = (ctc_prefix.final_score(r) if ctc_lp is not None
               else torch.zeros((B, K), device=dev))
    tot_eos = (base + aw * logp_att[:, :, eos] + cw * ctc_eos
               + lw * logp_lm[:, :, eos])
    if fold_lse:
        tot_eos = tot_eos - shift
    eos_ok = valid & ((t + 1 >= min_len[:, None]) | (t + 1 >= max_len[:, None]))
    # mask after normalizing: NEG_INF/(t+1) would outrank the finished
    # set's NEG_INF placeholders
    norm_eos = torch.where(eos_ok, tot_eos / float(max(t + 1, 1)), NEG_INF)
    all_norm = torch.cat([fin_norm, norm_eos], dim=1)
    meta_new = ((t << 8) + torch.arange(K, device=dev)[None]).expand(B, K)
    all_meta = torch.cat([fin_meta, meta_new], dim=1)
    fin_norm_o, fin_idx = top_k(all_norm, K)
    fin_meta_o = torch.gather(all_meta, 1, fin_idx)

    # continuation scores with the full-vocab psi, then the joint top-K
    step_score = aw * logp_att + lw * logp_lm
    if fold_lse:
        step_score = step_score - shift[..., None]
    vocab_ids = torch.arange(V, device=dev)
    cont_keep = (vocab_ids != eos) & (vocab_ids != pad)
    masked = torch.where(cont_keep[None, None, :], step_score, NEG_INF)
    step_t = torch.full((B, K), t, device=dev)
    if ctc_lp is not None:
        psi, _ = ctc_prefix.score_candidates(
            ctc_lp, r, last, step_t, blank=blank, with_state=False,
            probs=torch.exp(ctc_lp) if probs is None else probs,
            psi_kernel=psi_kernel)
        tot = base[:, :, None] + masked + cw * psi
    else:
        tot = base[:, :, None] + masked
    alive = valid & (t < max_len[:, None])
    tot = torch.where(alive[..., None], tot, NEG_INF)
    top_tot, top_idx = top_k(tot.reshape(B, K * V), K)
    k_idx = top_idx // V
    v_idx = top_idx % V
    if ctc_lp is None:
        return BeamStepOut(v_idx, k_idx, top_tot > NEG_INF / 2, top_tot,
                           fin_norm_o, fin_meta_o, None,
                           torch.zeros((B, K), device=dev))
    psi_pick = torch.gather(psi.reshape(B, K * V), 1, top_idx)

    # the winners' CTC states
    if blank_lp is None:
        blank_lp = torch.clamp(ctc_lp[:, :, blank], min=ctc_prefix.CLIP)
    _, r_g = ctc_prefix.score_candidates(
        ctc_lp, gather_k(r, k_idx), gather_k(last, k_idx), step_t,
        blank=blank, cand_ids=v_idx[..., None], blank_lp=blank_lp)
    return BeamStepOut(v_idx, k_idx, top_tot > NEG_INF / 2,
                       top_tot - cw * psi_pick, fin_norm_o.contiguous(),
                       fin_meta_o, r_g[:, :, 0], psi_pick)


def split_top_k(scores: torch.Tensor, C: int, k: int):
    """The kernel's joint top-K, spelled out: scores (B, K, V) cut along V
    into slices of ceil(V / C) columns, each slice's k best over its
    (hypothesis, column) entries by (value desc, flat index k V + v asc),
    then the candidates ranked in the same order. Returns (values, flat
    indices), each (B, k)."""
    B, K, V = scores.shape
    vs = -(-V // C)
    vals, idx = [], []
    for lo in range(0, V, vs):
        part = scores[:, :, lo:lo + vs]
        w = part.shape[2]
        v, i = top_k(part.reshape(B, K * w), k)
        vals.append(v)
        idx.append((i // w) * V + lo + i % w)
    vals, idx = torch.cat(vals, 1), torch.cat(idx, 1)
    # rank by (value desc, flat index asc): order by index, then a stable
    # sort by value
    order = torch.argsort(idx, dim=1)
    vals, idx = torch.gather(vals, 1, order), torch.gather(idx, 1, order)
    v, pos = top_k(vals, k)
    return v, torch.gather(idx, 1, pos)


def combined_log_norm(x: torch.Tensor, C: int) -> torch.Tensor:
    """The kernel's log-softmax normaliser of each row of x (..., V), its
    slices combined: m_i, s_i = max, sum exp(x - m_i) of each of C slices
    of ceil(V / C) columns; M = max m_i, log S with S = sum s_i exp(m_i -
    M). Returns M + log S, the row's logsumexp (...,)."""
    V = x.shape[-1]
    vs = -(-V // C)
    parts = [x[..., lo:lo + vs] for lo in range(0, V, vs)]
    m = torch.stack([p.amax(-1) for p in parts], -1)
    s = torch.stack([torch.exp(p - p.amax(-1, keepdim=True)).sum(-1)
                     for p in parts], -1)
    M = m.amax(-1)
    return M + torch.log((s * torch.exp(m - M[..., None])).sum(-1))


def clusters(V: int) -> int:
    """Blocks per utterance for vocabulary V: one for V <= SLICE, else
    ceil(V / SLICE) up to 16, lowered until no slice of ceil(V / C)
    columns is empty."""
    C = max(1, min(MAX_CLUSTER, -(-V // SLICE)))
    while C > 1 and (C - 1) * -(-V // C) >= V:
        C -= 1
    return C


_resident = {}


def _max_clusters(lib, K: int, T: int, V: int, C: int, dev: int) -> int:
    key = (K, T, V, C, dev)
    if key not in _resident:
        out = ctypes.c_int(0)
        build.check(lib.beam_step_max_clusters(K, T, V, C, ctypes.byref(out)),
                    "beam_step_fused occupancy query")
        _resident[key] = out.value
    return _resident[key]


def beam_step_fused(t: int, logits: torch.Tensor,
                    lm_logits: Optional[torch.Tensor], base: torch.Tensor,
                    valid: torch.Tensor, last: torch.Tensor,
                    fin_norm: torch.Tensor, fin_meta: torch.Tensor,
                    r: torch.Tensor, ctc_lp: torch.Tensor,
                    min_len: torch.Tensor, max_len: torch.Tensor, *,
                    aw: float, cw: float, lw: float, eos: int, pad: int,
                    blank: int = 0, probs: Optional[torch.Tensor] = None
                    ) -> BeamStepOut:
    """K8, with the dtypes of the module docstring, every input contiguous;
    ``probs`` = exp(ctc_lp) f32 (B, T, V), computed here when not given
    (the beam passes its loop-invariant copy). CPU tensors take the plain
    version; CUDA tensors launch the kernel on ``clusters(V)`` blocks per
    utterance, and a cluster that cannot be resident raises. Either way,
    inputs of another dtype or layout raise."""
    B, K, V = logits.shape
    T = r.shape[2]
    f32, i64 = torch.float32, torch.int64
    bk = (B, K)
    specs = [("logits", logits, (B, K, V), f32),
             ("base", base, bk, f32), ("valid", valid, bk, torch.bool),
             ("last", last, bk, i64), ("fin_norm", fin_norm, bk, f32),
             ("fin_meta", fin_meta, bk, i64), ("r", r, (B, K, T, 2), f32),
             ("ctc_lp", ctc_lp, (B, T, V), f32),
             ("min_len", min_len, (B,), torch.int32),
             ("max_len", max_len, (B,), torch.int32)]
    if lm_logits is not None:
        specs.append(("lm_logits", lm_logits, (B, K, V), f32))
    if probs is not None:
        specs.append(("probs", probs, (B, T, V), f32))
    build.check_inputs("beam_step_fused", logits, *specs)
    kw = dict(aw=aw, cw=cw, lw=lw, eos=eos, pad=pad, blank=blank)
    if logits.device.type == "cpu":
        return beam_step_plain(t, logits, lm_logits, base, valid, last,
                               fin_norm, fin_meta, r, ctc_lp, min_len,
                               max_len, probs=probs, **kw)
    if logits.device.type != "cuda":
        raise ValueError(f"beam_step_fused: unsupported device {logits.device}")
    if K > MAX_K:
        raise ValueError(f"beam_step_fused: K={K} > {MAX_K}")
    lib = build.load("beam_step", _SIGNATURES)
    C = clusters(V)
    if _max_clusters(lib, K, T, V, C, logits.device.index) < 1:
        raise ValueError(f"beam_step_fused: a cluster of {C} blocks at K={K},"
                         f" T={T}, V={V} cannot be resident on this card")
    if probs is None:
        probs = torch.exp(ctc_lp)
    # the (B, K) outputs as views of one buffer per dtype: fewer allocations
    # on a path whose time at V=31 is mostly the host's
    dev = logits.device
    i64s = torch.empty((3, B, K), dtype=i64, device=dev)
    f32s = torch.empty((3, B, K), dtype=f32, device=dev)
    out = BeamStepOut(i64s[0], i64s[1], torch.empty(bk, dtype=torch.bool,
                                                     device=dev),
                      f32s[0], f32s[1], i64s[2],
                      torch.empty((B, K, T, 2), dtype=f32, device=dev),
                      f32s[2])
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    ptr = lambda x: None if x is None else x.data_ptr()
    rc = lib.beam_step_launch(
        logits.data_ptr(), ptr(lm_logits), base.data_ptr(), valid.data_ptr(),
        last.data_ptr(), fin_norm.data_ptr(), fin_meta.data_ptr(),
        r.data_ptr(), ctc_lp.data_ptr(), probs.data_ptr(), min_len.data_ptr(),
        max_len.data_ptr(), *(x.data_ptr() for x in out), t, B, K, T, V, C,
        aw, cw, lw, eos, pad, blank, stream)
    build.check(rc, "beam_step_fused launch")
    beam_step_fused.launches += 1
    return out


beam_step_fused.launches = 0
