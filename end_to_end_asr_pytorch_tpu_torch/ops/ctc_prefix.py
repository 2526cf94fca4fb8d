"""Vectorized label-synchronous CTC prefix scoring (the beam's exact path).

State convention: ``r`` (B, K, T, 2) holds log-probs of emitting the prefix
by time t with the last frame non-blank (index 0) / blank (index 1). Padded
frames beyond ``enc_len`` emit blank with probability 1
(``pad_ctc_log_probs``), which freezes the recursion.

Two scoring forms, as in the JAX package:
  * psi only: psi(c) = md + log(exp(phi - md) @ probs + 1e-38), a matmul
    in the probability domain after a per-hypothesis max shift, over the
    full vocab or a candidate set, with its opt-in approximations (the
    beam's ``ctc_window`` frame window and ``psi_quant`` int8 product);
  * the winners' state recompute (``cand_ids``, with the new r), solved in
    parallel over time with Hillis-Steele cumulative log-sum-exps.
The 1e-38 floor is a subnormal in f32: nothing on this path may flush
denormals to zero, or ``log`` returns -inf where the reference gives
md - 87.5. The doubling passes are kept as the JAX package writes them so
the CPU scores follow the same operations.

Under decode amp ``probs`` is bf16 (the psi-only path's only bf16 operand):
the step weights ``ws`` / ``wd`` are rounded to bf16 and the products are
summed in f32, as the JAX package's ``preferred_element_type=float32``
einsums do; psi stays f32. ``psi_kernel`` sends the full-vocab psi and its
epilogues to K6 (``ops/cuda/psi_kernel.py``) with the probs in their own
dtype, bf16 under amp and f32 without.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import cuda as cuda_kernels
from .cuda.psi_kernel import psi_fused, psi_plain

NEG_INF = -1e30
CLIP = -1e5  # 'effectively impossible' floor that keeps cumsums finite


def pad_ctc_log_probs(ctc_lp: torch.Tensor, enc_len: torch.Tensor,
                      blank: int = 0) -> torch.Tensor:
    """Force padded frames to 'blank with prob 1'. ctc_lp (B, T, V)."""
    B, T, V = ctc_lp.shape
    pad = (torch.arange(T, device=ctc_lp.device)[None, :]
           >= enc_len[:, None])[..., None]
    blank_row = torch.full((V,), NEG_INF, device=ctc_lp.device)
    blank_row[blank] = 0.0
    return torch.where(pad, blank_row[None, None, :], ctc_lp)


def init_state(ctc_lp: torch.Tensor, beam: int, blank: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Empty-prefix state for K slots: (r (B, K, T, 2), psi0 (B, K))."""
    B, T, V = ctc_lp.shape
    r_b = torch.cumsum(ctc_lp[:, :, blank], dim=1)
    r_nb = torch.full((B, T), NEG_INF, device=ctc_lp.device)
    r = torch.stack([r_nb, r_b], dim=-1)
    return (r[:, None].expand(B, beam, T, 2),
            torch.zeros((B, beam), device=ctc_lp.device))


def _shift_right(x: torch.Tensor, shift: int, fill: float) -> torch.Tensor:
    pad = torch.full(x.shape[:-1] + (shift,), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([pad, x[..., :x.shape[-1] - shift]], dim=-1)


def _cumlogsumexp(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative logsumexp over the last axis by Hillis-Steele
    doubling: ceil(log2 T) shifted logaddexp passes."""
    T = x.shape[-1]
    shift = 1
    while shift < T:
        x = torch.logaddexp(x, _shift_right(x, shift, NEG_INF))
        shift *= 2
    return x


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over the last axis by the same doubling."""
    T = x.shape[-1]
    shift = 1
    while shift < T:
        x = x + _shift_right(x, shift, 0.0)
        shift *= 2
    return x


def _logsumexp(x: torch.Tensor, dim: int) -> torch.Tensor:
    amax = torch.amax(x, dim=dim, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    return (torch.log(torch.sum(torch.exp(x - amax), dim=dim, keepdim=True))
            + amax).squeeze(dim)


def quantize_probs_q8(probs: torch.Tensor) -> torch.Tensor:
    """Probabilities in [0, 1] -> int8 round(p * 127) (half to even, as
    ``jnp.round``): the q8 psi product's operand (``psi_quant``)."""
    return torch.clamp(torch.round(probs * 127.0), 0.0, 127.0).to(torch.int8)


Q8_CHUNK = 1040  # frames whose q8 products sum below 2^24 (1040 * 127^2)


def q8_product(qw: torch.Tensor, probs_q8: torch.Tensor) -> torch.Tensor:
    """The int32 sum over t of qw (B, K, T) x probs_q8 (B, T, V), both
    integers in [0, 127], exactly as an int8 x int8 -> int32 product: each
    chunk of at most ``Q8_CHUNK`` frames is one f32 product, exact in any
    order because every partial sum is an integer below 2^24 (the
    operands, at most 127, are exact in TF32 too), and the chunks are
    summed in int32.
    ``probs_q8`` may be int8 or its values in f32."""
    T = qw.shape[-1]
    acc = None
    for t0 in range(0, T, Q8_CHUNK):
        part = torch.bmm(qw[..., t0:t0 + Q8_CHUNK].float(),
                         probs_q8[:, t0:t0 + Q8_CHUNK].float()).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def _window_start(phi_diff: torch.Tensor, max_nb_lp: Optional[torch.Tensor],
                  W: int) -> torch.Tensor:
    """Each utterance's window start: the frontier argmax over t of
    max_k phi_diff (+ max_nb_lp), the first maximum on ties, less W // 2,
    clipped to [0, T - W]. (B,) int64."""
    T = phi_diff.shape[-1]
    sup = torch.amax(phi_diff, dim=1)                       # (B, T)
    if max_nb_lp is not None:
        sup = sup + max_nb_lp
    return torch.clamp(torch.argmax(sup, dim=-1) - W // 2, 0, T - W)


def _take_frames(x: torch.Tensor, start: torch.Tensor, W: int,
                 dim: int) -> torch.Tensor:
    """x[b, ..., start[b]:start[b] + W, ...] along ``dim`` for every b."""
    idx = start[:, None] + torch.arange(W, device=x.device)[None]   # (B, W)
    shape = [x.shape[0]] + [1] * (x.ndim - 1)
    shape[dim] = W
    idx = idx.reshape(shape).expand(
        *[W if d == dim else n for d, n in enumerate(x.shape)])
    return torch.gather(x, dim, idx)


def score_candidates(ctc_lp: Optional[torch.Tensor], r_prev: torch.Tensor,
                     last_tok: torch.Tensor, prefix_len: torch.Tensor,
                     blank: int = 0, cand_ids: Optional[torch.Tensor] = None,
                     with_state: bool = True,
                     probs: Optional[torch.Tensor] = None,
                     blank_lp: Optional[torch.Tensor] = None,
                     psi_kernel: bool = False,
                     probs_vt: Optional[torch.Tensor] = None,
                     probs_q8: Optional[torch.Tensor] = None,
                     window: int = 0,
                     max_nb_lp: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Score extensions of every hypothesis.

    ctc_lp (B, T, V) padded log-probs (None in psi-only mode when ``probs``
    or ``probs_vt`` is given); r_prev (B, K, T, 2); last_tok (B, K);
    prefix_len (B, K) tokens emitted so far; ``cand_ids`` (B, K, C) the
    extensions to score, all V when None. The forms, as in the JAX package:
      * ``with_state=False``: psi only. With ``cand_ids`` and ``probs_vt``
        (= exp(ctc_lp) as (B, V, T)) the candidates' emission rows are
        gathered and only they are scored. Else psi over the full vocab
        (``probs`` = exp(ctc_lp), bf16 under amp, may be passed
        precomputed), gathered at ``cand_ids`` if given: ``psi_kernel``
        takes K6 for it (full T, no window); ``window`` W > 0 sums only
        the W frames around each utterance's alignment frontier
        (``max_nb_lp`` (B, T) sharpens it); ``probs_q8`` (the
        ``quantize_probs_q8`` operand) makes the product the exact int32
        one of the weights quantized the same way;
      * ``with_state=True`` with ``cand_ids``: psi and the new state of
        those C extensions.
    Returns (psi (B, K, C), r_new (B, K, C, T, 2) or None).
    """
    B, K, T, _ = r_prev.shape
    r_nb_prev = r_prev[..., 0]
    r_b_prev = r_prev[..., 1]
    empty = (prefix_len == 0)[..., None]                   # (B, K, 1)

    if not with_state:
        phi_m1_col = torch.where(empty[..., 0], 0.0, NEG_INF)[..., None]
        phi_diff = torch.cat(
            [phi_m1_col, torch.logaddexp(r_b_prev, r_nb_prev)[..., :-1]], -1)
        phi_same = torch.cat([phi_m1_col, r_b_prev[..., :-1]], -1)
        md = torch.clamp(torch.amax(phi_diff, -1, keepdim=True), min=NEG_INF / 2)
        ms = torch.clamp(torch.amax(phi_same, -1, keepdim=True), min=NEG_INF / 2)
        if cand_ids is not None and probs_vt is not None:
            # the candidates' emission rows only: reads scale with C
            C = cand_ids.shape[-1]
            pc = torch.gather(probs_vt, 1, cand_ids.reshape(B, K * C, 1)
                              .expand(B, K * C, T)).reshape(B, K, C, T)
            wd = torch.exp(phi_diff - md).to(probs_vt.dtype)
            psi_diff = md + torch.log(torch.einsum(
                "bkt,bkct->bkc", wd.float(), pc.float()) + 1e-38)
            ws = torch.exp(phi_same - ms).to(probs_vt.dtype)
            p_last = torch.gather(probs_vt, 1, last_tok[..., None].expand(
                B, K, T))
            psi_same = ms[..., 0] + torch.log(torch.einsum(
                "bkt,bkt->bk", ws.float(), p_last.float()) + 1e-38)
            psi = torch.where(cand_ids == last_tok[..., None],
                              psi_same[..., None], psi_diff)
            return torch.where(cand_ids == blank, NEG_INF, psi), None
        if probs is None:
            probs = torch.exp(ctc_lp)
        wd = torch.exp(phi_diff - md)                       # (B, K, T) f32
        ws = torch.exp(phi_same - ms).to(probs.dtype)
        p_last = torch.gather(probs, 2, last_tok[:, None, :].expand(B, T, K))
        # bf16 products summed in f32 (JAX: preferred_element_type=f32)
        psi_same = ms[..., 0] + torch.log(
            torch.einsum("bkt,btk->bk", ws.float(), p_last.float()) + 1e-38)
        last32 = last_tok.to(torch.int32)
        if psi_kernel and cand_ids is None:
            use_kernel = probs.is_cuda and cuda_kernels.USE_KERNELS
            run = psi_fused if use_kernel else psi_plain
            psi = run(wd, probs, md[..., 0], psi_same, last32, blank)
        else:
            if window and window < T:
                start = _window_start(phi_diff, max_nb_lp, window)
                wd = _take_frames(wd, start, window, 2)      # (B, K, W)
                if probs_q8 is not None:
                    probs_q8 = _take_frames(probs_q8, start, window, 1)
                else:
                    probs = _take_frames(probs, start, window, 1)
            if probs_q8 is not None:
                # acc == 0 (mass below the quantization step) floors at
                # md - 69 nats, the finite floor class of the exact path
                qw = torch.clamp(torch.round(wd * 127.0), 0.0, 127.0)
                accf = q8_product(qw, probs_q8).float() * (1.0 / (127.0 * 127.0))
                psi = md + torch.log(torch.clamp(accf, min=1e-30))
                V = psi.shape[-1]
                col = torch.arange(V, device=psi.device)
                psi = torch.where(col == last32[..., None], psi_same[..., None],
                                  psi)
                psi[:, :, blank] = NEG_INF
            else:
                psi = psi_plain(wd, probs, md[..., 0], psi_same, last32, blank)
        if cand_ids is not None:
            psi = torch.gather(psi, 2, cand_ids)
        return psi, None

    if cand_ids is None:
        raise NotImplementedError(
            "full-vocab state recompute is not on the beam's path")
    C = cand_ids.shape[-1]
    cand = cand_ids
    same = cand == last_tok[..., None]                      # (B, K, C)
    phi = torch.where(same[..., None], r_b_prev[:, :, None, :],
                      torch.logaddexp(r_b_prev, r_nb_prev)[:, :, None, :])
    phi_m1 = torch.where(empty, 0.0, NEG_INF).expand(B, K, C)
    g = torch.gather(ctc_lp, 2, cand.reshape(B, 1, K * C).expand(B, T, K * C))
    xs = g.transpose(1, 2).reshape(B, K, C, T)
    xs = torch.clamp(xs, min=CLIP)
    bl = (blank_lp if blank_lp is not None
          else torch.clamp(ctc_lp[:, :, blank], min=CLIP))  # (B, T)
    phi_s = torch.cat([phi_m1[..., None],
                       torch.clamp(phi[..., :-1], min=NEG_INF)], dim=-1)
    psi = _logsumexp(phi_s + xs, dim=-1)
    psi = torch.where(cand == blank, NEG_INF, psi)
    scum = _cumsum(xs)
    scum_s = torch.cat([torch.zeros_like(scum[..., :1]), scum[..., :-1]], -1)
    r_nb = scum + _cumlogsumexp(phi_s - scum_s)
    bcum = _cumsum(bl)
    bcum_s = torch.cat([torch.zeros_like(bcum[..., :1]), bcum[..., :-1]], -1)
    u = torch.cat([torch.full_like(r_nb[..., :1], NEG_INF),
                   r_nb[..., :-1] - bcum_s[:, None, None, 1:]], dim=-1)
    r_b = bcum[:, None, None, :] + _cumlogsumexp(u)
    return psi, torch.stack([r_nb, r_b], dim=-1)


def final_score(r_prev: torch.Tensor) -> torch.Tensor:
    """CTC log-prob of each prefix as a complete sequence: logsumexp of
    both states at the last frame. (B, K)."""
    return torch.logaddexp(r_prev[..., -1, 0], r_prev[..., -1, 1])
