"""Vectorized label-synchronous CTC prefix scoring (the beam's exact path).

State convention: ``r`` (B, K, T, 2) holds log-probs of emitting the prefix
by time t with the last frame non-blank (index 0) / blank (index 1). Padded
frames beyond ``enc_len`` emit blank with probability 1
(``pad_ctc_log_probs``), which freezes the recursion.

Two scoring forms, as in the JAX package:
  * psi only, full vocab: psi(c) = md + log(exp(phi - md) @ probs + 1e-38),
    a matmul in the probability domain after a per-hypothesis max shift;
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


def score_candidates(ctc_lp: torch.Tensor, r_prev: torch.Tensor,
                     last_tok: torch.Tensor, prefix_len: torch.Tensor,
                     blank: int = 0, cand_ids: Optional[torch.Tensor] = None,
                     with_state: bool = True,
                     probs: Optional[torch.Tensor] = None,
                     blank_lp: Optional[torch.Tensor] = None,
                     psi_kernel: bool = False
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Score extensions of every hypothesis.

    ctc_lp (B, T, V) padded log-probs; r_prev (B, K, T, 2); last_tok (B, K);
    prefix_len (B, K) tokens emitted so far. Two forms are ported:
      * ``with_state=False, cand_ids=None``: psi for the full vocab
        (``probs`` = exp(ctc_lp) may be passed precomputed, bf16 under amp;
        ``psi_kernel`` takes K6 for it and its epilogues);
      * ``with_state=True`` with ``cand_ids`` (B, K, C): psi and the new
        state of those C extensions.
    Returns (psi (B, K, C), r_new (B, K, C, T, 2) or None).
    """
    B, K, T, _ = r_prev.shape
    r_nb_prev = r_prev[..., 0]
    r_b_prev = r_prev[..., 1]
    empty = (prefix_len == 0)[..., None]                   # (B, K, 1)

    if not with_state:
        if cand_ids is not None:
            raise NotImplementedError(
                "candidate-restricted psi (ctc_candidates) is not ported yet")
        phi_m1_col = torch.where(empty[..., 0], 0.0, NEG_INF)[..., None]
        phi_diff = torch.cat(
            [phi_m1_col, torch.logaddexp(r_b_prev, r_nb_prev)[..., :-1]], -1)
        phi_same = torch.cat([phi_m1_col, r_b_prev[..., :-1]], -1)
        if probs is None:
            probs = torch.exp(ctc_lp)
        md = torch.clamp(torch.amax(phi_diff, -1, keepdim=True), min=NEG_INF / 2)
        wd = torch.exp(phi_diff - md)                       # (B, K, T) f32
        ms = torch.clamp(torch.amax(phi_same, -1, keepdim=True), min=NEG_INF / 2)
        ws = torch.exp(phi_same - ms).to(probs.dtype)
        p_last = torch.gather(probs, 2, last_tok[:, None, :].expand(B, T, K))
        # bf16 products summed in f32 (JAX: preferred_element_type=f32)
        psi_same = ms[..., 0] + torch.log(
            torch.einsum("bkt,btk->bk", ws.float(), p_last.float()) + 1e-38)
        use_kernel = (psi_kernel and probs.is_cuda
                      and cuda_kernels.USE_KERNELS)
        run = psi_fused if use_kernel else psi_plain
        return run(wd, probs, md[..., 0], psi_same,
                   last_tok.to(torch.int32), blank), None

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
