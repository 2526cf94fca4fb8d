"""Batched joint CTC / attention beam search with RNN-LM shallow fusion.

Combined score ``(1-ctc_w) * logP_att + ctc_w * CTCPrefixScore +
lm_w * logP_lm``; ``min_len_ratio``/``max_len_ratio`` bounds from the
encoded length; eos finalization with length-normalized ranking. The whole
batch advances K hypotheses per step as (B, K, ...) tensors, decoder and LM
states folded to (B*K, ...), attention against the unexpanded cache. Step
for step the JAX package's beam, on both of its paths:

  * exact (f32), the default on the CPU;
  * decode amp (``amp``: ``auto`` = on when the encoder runs on CUDA, as the
    JAX package turns it on off the CPU; ``True`` / ``False``): the model's
    and the LM's floating parameters rounded to bf16 once for the call and
    kept in f32, so no step widens a weight again (the caller's modules stay
    as they are), bf16 features, bf16 attention keys and
    values, the CTC prep normalised by one logsumexp and exponentiated in
    bf16, bf16 first-layer lookup tables for the decoder and the LM, and
    (``fold_logp``: ``auto`` = amp and V >= 1024, or forced) the
    log-softmax normalisers folded into one per-hypothesis shift. Scores,
    psi and the CTC state stay f32.

Each step calls the decoder, the LM and the attention, gathers their
states by the winners' parent slots, and hands everything else (the
log-softmax of both heads, the eos scores and the finished-set merge, psi,
the joint top-K, the winners' CTC states) to one call of
``ops/cuda/beam_step_kernel.py``: K8 (``beam_step_fused``) within its
scope, CTC on over the full vocabulary and amp resolved off; its plain
version ``beam_step_plain`` outside it (amp, no CTC) and with
``fused_step: false`` (the port's own key; the JAX package's decoder
ignores it). Only there does ``psi_kernel: true`` act: it sends the
full-vocab psi to K6 wherever the JAX package's gate (``pick_block``) takes
its Pallas kernel, bf16 probs under amp, f32 probs without. The JAX
package's amp beam reorders states with one-hot products, which are exact
reorders; here they are gathers, with the same values.

Ties: ``lax.top_k`` prefers the lowest index among equal values, and the
finished set's NEG_INF placeholders are mass ties. ``torch.topk`` promises
no tie order, so every top-K here is a stable descending sort.

Not ported yet (a non-default value raises NotImplementedError):
``psi_quant``, ``ctc_window``, ``approx_topk``, ``ctc_candidates > 0`` and
the embedding-fusion ``plugin``.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..models.asr import ASR
from ..models.lm import RNNLM
from ..ops import ctc_prefix
from ..ops import cuda as cuda_kernels
from ..ops.amp import bf16_rounded_copy
from ..ops.cuda import beam_step_kernel
from ..ops.cuda.beam_step_kernel import (beam_step_fused, beam_step_plain,
                                         gather_k as _gather_k, logsumexp)
from ..ops.cuda.psi_kernel import pick_block
from ..utils.text import EOS_IDX, PAD_IDX

NEG_INF = -1e30

# config key -> values that select a path ported here
_PORTED = {
    "amp": ("auto", True, False, None),
    "psi_kernel": (True, False, "auto", None),
    "psi_quant": (False, None),
    "ctc_window": (0, None),
    "approx_topk": (False, None),
    "ctc_candidates": (0, None),
    "fold_logp": ("auto", True, False, None),
    "fused_step": (True, False, "auto", None),
}


def ctc_prep(model: ASR, enc: torch.Tensor, enc_len: torch.Tensor,
             amp: bool):
    """The beam's loop-invariant CTC inputs: padded log-probs (B, T, V) f32
    and their exp, the psi products' operand. Under amp the logits are
    normalised by one logsumexp and exponentiated in bf16 (the probs only
    feed f32-accumulating products); else the exact f32 path."""
    if amp:
        logits = model.ctc_logits(enc)                          # f32
        ctc_lp = ctc_prefix.pad_ctc_log_probs(logits - logsumexp(logits),
                                              enc_len)
        return ctc_lp, torch.exp(ctc_lp.to(torch.bfloat16))
    ctc_lp = ctc_prefix.pad_ctc_log_probs(model.ctc_output(enc), enc_len)
    return ctc_lp, torch.exp(ctc_lp)


class BeamOutput(NamedTuple):
    tokens: torch.Tensor   # (B, K, L) emitted tokens (no sos/eos), 0-padded
    lengths: torch.Tensor  # (B, K)
    scores: torch.Tensor   # (B, K) length-normalized, sorted desc


def _backtrace(vs: torch.Tensor, ks: torch.Tensor, fin_step: torch.Tensor,
               fin_slot: torch.Tensor, L: int) -> torch.Tensor:
    """Token sequences from the per-step lineage records vs/ks (S, B, K):
    token written into / parent slot of each new slot at step s. Returns
    (B, K, L), zero-padded past each hypothesis's length."""
    S = vs.shape[0]
    slot = fin_slot
    toks = [None] * S
    for s in range(S - 1, -1, -1):
        active = s < fin_step
        tok = torch.gather(vs[s], 1, slot)
        par = torch.gather(ks[s], 1, slot)
        slot = torch.where(active, par, slot)
        toks[s] = torch.where(active, tok, torch.zeros_like(tok))
    return torch.stack(toks, dim=2)[:, :, :L]


class BeamDecoder:
    def __init__(self, model: ASR, decode_cfg: Dict[str, Any],
                 lm: Optional[RNNLM] = None, plugin=None):
        if not model.enable_att:
            raise ValueError("beam decoder needs the attention decoder")
        if plugin is not None:
            raise NotImplementedError("embedding-fusion plugin is not ported yet")
        for key, ok in _PORTED.items():
            if key in decode_cfg and decode_cfg[key] not in ok:
                raise NotImplementedError(
                    f"decode.{key}={decode_cfg[key]!r} is not ported yet")
        self.model = model
        self.beam = int(decode_cfg.get("beam_size", 4))
        if self.beam > 256:
            raise ValueError("packed finished-set metadata assumes beam <= 256")
        self.min_len_ratio = float(decode_cfg.get("min_len_ratio", 0.0))
        self.max_len_ratio = float(decode_cfg.get("max_len_ratio", 1.0))
        self.lm_weight = float(decode_cfg.get("lm_weight", 0.0))
        cw = decode_cfg.get("ctc_weight", 0.0)
        self.ctc_weight = float(cw) if model.enable_ctc else 0.0
        self.lm = lm if self.lm_weight > 0 else None
        self.use_ctc = self.ctc_weight > 0
        es = decode_cfg.get("early_stop", "auto")
        self.early_stop = True if es == "auto" else bool(es)
        self.early_stop_slack = float(decode_cfg.get("early_stop_slack", 0.05))
        amp = decode_cfg.get("amp", "auto")
        self.amp = "auto" if amp in ("auto", None) else bool(amp)
        self.psi_kernel = decode_cfg.get("psi_kernel", False) is True
        self.fused_step = decode_cfg.get("fused_step", "auto") is not False
        fl = decode_cfg.get("fold_logp", "auto")
        self.fold_logp = "auto" if fl in ("auto", None) else bool(fl)
        self.last_steps = None  # steps the last forward ran (early exit)
        self.last_amp = None    # whether the last forward ran under amp
        self.last_fused = None  # whether its steps went through K8's route
        self.last_k8_launches = None  # K8 launches it made (on the card)
        self.last_enc = None    # the encoder output it decoded from

    @torch.no_grad()
    def forward(self, feat: torch.Tensor, feat_len: torch.Tensor) -> BeamOutput:
        K = self.beam
        amp = feat.is_cuda if self.amp == "auto" else self.amp
        self.last_amp = amp
        # K8's scope (the TPU kernel's, less its layout rule), decided
        # before any launch: CTC over the full vocabulary, f32 (no amp), at
        # every V (PERF.md: at V=5120 K8 takes a cluster of blocks per
        # utterance and less device time than the eager tail)
        fused = self.fused_step and self.use_ctc and not amp
        self.last_fused = fused
        k8_0 = beam_step_kernel.beam_step_fused.launches
        model, lm = self.model, self.lm
        if amp:
            model = bf16_rounded_copy(model)
            lm = bf16_rounded_copy(lm) if lm is not None else None
            if feat.dtype == torch.float32:
                feat = feat.to(torch.bfloat16)
        V = model.vocab_size
        enc, enc_len = model.encode(feat, feat_len)
        self.last_enc = enc
        B, T, _ = enc.shape
        dev = enc.device
        L = max(1, int(math.ceil(self.max_len_ratio * T)))

        cache = model.attention.precompute(enc, enc_len, amp=amp)
        dec_state = model.decoder.init_state(B * K, dev, enc.dtype)
        align0 = model.attention.init_align(cache)
        align = align0[:, None].expand((B, K) + align0.shape[1:])

        # per-utterance bounds are f32 ceilings, as in the JAX package
        # (0.6 * 5 is 3.0000000000000004 in double but 3.0 in f32)
        enc_len_f = enc_len.to(torch.float32)
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        min_len = torch.ceil(f32(self.min_len_ratio) * enc_len_f).to(torch.int32)
        max_len = torch.clamp(torch.ceil(f32(self.max_len_ratio) * enc_len_f)
                              .to(torch.int32), min=1)

        if self.use_ctc:
            ctc_lp, ctc_probs = ctc_prep(model, enc, enc_len, amp)
            r_state, psi_prev = ctc_prefix.init_state(ctc_lp, K)
            r_state = r_state.contiguous()
            blank_lp = torch.clamp(ctc_lp[:, :, 0], min=ctc_prefix.CLIP)
            # the JAX package's gate, decided before any launch
            psi_kernel = self.psi_kernel and pick_block(
                V, T, ctc_probs.element_size()) is not None
        else:
            ctc_lp = ctc_probs = r_state = blank_lp = None
            psi_kernel = False
            psi_prev = torch.zeros((B, K), device=dev)

        use_lm = lm is not None
        lm_state = lm.init_state(B * K, dev, enc.dtype) if use_lm else None
        # first-layer lookup tables (amp only, so the exact path keeps the
        # JAX package's exact op sequence)
        tables = model.precompute_decode_tables(amp=True) if amp else None
        lm_embp = lm.emb_proj_table(amp=True) if (use_lm and amp) else None
        fold_lse = amp and (V >= 1024 if self.fold_logp == "auto"
                            else self.fold_logp)

        carry = {
            "last": torch.full((B, K), EOS_IDX, dtype=torch.int64, device=dev),
            "valid": (torch.arange(K, device=dev)[None] == 0).expand(
                B, K).contiguous(),
            "base": torch.zeros((B, K), device=dev),
            "psi": psi_prev,
            "r": r_state,
            "dec_state": dec_state,
            "align": align,
            "lm_state": lm_state,
            # finished hypotheses: normalized score + (step << 8 | slot)
            "fin_meta": torch.zeros((B, K), dtype=torch.int64, device=dev),
            "fin_norm": torch.full((B, K), NEG_INF, device=dev),
        }
        aw, cw, lw = 1.0 - self.ctc_weight, self.ctc_weight, self.lm_weight
        if fused and cuda_kernels.USE_KERNELS:
            run_tail = functools.partial(beam_step_fused, probs=ctc_probs)
        else:
            run_tail = functools.partial(
                beam_step_plain, probs=ctc_probs, blank_lp=blank_lp,
                psi_kernel=psi_kernel, fold_lse=fold_lse)
        batch_base = torch.arange(B, device=dev)[:, None] * K

        def tail(carry, t: int, logits, last_flat):
            """Everything the step does after the decoder: the LM step,
            then the scores, the finished-set merge, the joint top-K and
            the winners' CTC states in one K8 call (its plain version on
            the other routes)."""
            if use_lm:
                lm_logits, new_lm = lm.step(carry["lm_state"], last_flat,
                                            emb_proj=lm_embp)
                lm_logits = lm_logits.reshape(B, K, V)
            else:
                lm_logits = new_lm = None
            o = run_tail(t, logits.reshape(B, K, V), lm_logits, carry["base"],
                         carry["valid"], carry["last"], carry["fin_norm"],
                         carry["fin_meta"], carry["r"], ctc_lp, min_len,
                         max_len, aw=aw, cw=cw, lw=lw, eos=EOS_IDX,
                         pad=PAD_IDX)
            return {"last": o.v_idx, "valid": o.new_valid, "base": o.new_base,
                    "fin_meta": o.fin_meta, "fin_norm": o.fin_norm,
                    "psi": o.psi_pick, "r": o.r}, new_lm, o.k_idx

        def step(carry, t: int):
            last_flat = carry["last"].reshape(B * K)
            logits, new_dec, new_align, _ = model.decode_step_beam(
                cache, carry["dec_state"], carry["align"], last_flat, K,
                tables=tables)
            out, new_lm, k_idx = tail(carry, t, logits, last_flat)
            flat_sel = (batch_base + k_idx).reshape(B * K)
            sel = lambda s: type(s)(*(x[:, flat_sel] if x is not None else None
                                      for x in s))
            out["dec_state"] = sel(new_dec)
            out["align"] = _gather_k(new_align, k_idx)
            out["lm_state"] = sel(new_lm) if use_lm else None
            return out, (out["last"], k_idx)

        # L+1 steps: step t offers finalization to length-t hypotheses, then
        # expands to length t+1; the last step only finalizes
        S = L + 1
        if not self.early_stop:
            vs, ks = [], []
            for t in range(S):
                carry, (v, kk) = step(carry, t)
                vs.append(v)
                ks.append(kk)
            vs, ks = torch.stack(vs), torch.stack(ks)
            self.last_steps = S
        else:
            # exact early exit, tested once per 4-step block (one host sync):
            # stop once no live hypothesis can still beat the K-th finished
            # score. Steps past S are no-ops (every slot is dead).
            UN = 4
            S4 = ((S + UN - 1) // UN) * UN
            vs = torch.zeros((S4, B, K), dtype=torch.int64, device=dev)
            ks = torch.zeros((S4, B, K), dtype=torch.int64, device=dev)
            m_hi = torch.clamp(max_len + 1, min=1).to(torch.float32)
            slack = self.early_stop_slack
            t = 0
            while t < S4 and self._can_improve(carry, t, cw, max_len,
                                               min_len, m_hi, slack):
                for j in range(UN):
                    carry, (v, kk) = step(carry, t + j)
                    vs[t + j] = v
                    ks[t + j] = kk
                t += UN
            self.last_steps = t
        self.last_k8_launches = beam_step_kernel.beam_step_fused.launches - k8_0
        fin_step = carry["fin_meta"] >> 8
        fin_slot = carry["fin_meta"] & 0xFF
        tokens = _backtrace(vs, ks, fin_step, fin_slot, L)
        return BeamOutput(tokens, fin_step, carry["fin_norm"])

    @staticmethod
    def _can_improve(c, t, cw, max_len, min_len, m_hi, slack) -> bool:
        """Can any live hypothesis still enter the finished top-K? Per-step
        score increments are <= 0, so a live total ``tot`` finalizes at
        best at tot/(max_len+1) (tot < 0) or tot/(t+1) (tot >= 0)."""
        tot = c["base"] + cw * c["psi"]
        alive = c["valid"] & (t <= max_len[:, None])
        m_lo = torch.clamp(torch.clamp(min_len, min=1), min=t + 1
                           ).to(torch.float32)
        bound = torch.where(tot < 0.0, tot / m_hi[:, None], tot / m_lo[:, None])
        bound = torch.where(alive, bound, torch.full((), NEG_INF,
                                                     device=tot.device))
        best_live = torch.amax(bound, dim=1)
        worst_fin = torch.amin(c["fin_norm"], dim=1)
        can = alive.any(dim=1) & (best_live >= worst_fin - slack)
        return bool(can.any())
