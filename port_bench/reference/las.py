"""Plain joint CTC / attention LAS of the reference
(``config/libri/asr_example.yaml``'s model): log-mel front end with
per-utterance CMVN, VGG prenet, bidirectional LSTMs, CTC head, location
attention and an LSTM speller; the joint score of a finished beam
hypothesis.

Written from the model's equations, in float32 (``numerics.Numerics``
carries the controls' lower precisions), with nothing of the program: the
power spectrum is ``torch.fft.rfft`` of Hann-windowed frames, the CTC
likelihood ``F.ctc_loss``, the recurrences plain loops. The leaves are
named and laid out as the program's, so both take the same seeded weights.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import lm as lm_ref
from .numerics import Numerics
from .rnn import Leaf, lstm_cell, lstm_leaves, lstm_scan

EOS = 1       # also <sos>
NEG = -1e30   # the masked energy


def _check(cfg: Dict[str, Any]) -> None:
    enc, att, dec = cfg["encoder"], cfg["attention"], cfg["decoder"]
    ok = (enc.get("prenet") == "vgg" and str(enc["module"]).lower() == "lstm"
          and enc.get("bidirection", True)
          and not any(enc.get("layer_norm", [False])) and not any(
              enc.get("proj", [False]))
          and all(int(r) == 1 for r in enc.get("sample_rate", [1]))
          and att.get("mode") == "loc" and int(att.get("num_head", 1)) == 1
          and att.get("v_proj", True) and str(dec["module"]).lower() == "lstm"
          and int(dec.get("layer", 1)) == 1
          and float(cfg.get("emb_drop", 0.0)) == 0.0
          and 0 < float(cfg["ctc_weight"]) < 1)
    if not ok:
        raise NotImplementedError(
            "the reference LAS is a VGG + BiLSTM encoder, one-head location "
            "attention with v_proj and one LSTM speller layer, both heads on")


def dims(cfg: Dict[str, Any], feat_dim: int) -> Dict[str, int]:
    _check(cfg)
    if feat_dim % 13 == 0:
        freq = 13
    elif feat_dim % 40 == 0:
        freq = 40
    else:
        freq = feat_dim
    return {"in_ch": feat_dim // freq, "freq": freq,
            "vgg_out": 128 * max(freq // 4, 1),
            "enc": 2 * int(cfg["encoder"]["dim"][-1]),
            "att": int(cfg["attention"]["dim"]),
            "dec": int(cfg["decoder"]["dim"])}


def leaves(cfg: Dict[str, Any], feat_dim: int, vocab: int) -> List[Leaf]:
    d = dims(cfg, feat_dim)
    out: List[Leaf] = [("ctc_w", (d["enc"], vocab), "w", d["enc"]),
                       ("ctc_b", (vocab,), "zero", 0),
                       ("embed", (vocab, d["dec"]), "w", d["dec"]),
                       ("char_w", (d["dec"], vocab), "w", d["dec"]),
                       ("char_b", (vocab,), "zero", 0)]
    for i, (cin, cout) in enumerate(((d["in_ch"], 64), (64, 64), (64, 128),
                                     (128, 128)), 1):
        out += [(f"encoder.prenet.k{i}", (cout, cin, 3, 3), "w", 9 * cin),
                (f"encoder.prenet.b{i}", (cout,), "zero", 0)]
    din = d["vgg_out"]
    for i, h in enumerate(cfg["encoder"]["dim"]):
        out += lstm_leaves(f"encoder.layers.{i}.fwd.", din, int(h))
        out += lstm_leaves(f"encoder.layers.{i}.bwd.", din, int(h))
        din = 2 * int(h)
    a = cfg["attention"]
    A, ks, nf = d["att"], int(a["loc_kernel_size"]), int(a["loc_kernel_num"])
    out += [("attention.w_q", (d["dec"], A), "w", d["dec"]),
            ("attention.w_k", (d["enc"], A), "w", d["enc"]),
            ("attention.w_v", (d["enc"], A), "w", d["enc"]),
            ("attention.loc_conv", (nf, 1, ks), "w", ks),
            ("attention.w_f", (nf, A), "w", nf),
            ("attention.bias", (A,), "zero", 0),
            ("attention.v_energy", (1, A), "w", A)]
    out += lstm_leaves("decoder.cells.0.", d["dec"] + A, d["dec"])
    return out


# ------------------------------------------------------------- front end
def _mel_matrix(n_bins: int, n_mels: int, sr: int) -> np.ndarray:
    """HTK triangular filters over [0, sr / 2], no normalisation."""
    mel = lambda f: 2595.0 * np.log10(1.0 + f / 700.0)
    hz = lambda m: 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    freqs = np.linspace(0.0, sr // 2, n_bins)
    pts = hz(np.linspace(mel(0.0), mel(sr / 2.0), n_mels + 2))
    fb = np.zeros((n_bins, n_mels))
    for m in range(n_mels):
        lo, c, hi = pts[m], pts[m + 1], pts[m + 2]
        fb[:, m] = np.maximum(0.0, np.minimum((freqs - lo) / (c - lo),
                                              (hi - freqs) / (hi - c)))
    return fb.astype(np.float32)


def fbank(nm: Numerics, audio_cfg: Dict[str, Any], wave: torch.Tensor,
          wave_len: torch.Tensor):
    """Waves (B, S) (int16 PCM or float) -> CMVN'd log-mel features
    (B, T, n_mels), zero past each row's frames, and the frame counts."""
    sr = int(audio_cfg.get("sample_rate", 16000))
    n_fft = int(sr * float(audio_cfg["frame_length"]) / 1000)
    hop = int(sr * float(audio_cfg["frame_shift"]) / 1000)
    n_mels = int(audio_cfg["feat_dim"])
    if audio_cfg.get("feat_type", "fbank") != "fbank" or int(
            audio_cfg.get("delta_order", 0)):
        raise NotImplementedError("the reference front end is a plain fbank")
    x = wave.float() / 32768.0 if wave.dtype == torch.int16 else wave.float()
    x = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(1, n_fft, hop)                         # (B, T, n_fft)
    n = torch.arange(n_fft, device=x.device, dtype=torch.float64)
    win = (0.5 - 0.5 * torch.cos(2 * math.pi * n / n_fft)).float()
    spec = torch.fft.rfft(nm.q(frames * win), dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    mel = torch.tensor(_mel_matrix(n_fft // 2 + 1, n_mels, sr),
                       device=x.device)
    feat = torch.log(nm.mm(power, mel) + 1e-10)
    T = feat.shape[1]
    feat_len = torch.clamp(wave_len.long() // hop + 1, max=T)
    m = (torch.arange(T, device=x.device)[None] < feat_len[:, None])[..., None]
    if audio_cfg.get("cmvn", True):
        cnt = torch.clamp(feat_len, min=1)[:, None, None].float()
        mean = (feat * m).sum(1, keepdim=True) / cnt
        var = ((feat - mean) ** 2 * m).sum(1, keepdim=True) / cnt
        feat = (feat - mean) / torch.sqrt(var + 1e-10)
    return torch.where(m, feat, torch.zeros_like(feat)), feat_len


# --------------------------------------------------------------- encoder
def encode(nm: Numerics, p, cfg, feat: torch.Tensor, feat_len: torch.Tensor):
    """feat (B, T, F) -> (enc (B, T/4, 2H) zero past each row, lengths)."""
    d = dims(cfg, feat.shape[2])
    B, T, _ = feat.shape
    h = feat.reshape(B, T, d["in_ch"], d["freq"]).permute(0, 2, 1, 3)
    for i in (1, 2, 3, 4):
        h = torch.relu(nm.conv2d(h, p[f"encoder.prenet.k{i}"], 1)
                       + p[f"encoder.prenet.b{i}"][:, None, None])
        if i in (2, 4):
            h = F.max_pool2d(h, 2)
    h = h.permute(0, 2, 1, 3).reshape(B, h.shape[2], -1)
    n = feat_len // 4
    mask = torch.arange(h.shape[1], device=h.device)[None] < n[:, None]
    for i in range(len(cfg["encoder"]["dim"])):
        pre = f"encoder.layers.{i}."
        h = torch.cat([lstm_scan(nm, p, pre + "fwd.", h, mask),
                       lstm_scan(nm, p, pre + "bwd.", h, mask, reverse=True)],
                      -1)
    return torch.where(mask[..., None], h, torch.zeros_like(h)), n


def ctc_logp(nm: Numerics, p, enc: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(nm.mm(enc, p["ctc_w"]) + p["ctc_b"], -1)


# ------------------------------------------------------ attention speller
class Cache:
    def __init__(self, nm: Numerics, p, enc: torch.Tensor, enc_len):
        self.keys = nm.mm(enc, p["attention.w_k"])            # (B, T, A)
        self.vals = nm.mm(enc, p["attention.w_v"])            # (B, T, A)
        T = enc.shape[1]
        self.mask = torch.arange(T, device=enc.device)[None] < enc_len[:, None]
        self.align0 = self.mask.float() / torch.clamp(enc_len, min=1)[:, None]

    def rows(self, idx: torch.Tensor) -> "Cache":
        c = Cache.__new__(Cache)
        c.keys, c.vals = self.keys[idx], self.vals[idx]
        c.mask, c.align0 = self.mask[idx], self.align0[idx]
        return c


def attend(nm: Numerics, p, att_cfg, cache: Cache, query: torch.Tensor,
           prev_align: torch.Tensor):
    """query (N, Dq), prev_align (N, T) -> (context (N, A), align (N, T))."""
    ks = p["attention.loc_conv"].shape[-1]
    a = F.pad(prev_align[:, None], ((ks - 1) // 2, ks // 2))
    loc = nm.conv1d(a, p["attention.loc_conv"]).transpose(1, 2)  # (N, T, nf)
    q = nm.mm(query, p["attention.w_q"]) + p["attention.bias"]
    e = torch.tanh(q[:, None] + cache.keys + nm.mm(loc, p["attention.w_f"]))
    energy = nm.mm(e, p["attention.v_energy"][0][:, None])[..., 0]
    energy = energy / float(att_cfg["temperature"])
    energy = torch.where(cache.mask, energy, torch.full_like(energy, NEG))
    align = torch.softmax(energy, -1)
    ctx = nm.mm(align[:, None], cache.vals)[:, 0]
    return ctx, align


def speller_step(nm: Numerics, p, cfg, cache: Cache, prev: torch.Tensor,
                 state):
    """One speller step: the previous tokens (N,) and the state (h, c,
    align) -> (logits (N, V), state); ``state`` None is the start."""
    if state is None:
        h = cache.keys.new_zeros((prev.shape[0], int(cfg["decoder"]["dim"])))
        state = (h, h, cache.align0)
    h, c, align = state
    ctx, align = attend(nm, p, cfg["attention"], cache, h, align)
    x = torch.cat([p["embed"][prev.long()], ctx], -1)
    x_proj = nm.mm(x, p["decoder.cells.0.w_ih"]) + p["decoder.cells.0.b"]
    h, c = lstm_cell(nm, p, "decoder.cells.0.", x_proj, h, c)
    return nm.mm(h, p["char_w"]) + p["char_b"], (h, c, align)


def speller_steps(nm: Numerics, p, cfg, cache: Cache,
                  prev_tokens: torch.Tensor) -> torch.Tensor:
    """The attention speller teacher-forced over U steps -> logits
    (N, U, V); step u is fed ``prev_tokens[:, u]``."""
    state, out = None, []
    for t in range(prev_tokens.shape[1]):
        logits, state = speller_step(nm, p, cfg, cache, prev_tokens[:, t],
                                     state)
        out.append(logits)
    return torch.stack(out, 1)


# ------------------------------------------------------------- decoding
class Encoded:
    """A decode batch through the encoder: enc (B, T, 2H) zero past each
    row, enc_len (B,), and the CTC log-probs lp (B, T, V) with each row's
    padded frames emitting blank with probability 1."""

    def __init__(self, enc, enc_len, lp):
        self.enc, self.enc_len, self.lp = enc, enc_len, lp

    @classmethod
    def of(cls, nm: Numerics, p, cfg, audio_cfg, wave, wave_len) -> "Encoded":
        feat, feat_len = fbank(nm, audio_cfg, wave, wave_len)
        enc, enc_len = encode(nm, p, cfg, feat, feat_len)
        lp = ctc_logp(nm, p, enc)
        pad = torch.arange(lp.shape[1], device=lp.device)[None] >= enc_len[:, None]
        blank = torch.full_like(lp[0, 0], NEG)
        blank[0] = 0.0
        return cls(enc, enc_len, torch.where(pad[..., None], blank, lp))

    @classmethod
    def cat(cls, parts: Sequence["Encoded"]) -> "Encoded":
        """Batches of different lengths as one, padded to the longest (the
        padding changes no score: attention masks it, CTC blanks it)."""
        T = max(e.enc.shape[1] for e in parts)
        blank = torch.full_like(parts[0].lp[0, 0], NEG)
        blank[0] = 0.0
        enc, lp = [], []
        for e in parts:
            n = T - e.enc.shape[1]
            enc.append(F.pad(e.enc, (0, 0, 0, n)))
            lp.append(torch.cat([e.lp, blank.expand(e.lp.shape[0], n, -1)], 1))
        return cls(torch.cat(enc), torch.cat([e.enc_len for e in parts]),
                   torch.cat(lp))


def hypothesis_scores(nm: Numerics, p, cfg, lm_p, lm_cfg, e: Encoded,
                      utt: torch.Tensor, hyps: Sequence[Sequence[int]],
                      weights: Tuple[float, float, float]) -> torch.Tensor:
    """The joint score of each finished hypothesis ``hyps[j]`` (its tokens,
    no <sos> / <eos>) of utterance ``utt[j]`` (a row of ``e``):
    (sum over its tokens and <eos> of aw log P_att + lw log P_lm, plus
    cw log P_ctc of the whole sequence) / (tokens + 1), as the beam ranks
    finished hypotheses. Returns (len(hyps),) float32."""
    aw, cw, lw = weights
    dev = e.enc.device
    N = len(hyps)
    n = torch.tensor([len(h) for h in hyps], device=dev)
    Umax = int(n.max()) + 1
    tgt = torch.zeros((N, Umax), dtype=torch.long, device=dev)
    for j, h in enumerate(hyps):
        tgt[j, :len(h)] = torch.tensor(list(h), dtype=torch.long)
        tgt[j, len(h)] = EOS
    prev = torch.cat([torch.full_like(tgt[:, :1], EOS), tgt[:, :-1]], 1)
    valid = torch.arange(Umax, device=dev)[None] <= n[:, None]
    logits = speller_steps(nm, p, cfg, Cache(nm, p, e.enc, e.enc_len).rows(utt),
                           prev)
    att = torch.gather(torch.log_softmax(logits, -1), -1, tgt[..., None])[..., 0]
    lm = lm_ref.token_logp(nm, lm_p, lm_cfg, prev, tgt, n + 1)
    step = torch.where(valid, aw * att + lw * lm, torch.zeros_like(att)).sum(1)
    ctc_tgt = torch.where(valid & (tgt != EOS), tgt, torch.zeros_like(tgt))
    ctc = -F.ctc_loss(e.lp[utt].transpose(0, 1), ctc_tgt, e.enc_len[utt], n,
                      blank=0, reduction="none", zero_infinity=False)
    return (step + cw * ctc) / (n + 1).float()
