"""Audio feature front end: framing, STFT, mel projection, deltas, CMVN.

``create_transform(audio_cfg) -> (frontend, feat_dim)`` with
``feat_type: fbank|mfcc|linear``, ``frame_length``/``frame_shift`` in ms,
``delta_order``/``delta_window_size`` and per-utterance ``cmvn``, pinned to
torchaudio's MelSpectrogram conventions (periodic Hann window, center reflect
padding, power 2, HTK mel scale, no filterbank norm). ``use_pallas``
decides, as in the JAX package, whether an ``fbank`` log-mel goes through
the K1 kernel (``ops/cuda/fbank_kernel.py``): ``auto`` (the default) where
``n_fft`` and ``hop`` are multiples of 80 samples and the wave is on the
card, ``true`` for every card wave, ``false`` never. Outside the gate, and
for the other types, the plain PyTorch chain runs.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import cuda as cuda_kernels
from .cuda.fbank_kernel import fbank_fused, fbank_plain, power_spectrum

LOG_EPS = 1e-10


def hz_to_mel_htk(f: np.ndarray) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz_htk(m: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def melscale_fbanks(n_freqs: int, n_mels: int, sample_rate: int,
                    f_min: float = 0.0, f_max: float | None = None) -> np.ndarray:
    """Triangular HTK mel filterbank, no normalization: (n_freqs, n_mels)."""
    f_max = f_max or sample_rate / 2.0
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel_htk(f_min), hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def dft_matrices(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """cos and -sin (n_fft, n_fft//2 + 1) real-input DFT matrices."""
    n_bins = n_fft // 2 + 1
    k = np.arange(n_bins)[None, :]
    n = np.arange(n_fft)[:, None]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def dct_matrix(n_mels: int, n_mfcc: int) -> np.ndarray:
    """DCT-II with ortho norm, (n_mels, n_mfcc)."""
    n = np.arange(n_mels)[:, None]
    k = np.arange(n_mfcc)[None, :]
    m = np.cos(np.pi / n_mels * (n + 0.5) * k) * np.sqrt(2.0 / n_mels)
    m[:, 0] = 1.0 / np.sqrt(n_mels)
    return m.astype(np.float32)


def delta_filter(window_size: int) -> np.ndarray:
    n = window_size
    denom = 2.0 * sum(i * i for i in range(1, n + 1))
    return np.arange(-n, n + 1, dtype=np.float32) / denom


class AudioFrontend(nn.Module):
    """forward(waveform (B, S) f32 or int16, wave_len (B,) int)
        -> (features (B, T, D) f32, feat_len (B,) int32)."""

    def __init__(self, audio_cfg: Dict[str, Any], device=None):
        super().__init__()
        self.feat_type = audio_cfg.get("feat_type", "fbank")
        self.num_feat = int(audio_cfg.get("feat_dim", 40))
        sr = int(audio_cfg.get("sample_rate", 16000))
        frame_ms = float(audio_cfg.get("frame_length", 25))
        shift_ms = float(audio_cfg.get("frame_shift", 10))
        self.sample_rate = sr
        self.n_fft = int(sr * frame_ms / 1000)
        self.hop = int(sr * shift_ms / 1000)
        self.n_bins = self.n_fft // 2 + 1
        self.delta_order = int(audio_cfg.get("delta_order", 0))
        self.delta_window = int(audio_cfg.get("delta_window_size", 2))
        self.apply_cmvn = bool(audio_cfg.get("cmvn", True))

        n = np.arange(self.n_fft)
        window = (0.5 - 0.5 * np.cos(2.0 * np.pi * n / self.n_fft)).astype(np.float32)
        cos_m, msin_m = dft_matrices(self.n_fft)

        def buf(name, a):
            self.register_buffer(name, torch.tensor(a, device=device),
                                 persistent=False)

        buf("cosw", cos_m * window[:, None])
        buf("msinw", msin_m * window[:, None])
        if self.feat_type in ("fbank", "mfcc"):
            n_mels = self.num_feat if self.feat_type == "fbank" else int(
                audio_cfg.get("n_mels", max(self.num_feat, 40)))
            buf("mel_fb", melscale_fbanks(self.n_bins, n_mels, sr))
        if self.feat_type == "mfcc":
            buf("dct", dct_matrix(self.mel_fb.shape[1], self.num_feat))
        if self.feat_type == "linear":
            self.num_feat = self.n_bins
        if self.feat_type not in ("fbank", "mfcc", "linear"):
            raise NotImplementedError(self.feat_type)
        self.feat_dim = self.num_feat * (1 + self.delta_order)
        buf("dfilt", delta_filter(self.delta_window))
        # the JAX package's gate; its "non-CPU backend" part is the wave's
        # device, decided in forward before any launch
        use_pallas = audio_cfg.get("use_pallas", "auto")
        if use_pallas == "auto":
            use_pallas = (self.feat_type == "fbank" and self.n_fft % 80 == 0
                          and self.hop % 80 == 0)
        self.use_kernel = bool(use_pallas) and self.feat_type == "fbank"

    def _power_spec(self, wav: torch.Tensor) -> torch.Tensor:
        return power_spectrum(wav, self.cosw, self.msinw, self.n_fft, self.hop)

    def _deltas(self, feat: torch.Tensor) -> torch.Tensor:
        """Concat [feat, delta, delta2, ...] along D (replicate pad in time)."""
        outs = [feat]
        cur = feat
        w = self.delta_window
        T = feat.shape[1]
        for _ in range(self.delta_order):
            padded = F.pad(cur.transpose(1, 2), (w, w), mode="replicate"
                           ).transpose(1, 2)
            cur = sum(self.dfilt[j] * padded[:, j:j + T]
                      for j in range(2 * w + 1))
            outs.append(cur)
        return torch.cat(outs, dim=-1)

    def _cmvn(self, feat: torch.Tensor, feat_len: torch.Tensor) -> torch.Tensor:
        """Per-utterance mean/var over valid frames only."""
        T = feat.shape[1]
        mask = (torch.arange(T, device=feat.device)[None, :]
                < feat_len[:, None])[..., None]
        cnt = torch.clamp(feat_len, min=1)[:, None, None].to(feat.dtype)
        mean = torch.sum(feat * mask, dim=1, keepdim=True) / cnt
        var = torch.sum((feat - mean) ** 2 * mask, dim=1, keepdim=True) / cnt
        return torch.where(mask, (feat - mean) * torch.rsqrt(var + 1e-10),
                           torch.zeros((), dtype=feat.dtype, device=feat.device))

    def forward(self, waveform: torch.Tensor, wave_len: torch.Tensor):
        if waveform.dtype == torch.int16:
            # i/32768 with |i| <= 32768 is exact in f32: bit-identical to the
            # float path for PCM16 sources
            waveform = waveform.to(torch.float32) * (1.0 / 32768.0)
        pad = self.n_fft // 2
        if waveform.shape[1] <= pad:
            # reflect padding needs S > pad: zero-extend sub-window clips
            waveform = F.pad(waveform, (0, pad + 1 - waveform.shape[1]))
        if self.feat_type == "fbank":
            fbank = (fbank_fused if self.use_kernel and waveform.is_cuda
                     and cuda_kernels.USE_KERNELS else fbank_plain)
            feat = fbank(waveform.contiguous(), self.cosw, self.msinw,
                         self.mel_fb, n_fft=self.n_fft, hop=self.hop,
                         log_eps=LOG_EPS)
        elif self.feat_type == "mfcc":
            spec = self._power_spec(waveform)
            logmel = torch.log(torch.matmul(spec, self.mel_fb) + LOG_EPS)
            feat = torch.matmul(logmel, self.dct)
        else:
            feat = torch.log(self._power_spec(waveform) + LOG_EPS)
        return self._postprocess(feat, wave_len)

    def _postprocess(self, feat, wave_len):
        T = feat.shape[1]
        feat_len = torch.clamp(
            (wave_len.to(feat.device, torch.int64) // self.hop + 1),
            max=T).to(torch.int32)
        if self.delta_order > 0:
            feat = self._deltas(feat)
        if self.apply_cmvn:
            feat = self._cmvn(feat, feat_len)
        else:
            mask = (torch.arange(T, device=feat.device)[None, :]
                    < feat_len[:, None])[..., None]
            feat = torch.where(mask, feat, torch.zeros((), device=feat.device))
        return feat, feat_len


def create_transform(audio_cfg: Dict[str, Any], device=None
                     ) -> Tuple[AudioFrontend, int]:
    """Returns the feature pipeline and its output feature dimension."""
    fe = AudioFrontend(audio_cfg, device=device)
    return fe, fe.feat_dim
