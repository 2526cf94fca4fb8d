"""K1: fused log-mel filterbank — wrapper for ``csrc/fbank.cu`` and its plain
PyTorch version.

Replaces ``end_to_end_asr_pytorch_tpu/ops/pallas/fbank_kernel.py:fbank_fused``
(center reflect pad, framing, windowed DFT as cos/-sin products, power, mel
product, ``log(mel + eps)``, all full f32). On the H100 the work is bound by
f32 operations (~0.34 MFLOP per frame against ~0.6 KB of audio); the kernel
keeps frames, spectra and power on chip and writes only the log-mel output
(see the note at the top of the CUDA source).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fbank_smem_bytes": (ctypes.c_size_t, [_I, _I, _I]),
    "fbank_launch": (_I, [_P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          ctypes.c_float, _P]),
}


def frame_signal(wave: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, S) -> (B, T, n_fft) frames of the center reflect-padded signal,
    T = (S + 2*(n_fft//2) - n_fft) // hop + 1. Requires S > n_fft // 2."""
    pad = n_fft // 2
    wp = F.pad(wave[:, None, :], (pad, pad), mode="reflect")[:, 0]
    return wp.unfold(1, n_fft, hop)


def power_spectrum(wave: torch.Tensor, cosw: torch.Tensor,
                   msinw: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, S) -> (B, T, n_bins) power of the windowed DFT of each frame."""
    frames = frame_signal(wave, n_fft, hop)
    re = torch.matmul(frames, cosw)
    im = torch.matmul(frames, msinw)
    return re * re + im * im


def fbank_plain(wave: torch.Tensor, cosw: torch.Tensor, msinw: torch.Tensor,
                mel_fb: torch.Tensor, *, n_fft: int, hop: int,
                log_eps: float) -> torch.Tensor:
    """Plain version of the kernel: the same function in PyTorch ops."""
    power = power_spectrum(wave, cosw, msinw, n_fft, hop)
    return torch.log(torch.matmul(power, mel_fb) + log_eps)


def fbank_fused(wave: torch.Tensor, cosw: torch.Tensor, msinw: torch.Tensor,
                mel_fb: torch.Tensor, *, n_fft: int, hop: int,
                log_eps: float) -> torch.Tensor:
    """wave (B, S) f32 -> log-mel (B, T, n_mels) f32.

    cosw / msinw are the window-premultiplied DFT matrices (n_fft, n_bins),
    mel_fb the filterbank (n_bins, n_mels). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if wave.device.type == "cpu":
        return fbank_plain(wave, cosw, msinw, mel_fb, n_fft=n_fft, hop=hop,
                           log_eps=log_eps)
    if wave.device.type != "cuda":
        raise ValueError(f"fbank_fused: unsupported device {wave.device}")
    B, S = wave.shape
    n_bins, n_mels = mel_fb.shape
    pad = n_fft // 2
    for name, t, shape in (("wave", wave, (B, S)), ("cosw", cosw, (n_fft, n_bins)),
                           ("msinw", msinw, (n_fft, n_bins)),
                           ("mel_fb", mel_fb, (n_bins, n_mels))):
        if (t.device != wave.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"fbank_fused: {name} must be a contiguous f32 "
                             f"{shape} tensor on {wave.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if S <= pad:
        raise ValueError(f"fbank_fused: need more than {pad} samples, got {S}")
    T = (S + 2 * pad - n_fft) // hop + 1
    lib = build.load("fbank", _SIGNATURES)
    if lib.fbank_smem_bytes(n_fft, hop, n_bins) > SMEM_LIMIT:
        raise ValueError(f"fbank_fused: n_fft={n_fft}, hop={hop} need more "
                         "shared memory than a block has")
    out = torch.empty((B, T, n_mels), dtype=torch.float32, device=wave.device)
    stream = torch.cuda.current_stream(wave.device).cuda_stream
    rc = lib.fbank_launch(wave.data_ptr(), B, S, pad, cosw.data_ptr(),
                          msinw.data_ptr(), mel_fb.data_ptr(), out.data_ptr(),
                          T, n_fft, hop, n_bins, n_mels, log_eps, stream)
    build.check(rc, "fbank_fused launch")
    fbank_fused.launches += 1
    return out


fbank_fused.launches = 0
