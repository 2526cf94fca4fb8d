"""K1: fused log-mel filterbank — wrapper for ``csrc/fbank.cu`` and its plain
PyTorch version.

Replaces ``end_to_end_asr_pytorch_tpu/ops/pallas/fbank_kernel.py:fbank_fused``
(center reflect pad, framing, windowed DFT as cos/-sin products, power, mel
product, ``log(mel + eps)``, all at f32 accuracy). On the H100 the work is
bound by operations (~0.34 MFLOP per frame against ~0.6 KB of audio). The
kernel runs the DFT as one GEMM per 64-frame tile on the bf16 tensor cores
in six passes of a three-part split, as the TPU kernel's
``Precision.HIGHEST`` does on its matrix unit, keeps frames, spectra and
power on chip, and writes only the log-mel output (see the note at the top
of the CUDA source).

Plain helpers that spell out the kernel's arithmetic and layout, for the
CPU tests: ``split_power_spectrum`` (the six-pass split product over the
interleaved cos/-sin matrix, ``interleave_dft``) and ``span_frames`` (frames
gathered through the kernel's padded span layout, ``span_layout``).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import build
from .scan_tc import split3

SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
SUB = 80             # n_fft and hop must be multiples of it (the TPU gate)
TILE = 64            # frames per block of the kernel
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fbank_smem_bytes": (ctypes.c_size_t, [_I, _I, _I, _I]),
    "fbank_scratch_bytes": (ctypes.c_size_t, [_I, _I, _I]),
    "fbank_launch": (_I, [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, ctypes.c_float, _P]),
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


def interleave_dft(cosw: torch.Tensor, msinw: torch.Tensor) -> torch.Tensor:
    """(n_fft, n_bins) cos and -sin -> (n_fft, 2 n_bins), column 2j = cos_j,
    2j + 1 = -sin_j: the kernel's B operand, so one accumulator tile holds
    re and im of the same bins."""
    return torch.stack([cosw, msinw], dim=-1).reshape(cosw.shape[0], -1)


def split_power_spectrum(wave: torch.Tensor, cosw: torch.Tensor,
                         msinw: torch.Tensor, n_fft: int,
                         hop: int) -> torch.Tensor:
    """The power spectrum as the kernel computes it: frames and the
    interleaved DFT matrix split into bf16 hi / mid / lo (``split3``), the
    six products of parts exact in f32 and summed in f32, hi . hi in one sum
    and mid . hi + lo . hi + hi . mid + mid . mid + hi . lo in another, re
    and im the two sums added."""
    fh, fm, fl = (p.float() for p in split3(frame_signal(wave, n_fft, hop)))
    dh, dm, dl = (p.float() for p in split3(interleave_dft(cosw, msinw)))
    small = fm @ dh + fl @ dh + fh @ dm + fm @ dm + fh @ dl
    y = fh @ dh + small
    re, im = y[..., 0::2], y[..., 1::2]
    return re * re + im * im


def fbank_split_plain(wave: torch.Tensor, cosw: torch.Tensor,
                      msinw: torch.Tensor, mel_fb: torch.Tensor, *,
                      n_fft: int, hop: int, log_eps: float) -> torch.Tensor:
    """``fbank_plain`` with the kernel's six-pass split DFT product."""
    power = split_power_spectrum(wave, cosw, msinw, n_fft, hop)
    return torch.log(torch.matmul(power, mel_fb) + log_eps)


def span_layout(n_fft: int, hop: int) -> Tuple[int, int]:
    """(rows, row stride) of a tile's waveform span in the kernel's shared
    memory: TILE - 1 + ceil(n_fft / hop) rows of hop samples, each padded to
    hop + 8 bf16 (an odd number of 16-byte units, so the 8 frame rows of an
    ldmatrix phase hit distinct banks)."""
    return TILE - 1 + -(-n_fft // hop), hop + 8


def reflect_index(p: torch.Tensor, S: int, pad: int) -> torch.Tensor:
    """The wave sample behind index ``p`` of the center reflect-padded
    signal (the kernel's index arithmetic; requires S > pad)."""
    q = p - pad
    q = torch.where(q < 0, -q, q)
    return torch.where(q >= S, 2 * (S - 1) - q, q)


def span_frames(wave: torch.Tensor, n_fft: int, hop: int,
                t0: int) -> torch.Tensor:
    """Frames t0 .. t0 + TILE - 1 of each row of ``wave`` (B, S), gathered as
    the kernel gathers them: the span staged as rows of hop samples (zero
    past the padded signal; the row padding holds NaN, which no frame may
    read), frame f, sample n at row f + n // hop, column n % hop."""
    B, S = wave.shape
    pad = n_fft // 2
    rows, rs = span_layout(n_fft, hop)
    r = torch.arange(rows)[:, None]
    c = torch.arange(rs)[None, :]
    p = (t0 + r) * hop + c
    inside = (p < S + 2 * pad) & (c < hop)
    idx = reflect_index(p, S, pad).clamp(0, S - 1)
    span = torch.where(inside, wave[:, idx], torch.zeros(()))
    span = torch.where(c < hop, span, torch.full((), float("nan")))
    f = torch.arange(TILE)[:, None]
    n = torch.arange(n_fft)[None, :]
    return span[:, f + n // hop, n % hop]


def fbank_fused(wave: torch.Tensor, cosw: torch.Tensor, msinw: torch.Tensor,
                mel_fb: torch.Tensor, *, n_fft: int, hop: int,
                log_eps: float) -> torch.Tensor:
    """wave (B, S) f32 -> log-mel (B, T, n_mels) f32.

    cosw / msinw are the window-premultiplied DFT matrices (n_fft, n_bins),
    mel_fb the filterbank (n_bins, n_mels). CPU tensors take the plain
    version (any geometry); CUDA tensors launch the kernel, which needs
    n_fft and hop to be multiples of 80 (the TPU kernel's own assert) and
    raises otherwise."""
    if wave.device.type == "cpu":
        return fbank_plain(wave, cosw, msinw, mel_fb, n_fft=n_fft, hop=hop,
                           log_eps=log_eps)
    if wave.device.type != "cuda":
        raise ValueError(f"fbank_fused: unsupported device {wave.device}")
    if n_fft % SUB or hop % SUB:
        raise ValueError(f"fbank_fused: n_fft={n_fft} and hop={hop} must be "
                         f"multiples of {SUB}")
    B, S = wave.shape
    n_bins, n_mels = mel_fb.shape
    pad = n_fft // 2
    build.check_inputs("fbank_fused", wave,
                       ("wave", wave, (B, S), torch.float32),
                       ("cosw", cosw, (n_fft, n_bins), torch.float32),
                       ("msinw", msinw, (n_fft, n_bins), torch.float32),
                       ("mel_fb", mel_fb, (n_bins, n_mels), torch.float32))
    if S <= pad:
        raise ValueError(f"fbank_fused: need more than {pad} samples, got {S}")
    T = (S + 2 * pad - n_fft) // hop + 1
    lib = build.load("fbank", _SIGNATURES)
    if lib.fbank_smem_bytes(n_fft, hop, n_bins, n_mels) > SMEM_LIMIT:
        raise ValueError(f"fbank_fused: n_fft={n_fft}, hop={hop}, "
                         f"n_mels={n_mels} need more shared memory than a "
                         "block has")
    out = torch.empty((B, T, n_mels), dtype=torch.float32, device=wave.device)
    scratch = torch.empty(lib.fbank_scratch_bytes(n_fft, n_bins, n_mels),
                          dtype=torch.uint8, device=wave.device)
    stream = torch.cuda.current_stream(wave.device).cuda_stream
    rc = lib.fbank_launch(wave.data_ptr(), B, S, pad, cosw.data_ptr(),
                          msinw.data_ptr(), mel_fb.data_ptr(),
                          scratch.data_ptr(), out.data_ptr(), T, n_fft, hop,
                          n_bins, n_mels, log_eps, stream)
    build.check(rc, "fbank_fused launch")
    fbank_fused.launches += 1
    return out


fbank_fused.launches = 0
