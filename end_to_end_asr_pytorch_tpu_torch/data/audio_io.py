"""Waveform file readers: WAV (numpy parser), NPY and FLAC (the host C++
decoder, ``data/flac.py``)."""
from __future__ import annotations

import os
import struct
from pathlib import Path

import numpy as np

from .flac import read_flac


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Returns (mono float32 waveform in [-1, 1], sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"not a RIFF/WAVE file: {path}")
    pos = 12
    fmt = None
    wave = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8: pos + 8 + size]
        if cid == b"fmt ":
            (audio_fmt, n_ch, sr, _, _, bits) = struct.unpack_from("<HHIIHH", body, 0)
            fmt = (audio_fmt, n_ch, sr, bits)
        elif cid == b"data":
            wave = body
        pos += 8 + size + (size & 1)
    if fmt is None or wave is None:
        raise ValueError(f"missing fmt/data chunk: {path}")
    audio_fmt, n_ch, sr, bits = fmt
    if audio_fmt == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(wave, "<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(wave, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            raw = np.frombuffer(wave, np.uint8).reshape(-1, 3)
            x = ((raw[:, 0].astype(np.int32)) | (raw[:, 1].astype(np.int32) << 8)
                 | (raw[:, 2].astype(np.int32) << 16))
            x = (x << 8 >> 8).astype(np.float32) / 8388608.0
        elif bits == 8:
            x = (np.frombuffer(wave, np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported PCM bits: {bits}")
    elif audio_fmt == 3:  # IEEE float
        if bits == 32:
            x = np.frombuffer(wave, "<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(wave, "<f8").astype(np.float32)
        else:
            raise ValueError(f"unsupported float WAV bits: {bits}")
    else:
        raise ValueError(f"unsupported WAV format code: {audio_fmt}")
    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    return x, sr


def write_wav(path: str, wave: np.ndarray, sr: int = 16000) -> None:
    """PCM16 mono writer."""
    x = np.clip(np.asarray(wave, np.float32), -1.0, 1.0)
    pcm = np.round(x * 32767.0).astype("<i2").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
    hdr += b"data" + struct.pack("<I", len(pcm))
    with open(path, "wb") as f:
        f.write(hdr + pcm)


def num_samples(path: str) -> int | None:
    """The length ``load_audio`` returns, read from the file's header
    without decoding: a WAV's data chunk over its frame size, a FLAC
    STREAMINFO's total samples, an NPY's shape. ``None`` when the header
    does not say (a FLAC stream of unknown length)."""
    suffix = Path(path).suffix.lower()
    if suffix == ".npy":
        return int(np.load(path, mmap_mode="r").shape[0])
    with open(path, "rb") as f:
        if suffix == ".flac":
            head = f.read(42)
            if len(head) < 42 or head[:4] != b"fLaC" or head[4] & 0x7F:
                return None
            si = head[8:]
            n = ((si[13] & 0xF) << 32) | int.from_bytes(si[14:18], "big")
            return n or None
        head = f.read(12)
        if suffix != ".wav" or head[:4] != b"RIFF" or head[8:] != b"WAVE":
            raise ValueError(f"unsupported audio format: {path}")
        end = os.fstat(f.fileno()).st_size
        pos, frame, size = 12, None, None
        while pos + 8 <= end:
            f.seek(pos)
            hdr = f.read(24)
            cid, n = hdr[:4], struct.unpack_from("<I", hdr, 4)[0]
            if cid == b"fmt ":
                _, n_ch, _, _, _, bits = struct.unpack_from("<HHIIHH", hdr, 8)
                frame = n_ch * (bits // 8)
            elif cid == b"data":
                size = min(n, end - pos - 8)
            pos += 8 + n + (n & 1)
    if frame is None or size is None:
        raise ValueError(f"missing fmt/data chunk: {path}")
    return size // frame


def load_audio(path: str) -> tuple[np.ndarray, int]:
    """Dispatch by extension."""
    suffix = Path(path).suffix.lower()
    if suffix == ".wav":
        return read_wav(path)
    if suffix == ".npy":
        return np.load(path).astype(np.float32), 16000
    if suffix == ".flac":
        return read_flac(path)
    raise ValueError(f"unsupported audio format: {path}")
