"""FLAC decoding through the host C++ decoder (``utils/native.py``), the
port's copy of the JAX package's ``data/flac_native.py``."""
from __future__ import annotations

import ctypes

import numpy as np

from ..utils import native


def read_flac(path: str) -> tuple[np.ndarray, int]:
    """Returns (mono float32 waveform in [-1, 1], sample_rate); channels are
    averaged. A stream the decoder refuses raises ``ValueError`` with its
    return code."""
    lib = native.get_lib()
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    sr = ctypes.c_int32()
    ch = ctypes.c_int32()
    try:
        rc = lib.flac_decode(str(path).encode(), ctypes.byref(out),
                             ctypes.byref(n), ctypes.byref(sr),
                             ctypes.byref(ch))
        if rc != 0:
            raise ValueError(f"flac_decode failed (rc={rc}) for {path}")
        total = n.value * ch.value
        buf = (np.ctypeslib.as_array(out, shape=(total,)).copy() if total
               else np.zeros(0, np.float32))
    finally:
        if out:
            lib.flac_free(out)
    wave = buf.reshape(-1, ch.value).mean(axis=1) if ch.value > 1 else buf
    return wave.astype(np.float32), int(sr.value)
