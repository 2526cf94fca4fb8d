"""Zstandard decompression for the orbax directories the JAX package
writes (``utils/ocdbt.py``, ``utils/orbax.py``), with no zstd package: the
binding of the port's own decoder, ``native/zstd_decoder.cc`` (RFC 8878,
decompression only, content checksums verified, dictionaries refused).

The source is compiled with ``g++`` at first use into
``build/torch_native/`` as ``utils/native.py`` compiles the FLAC decoder:
nothing is built at import time, and there is no fallback. A missing
compiler, a failed build or a library that does not load raises
``RuntimeError``; data that does not decode raises ``ValueError`` with the
decoder's reason.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

from . import native

SOURCE = Path(__file__).resolve().parents[1] / "native" / "zstd_decoder.cc"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_Bytes = ctypes.POINTER(ctypes.c_uint8)


def get_lib() -> ctypes.CDLL:
    """The loaded decoder library with its signatures."""
    global _lib
    with _lock:
        if _lib is None:
            lib = native.load(SOURCE, "zstd decoder")
            lib.zstd_decompress.restype = ctypes.c_int
            lib.zstd_decompress.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(_Bytes),
                ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p,
                ctypes.c_size_t]
            lib.zstd_free.restype = None
            lib.zstd_free.argtypes = [_Bytes]
            lib.zstd_xxh64.restype = ctypes.c_uint64
            lib.zstd_xxh64.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                       ctypes.c_uint64]
            _lib = lib
        return _lib


def decompress(data: bytes) -> bytes:
    """The concatenated content of the zstd frames in ``data`` (skippable
    frames skipped)."""
    lib = get_lib()
    data = bytes(data)
    out, n = _Bytes(), ctypes.c_size_t()
    err = ctypes.create_string_buffer(256)
    if lib.zstd_decompress(data, len(data), ctypes.byref(out),
                           ctypes.byref(n), err, len(err)) != 0:
        raise ValueError(f"zstd: {err.value.decode()}")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.zstd_free(out)


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data``, the hash behind a frame's content checksum."""
    data = bytes(data)
    return int(get_lib().zstd_xxh64(data, len(data), seed))
