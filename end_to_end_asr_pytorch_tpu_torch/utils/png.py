"""A PNG encoder for 8-bit RGB images, stdlib only: the figures that
``utils/tensorboard.py`` writes into image summaries."""
from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode_png(img) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (colour type 2, no filter on any row,
    zlib level 6)."""
    a = np.asarray(img)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3 or 0 in a.shape:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got {a.shape} "
                         f"{a.dtype}")
    h, w, _ = a.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(a).reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def png_size(data: bytes) -> Tuple[int, int]:
    """(height, width) from a PNG's IHDR chunk, its CRC checked."""
    if data[:8] != SIGNATURE or data[12:16] != b"IHDR":
        raise ValueError("not a PNG: no signature and IHDR chunk")
    n = struct.unpack(">I", data[8:12])[0]
    body = data[12:16 + n]
    if struct.unpack(">I", data[16 + n:20 + n])[0] != zlib.crc32(body):
        raise ValueError("PNG: IHDR CRC mismatch")
    w, h = struct.unpack(">II", body[4:12])
    return h, w
