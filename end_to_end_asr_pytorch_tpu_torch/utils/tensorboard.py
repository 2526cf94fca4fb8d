"""TensorBoard event files, written and read with no package behind them.

``SummaryWriter`` writes what ``tensorboardX.SummaryWriter`` writes for the
three calls the JAX package's ``BaseSolver.write_log`` makes:
- ``add_scalars(main, {k: v}, step)``: one sub-run directory
  ``<logdir>/<main>/<k>/`` a key, each value tagged ``main`` as a
  ``simple_value``;
- ``add_text(name, s, step)``: tag ``name/text_summary``, the text plugin's
  metadata, a one-element string tensor;
- ``add_figure(name, img, step)``: an image summary holding the PNG of an
  (H, W, 3) uint8 array (``utils/util.feat_to_fig``'s heatmap), where the
  JAX package renders a matplotlib figure.

An event file (``events.out.tfevents.<seconds>.<host>``) is a sequence of
TFRecords: the length as a little-endian u64, the masked CRC32C of those 8
bytes, the data, the masked CRC32C of the data. The data is an ``Event``
protocol buffer, encoded here by hand (proto3: fields in number order,
zero values left out); the first one carries ``file_version``. Files are
flushed every ``flush_secs`` seconds, at the next write after that, and on
``close``.

``read_events`` reads a file back, checking every CRC, for the checks that
cannot import tensorboard.
"""
from __future__ import annotations

import os
import re
import socket
import struct
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from .png import encode_png


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), table-driven."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: rotated right by 15, plus 0xa282ead8."""
    x = crc32c(data)
    return (((x >> 15) | (x << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def record(data: bytes) -> bytes:
    """One TFRecord around ``data``."""
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header)) + data
            + struct.pack("<I", masked_crc32c(data)))


# -------------------------------------------------- protocol buffer writing
def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _len_field(field: int, data: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(data)) + data


def _int_field(field: int, n: int) -> bytes:
    return _varint(field << 3) + _varint(n) if n else b""


_INVALID_TAG_CHARACTERS = re.compile(r"[^-/\w\.]")


def clean_tag(name: str) -> str:
    """tensorboardX's tag cleaning: characters other than ``-/\\w.`` become
    ``_`` and leading slashes go."""
    return _INVALID_TAG_CHARACTERS.sub("_", name).lstrip("/")


def scalar_value(tag: str, value: float) -> bytes:
    """A ``Summary.Value`` with ``simple_value`` (a float32; a member of
    the value oneof, so written when zero too)."""
    return (_len_field(1, clean_tag(tag).encode()) + _varint(2 << 3 | 5)
            + struct.pack("<f", float(value)))


def text_value(tag: str, text: str) -> bytes:
    """A ``Summary.Value`` of the text plugin: tag ``<tag>/text_summary``,
    a DT_STRING tensor of shape (1,)."""
    shape = _len_field(2, _int_field(1, 1))               # dim { size: 1 }
    tensor = (_int_field(1, 7) + _len_field(2, shape)     # DT_STRING
              + _len_field(8, text.encode("utf-8")))
    metadata = _len_field(1, _len_field(1, b"text"))      # plugin_name
    return (_len_field(1, f"{tag}/text_summary".encode())
            + _len_field(8, tensor) + _len_field(9, metadata))


def image_value(tag: str, img: np.ndarray) -> bytes:
    """A ``Summary.Value`` with an ``Image`` of an (H, W, C) uint8 array,
    PNG-encoded."""
    h, w, c = img.shape
    image = (_int_field(1, h) + _int_field(2, w) + _int_field(3, c)
             + _len_field(4, encode_png(img)))
    return _len_field(1, clean_tag(tag).encode()) + _len_field(4, image)


def event(wall_time: float, step: Optional[int] = None,
          values: Optional[List[bytes]] = None,
          file_version: Optional[str] = None) -> bytes:
    """An ``Event``: wall_time, step, file_version or a summary of
    ``values``."""
    out = _varint(1 << 3 | 1) + struct.pack("<d", wall_time)
    out += _int_field(2, int(step or 0))
    if file_version:
        out += _len_field(3, file_version.encode())
    if values:
        out += _len_field(5, b"".join(_len_field(1, v) for v in values))
    return out


class EventFileWriter:
    """One event file in ``logdir``, opened at construction with its
    ``file_version`` event."""

    def __init__(self, logdir, flush_secs: float = 120):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self.path = self.logdir / (f"events.out.tfevents."
                                   f"{str(time.time())[:10]}."
                                   f"{socket.gethostname()}")
        self.flush_secs = flush_secs
        self._f = open(self.path, "ab")
        self._last_flush = time.time()
        self.write(event(time.time(), file_version="brain.Event:2"))

    def write(self, data: bytes) -> None:
        self._f.write(record(data))
        if time.time() - self._last_flush >= self.flush_secs:
            self.flush()

    def add(self, values: List[bytes], step: Optional[int] = None,
            walltime: Optional[float] = None) -> None:
        self.write(event(time.time() if walltime is None else walltime,
                         step, values))

    def flush(self) -> None:
        self._f.flush()
        self._last_flush = time.time()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class SummaryWriter:
    """The part of ``tensorboardX.SummaryWriter`` the solvers use; its
    main event file is made at construction, as tensorboardX's is."""

    def __init__(self, logdir, flush_secs: float = 120):
        self.logdir = str(logdir)
        self.flush_secs = flush_secs
        self.file_writer = EventFileWriter(self.logdir, flush_secs)
        self.all_writers: Dict[str, EventFileWriter] = {
            self.logdir: self.file_writer}

    def add_scalars(self, main_tag: str, tag_scalar_dict: Dict[str, float],
                    global_step: Optional[int] = None,
                    walltime: Optional[float] = None) -> None:
        walltime = time.time() if walltime is None else walltime
        for tag, value in tag_scalar_dict.items():
            fw_tag = os.path.join(self.logdir, main_tag, tag)
            if fw_tag not in self.all_writers:
                self.all_writers[fw_tag] = EventFileWriter(fw_tag,
                                                           self.flush_secs)
            self.all_writers[fw_tag].add([scalar_value(main_tag, value)],
                                         global_step, walltime)

    def add_text(self, tag: str, text: str,
                 global_step: Optional[int] = None,
                 walltime: Optional[float] = None) -> None:
        self.file_writer.add([text_value(tag, text)], global_step, walltime)

    def add_figure(self, tag: str, img: np.ndarray,
                   global_step: Optional[int] = None,
                   walltime: Optional[float] = None) -> None:
        """An (H, W, 3) uint8 image, as ``add_figure`` logs a rendered
        figure."""
        self.file_writer.add([image_value(tag, np.asarray(img, np.uint8))],
                             global_step, walltime)

    def close(self) -> None:
        for w in self.all_writers.values():
            w.flush()
            w.close()


# -------------------------------------------------------------- reading
def read_records(path) -> Iterator[bytes]:
    """The data of each TFRecord in ``path``; a CRC mismatch or a cut
    record raises ``ValueError``."""
    with open(path, "rb") as f:
        buf = f.read()
    pos = 0
    while pos < len(buf):
        if pos + 12 > len(buf):
            raise ValueError(f"{path}: cut record header at byte {pos}")
        header = buf[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", buf[pos + 8:pos + 12])
        if crc != masked_crc32c(header):
            raise ValueError(f"{path}: length CRC mismatch at byte {pos}")
        data = buf[pos + 12:pos + 12 + n]
        if len(data) != n or pos + 16 + n > len(buf):
            raise ValueError(f"{path}: cut record at byte {pos}")
        (crc,) = struct.unpack("<I", buf[pos + 12 + n:pos + 16 + n])
        if crc != masked_crc32c(data):
            raise ValueError(f"{path}: data CRC mismatch at byte {pos}")
        yield data
        pos += 16 + n


def _fields(data: bytes) -> Dict[int, List[Any]]:
    """{field number: [values]} of one protocol buffer message: varints as
    ints, fixed64 / fixed32 as raw 8 / 4 bytes, length-delimited as
    bytes."""
    out: Dict[int, List[Any]] = {}
    pos = 0

    def varint():
        nonlocal pos
        n = shift = 0
        while True:
            b = data[pos]
            pos += 1
            n |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return n

    while pos < len(data):
        key = varint()
        field, wire = key >> 3, key & 7
        if wire == 0:
            val = varint()
        elif wire == 1:
            val, pos = data[pos:pos + 8], pos + 8
        elif wire == 5:
            val, pos = data[pos:pos + 4], pos + 4
        elif wire == 2:
            n = varint()
            val, pos = data[pos:pos + n], pos + n
        else:
            raise ValueError(f"protobuf: wire type {wire} not supported")
        out.setdefault(field, []).append(val)
    return out


def _summary_value(data: bytes) -> Dict[str, Any]:
    f = _fields(data)
    v: Dict[str, Any] = {"tag": f.get(1, [b""])[0].decode()}
    if 2 in f:
        v["simple_value"] = struct.unpack("<f", f[2][0])[0]
    if 4 in f:
        im = _fields(f[4][0])
        v["image"] = {"height": im.get(1, [0])[0], "width": im.get(2, [0])[0],
                      "colorspace": im.get(3, [0])[0],
                      "png": im.get(4, [b""])[0]}
    if 8 in f:
        t = _fields(f[8][0])
        v["tensor"] = {"dtype": t.get(1, [0])[0],
                       "string_val": [s.decode() for s in t.get(8, [])]}
    if 9 in f:
        md = _fields(f[9][0])
        if 1 in md:
            v["plugin"] = _fields(md[1][0]).get(1, [b""])[0].decode()
    return v


def parse_event(data: bytes) -> Dict[str, Any]:
    """An ``Event``'s wall_time, step, file_version and summary values."""
    f = _fields(data)
    ev: Dict[str, Any] = {
        "wall_time": struct.unpack("<d", f[1][0])[0] if 1 in f else 0.0,
        "step": f.get(2, [0])[0]}
    if 3 in f:
        ev["file_version"] = f[3][0].decode()
    if 5 in f:
        ev["values"] = [_summary_value(v)
                        for v in _fields(f[5][0]).get(1, [])]
    return ev


def read_events(path) -> List[Dict[str, Any]]:
    """Every event of one event file, CRCs checked (``parse_event``)."""
    return [parse_event(d) for d in read_records(path)]
