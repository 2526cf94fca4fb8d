"""Checkpoints the JAX package wrote, read without JAX or flax, and the
format sniffing that ``--load`` and ``decode.lm_path`` go through.

The JAX package's native file (its ``utils/checkpoint.py``): an 8-byte
little-endian header length, a JSON header (``global_step``, ``metrics``,
``model_bytes``, ``opt_bytes``), then the model's and the optimizer's
``flax.serialization.to_bytes`` blobs. A blob is msgpack: the parameter tree
as nested maps (a NamedTuple by field name, a tuple or list by ``"0"``,
``"1"``, ...; ``None`` as nil; an optax ``EmptyState`` as an empty map),
each array as msgpack extension type 1 whose payload is itself msgpack
``(shape, dtype name, C-order bytes)`` (type 3: a numpy scalar the same
way). The decoder below covers the msgpack format in full, since the
card's machine is not promised the ``msgpack`` package. The restored
tree's paths are the JAX parameter-tree paths, which ``utils/weights.py``
maps onto the port's modules; the optimizer's blob is optax's state tree,
which ``utils/optax_state.py`` maps onto the port's optimizer.

``load_checkpoint`` sniffs the format as the JAX package's does: a torch
pickle (zip archive or a bare pickle stream) goes to ``utils/torch_ckpt``,
a native file to the reader here, and a directory to ``utils/orbax.py``
(the orbax layout the port writes, and the JAX package's own OCDBT,
zstd-compressed directories). A missing path first
promotes a complete ``.tmp`` / ``.old`` sibling that an interrupted orbax
save left (``orbax.recover_sibling``).
"""
from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch.nn as nn

from ..models.lm import RNNLM
from .optax_state import from_optax
from .orbax import read_orbax, recover_sibling
from .torch_ckpt import load_lm_checkpoint, load_torch_checkpoint
from .weights import load_arrays


class _Reader:
    """A msgpack decoder over one bytes object."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {0xC4: "B", 0xC5: "H", 0xC6: "I"}            # bin
        if b in sized:
            return self.take(self.unpack(sized[b]))
        ext = {0xC7: "B", 0xC8: "H", 0xC9: "I"}
        if b in ext:
            n = self.unpack(ext[b])
            return _ext(self.unpack("b"), self.take(n))
        num = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
               0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in num:
            return self.unpack(num[b])
        if 0xD4 <= b <= 0xD8:                                 # fixext 1..16
            code = self.unpack("b")
            return _ext(code, self.take(1 << (b - 0xD4)))
        strs = {0xD9: "B", 0xDA: "H", 0xDB: "I"}
        if b in strs:
            return self.take(self.unpack(strs[b])).decode("utf-8")
        if b in (0xDC, 0xDD):
            n = self.unpack("H" if b == 0xDC else "I")
            return [self.value() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack("H" if b == 0xDE else "I"))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def msgpack_unpack(data: bytes) -> Any:
    """Decode one msgpack object (extension types as flax writes them)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError("msgpack: trailing bytes")
    return out


def _ext(code: int, payload: bytes) -> Any:
    """flax's extension types: 1 an ndarray, 3 a numpy scalar."""
    if code not in (1, 3):
        raise ValueError(f"msgpack: unknown extension type {code}")
    shape, dtype, buf = msgpack_unpack(payload)
    a = np.frombuffer(buf, np.dtype(dtype)).reshape(shape)
    return a if code == 1 else a[()]


def read_native(path: str) -> Dict[str, Any]:
    """The JAX package's native checkpoint: {'model': tree, 'optimizer':
    the optax state's tree (None when the file holds none),
    'global_step'}."""
    with open(path, "rb") as f:
        hlen = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(hlen).decode())
        model_b = f.read(header["model_bytes"])
        opt_b = f.read(header.get("opt_bytes", 0))
    return {"model": msgpack_unpack(model_b),
            "optimizer": msgpack_unpack(opt_b) if opt_b else None,
            "global_step": int(header["global_step"])}


def tree_arrays(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """{dotted path: array} of a restored tree, None leaves and empty
    nodes dropped: the JAX path ``encoder.layers[0].fwd.w_ih`` is stored
    as ``encoder / layers / 0 / fwd / w_ih``."""
    if isinstance(tree, dict):
        out: Dict[str, np.ndarray] = {}
        for k, v in tree.items():
            out.update(tree_arrays(v, f"{prefix}{k}."))
        return out
    if tree is None:
        return {}
    return {prefix[:-1]: np.asarray(tree)}


def is_torch_checkpoint(path: str) -> bool:
    """A torch pickle: a zip archive, or a bare pickle stream whose protocol
    byte is followed by a real opcode (a native file's 8-byte header length
    has zero high bytes), as the JAX package sniffs it."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic[:4] == b"PK\x03\x04":
        return True
    if len(magic) >= 2 and magic[0] == 0x80 and magic[1] in (2, 3, 4, 5):
        return magic[2:8].rstrip(b"\x00") != b""
    return False


def load_checkpoint(path: str, module: nn.Module,
                    plugin: Optional[nn.Module] = None) -> Dict[str, Any]:
    """Fill ``module`` (the port's ASR or RNNLM) from ``path`` in either
    format, and ``plugin`` (an ASR's embedding plugin) from it as well:
    from a native plugin solver's {'asr', 'plugin'} tree (a plugin part is
    skipped without ``plugin``), or by suffix from a torch checkpoint
    (``utils/torch_ckpt.py``), or from an orbax directory's JAX tree.
    Returns {'optimizer' (the port's ``Optimizer.state_dict()``: the one a
    torch checkpoint saved, or the optax state of a native file or an
    orbax directory through ``utils/optax_state.from_optax``; None where
    the checkpoint holds none), 'global_step', 'format'}."""
    p = Path(path)
    if not p.exists():
        p = recover_sibling(p)
    if p.is_dir():
        ck = read_orbax(p)
        load_arrays(module, ck["model"], plugin)
        return {"optimizer": ck["optimizer"],
                "global_step": ck["global_step"], "format": "orbax"}
    if is_torch_checkpoint(str(p)):
        ck = (load_lm_checkpoint(str(p), module) if isinstance(module, RNNLM)
              else load_torch_checkpoint(str(p), module, plugin))
        return {"optimizer": ck.get("optimizer"),
                "global_step": ck["global_step"], "format": "torch"}
    ck = read_native(str(p))
    load_arrays(module, tree_arrays(ck["model"]), plugin)
    opt = ck["optimizer"]
    return {"optimizer": None if opt is None else from_optax(tree_arrays(opt)),
            "global_step": ck["global_step"], "format": "native"}


def resumed(optimizer: Optional[Dict[str, Any]]) -> str:
    """What a resume took of the optimizer (``load_checkpoint``'s
    'optimizer'), for the solvers' load line."""
    if optimizer is None:
        return " (no optimizer state: the optimizer starts afresh)"
    return (f" (optimizer state: {optimizer['optimizer']}, count "
            f"{int(optimizer['count'])})")
