"""The port's host C++ libraries, built at first use: the FLAC decoder,
the repository root's ``native/flac_decoder.cc`` (the same source the JAX
package builds into ``native/libasrnative.so``), bound here, and the zstd
decoder of ``utils/zstd.py``.

A source is compiled on its own with ``g++ -O3 -fPIC -std=c++17 -shared``
at first use into ``build/torch_native/<name>-<hash>.so`` (the hash covers
the source and the flags, so an edited source rebuilds), through a
temporary file renamed into place, under a lock on the build directory
(``utils/locks.dir_lock``): one process (or thread) builds, the others
wait and load what it built. Nothing is built or loaded at import time,
and nothing is written under ``native/``. There is no fallback: a missing
compiler, a failed build or a library that does not load raises, with the
compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

from .locks import dir_lock

SOURCE = Path(__file__).resolve().parents[2] / "native" / "flac_decoder.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _target(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(source: Path) -> Path:
    """The shared library of ``source``, compiled first if there is none
    for this source and these flags."""
    out = _target(source)
    if out.exists():
        return out
    with dir_lock(BUILD_DIR):
        if not out.exists():
            _compile(out, source)
    return out


def _compile(out: Path, source: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: {source} is compiled at first "
                           "use")
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {source} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)


def load(source: Path, what: str) -> ctypes.CDLL:
    """Build ``source`` if need be and load it; ``what`` names it in the
    error a library that does not load raises."""
    path = build(source)
    try:
        return ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"cannot load the {what} {path}: {e}") from e


def get_lib() -> ctypes.CDLL:
    """The loaded decoder library with its ``flac_decode`` / ``flac_free``
    signatures (those of the JAX package's binding)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = load(SOURCE, "FLAC decoder")
            lib.flac_decode.restype = ctypes.c_int
            lib.flac_decode.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32)]
            lib.flac_free.restype = None
            lib.flac_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
            _lib = lib
        return _lib
