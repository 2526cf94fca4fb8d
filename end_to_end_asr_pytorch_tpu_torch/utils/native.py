"""The port's host C++ libraries, built at first use, and their bindings:
the counterpart of the JAX package's ``utils/native.py``. Each source lies
in the port's own ``native/``: ``flac_decoder.cc`` (``data/flac.py``),
``edit_distance.cc`` (``edit_distance``, ``edit_distance_batch``: WER and
CER in ``utils/metrics.py``), ``bpe_encoder.cc`` (``BpeEncoder``: the JSON
BPE encoder of ``utils/text.py``) and ``zstd_decoder.cc`` (``utils/zstd.py``).

A source is compiled on its own with ``g++ -O3 -fPIC -std=c++17 -shared``
at first use into ``build/torch_native/<name>-<hash>.so`` (the hash covers
the source and the flags, so an edited source rebuilds), through a
temporary file renamed into place, under a lock on the build directory
(``utils/locks.dir_lock``): one process (or thread) builds, the others
wait and load what it built. Each library is loaded once, under one lock.
Nothing is built or loaded at import time. There is no fallback: a missing
compiler, a failed build or a library that does not load raises, naming
the library, with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .locks import dir_lock

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
SOURCE = NATIVE_DIR / "flac_decoder.cc"
EDIT_SOURCE = NATIVE_DIR / "edit_distance.cc"
BPE_SOURCE = NATIVE_DIR / "bpe_encoder.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None        # the FLAC decoder
_edit_lib: Optional[ctypes.CDLL] = None
_bpe_lib: Optional[ctypes.CDLL] = None

_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)
FLAC_SIGNATURES = {
    "flac_decode": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]),
    "flac_free": (None, [ctypes.POINTER(ctypes.c_float)])}
EDIT_SIGNATURES = {
    "edit_distance": (ctypes.c_int32, [_I32, ctypes.c_int32, _I32,
                                       ctypes.c_int32]),
    "edit_distance_batch": (None, [_I32, _I32, _I32, _I32, ctypes.c_int32,
                                   _I32])}
BPE_SIGNATURES = {
    "bpe_create": (ctypes.c_void_p, [
        ctypes.c_char_p, _I64, ctypes.c_int32, ctypes.c_char_p, _I64,
        ctypes.c_char_p, _I64, ctypes.c_int32, ctypes.c_int32]),
    "bpe_encode": (ctypes.c_int32, [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int64, _I32, ctypes.c_int32]),
    "bpe_destroy": (None, [ctypes.c_void_p])}


def _target(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(source: Path, what: str) -> Path:
    """The shared library of ``source`` (``what`` names it in errors),
    compiled first if there is none for this source and these flags."""
    out = _target(source)
    if out.exists():
        return out
    with dir_lock(BUILD_DIR):
        if not out.exists():
            _compile(out, source, what)
    return out


def _compile(out: Path, source: Path, what: str) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: the {what} ({source}) is "
                           "compiled at first use")
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for the {what} {source} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)


def load(source: Path, what: str) -> ctypes.CDLL:
    """Build ``source`` if need be and load it; ``what`` names it in the
    errors."""
    path = build(source, what)
    try:
        return ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"cannot load the {what} {path}: {e}") from e


def _get(attr: str, source: Path, what: str, signatures) -> ctypes.CDLL:
    """The module's handle ``attr``, loaded with its ``signatures`` at the
    first call."""
    with _lock:
        lib = globals()[attr]
        if lib is None:
            lib = load(source, what)
            for name, (restype, argtypes) in signatures.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            globals()[attr] = lib
        return lib


def get_lib() -> ctypes.CDLL:
    """The FLAC decoder with its ``flac_decode`` / ``flac_free``
    signatures (those of the JAX package's binding)."""
    return _get("_lib", SOURCE, "FLAC decoder", FLAC_SIGNATURES)


def get_edit_lib() -> ctypes.CDLL:
    return _get("_edit_lib", EDIT_SOURCE, "edit distance library",
                EDIT_SIGNATURES)


def get_bpe_lib() -> ctypes.CDLL:
    return _get("_bpe_lib", BPE_SOURCE, "BPE encoder", BPE_SIGNATURES)


def _tok_ids(seq: Sequence) -> np.ndarray:
    """Tokens as int32 ids: int tokens as they are, any other hashable
    tokens (words, characters) numbered in order of first appearance."""
    if len(seq) and isinstance(seq[0], (int, np.integer)):
        return np.asarray(seq, np.int32)
    table: dict = {}
    return np.asarray([table.setdefault(t, len(table)) for t in seq],
                      np.int32)


def _pair_ids(a: Sequence, b: Sequence):
    """Both sides of a pair as ids of one table, so equal tokens match."""
    ids = _tok_ids(list(a) + list(b))
    return ids[:len(a)], ids[len(a):]


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance between two token sequences."""
    lib = get_edit_lib()
    ia, ib = _pair_ids(a, b)
    return int(lib.edit_distance(ia.ctypes.data_as(_I32), len(ia),
                                 ib.ctypes.data_as(_I32), len(ib)))


def edit_distance_batch(hyps: Sequence[Sequence], refs: Sequence[Sequence]
                        ) -> np.ndarray:
    """(n,) int32 Levenshtein distances of n (hyp, ref) pairs in one
    crossing into the library."""
    if len(hyps) != len(refs):
        raise ValueError(f"{len(hyps)} hypotheses, {len(refs)} references")
    lib = get_edit_lib()
    pairs = [_pair_ids(h, r) for h, r in zip(hyps, refs)]
    empty = np.zeros(0, np.int32)
    fa = np.concatenate([p[0] for p in pairs] + [empty])
    fb = np.concatenate([p[1] for p in pairs] + [empty])
    la = np.asarray([len(p[0]) for p in pairs], np.int32)
    lb = np.asarray([len(p[1]) for p in pairs], np.int32)
    out = np.zeros(len(pairs), np.int32)
    lib.edit_distance_batch(fa.ctypes.data_as(_I32), la.ctypes.data_as(_I32),
                            fb.ctypes.data_as(_I32), lb.ctypes.data_as(_I32),
                            len(pairs), out.ctypes.data_as(_I32))
    return out


def _utf8(s: str) -> bytes:
    # lone surrogates (a str may hold them) as the 3-byte sequences that
    # keep one piece per code point
    return s.encode("utf-8", "surrogatepass")


def _table(strings: Sequence[str]):
    """(one buffer of the strings' bytes, int64 offsets of n + 1)."""
    parts = [_utf8(s) for s in strings]
    off = np.zeros(len(parts) + 1, np.int64)
    np.cumsum([len(p) for p in parts], out=off[1:])
    return b"".join(parts), off


class BpeEncoder:
    """The native encoder of one JSON BPE model (``native/bpe_encoder.cc``):
    ``encode(text)`` gives ``SubwordTextEncoder.encode_py``'s ids without
    its <eos>, on any text. The model is read-only once built, so threads
    may encode through one handle at once."""

    def __init__(self, vocab: Sequence[str], merges: Sequence[Sequence[str]],
                 unk_id: int):
        lib = get_bpe_lib()
        # only a pair of pieces can match a pair in encode_py's dict
        merges = [m for m in merges if len(m) == 2]
        v, v_off = _table(vocab)
        a, a_off = _table([m[0] for m in merges])
        b, b_off = _table([m[1] for m in merges])
        self._lib = lib
        self._h = lib.bpe_create(v, v_off.ctypes.data_as(_I64), len(vocab),
                                 a, a_off.ctypes.data_as(_I64),
                                 b, b_off.ctypes.data_as(_I64), len(merges),
                                 unk_id)

    def encode(self, text: str) -> list:
        words = " ".join(text.split())
        data = _utf8(words)
        n_max = len(words)           # one id per code point at most
        buf = (ctypes.c_int32 * max(n_max, 1))()
        n = self._lib.bpe_encode(self._h, data, len(data), buf, n_max)
        if n < 0:
            raise RuntimeError(f"bpe_encode: {-n} ids for {n_max} code "
                               "points")
        return buf[:n]

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.bpe_destroy(h)
