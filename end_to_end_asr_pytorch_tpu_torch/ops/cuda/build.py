"""Build the CUDA sources in ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for ``sm_90a`` into ``build/torch_kernels/<name>-<hash>.so``
(the hash covers the source, the shared ``csrc/*.cuh`` headers and the
flags, so an edited source or header rebuilds). A lock on the build
directory (``utils/locks.dir_lock``) lets one process build while the
others (the ranks of a data-parallel job) wait and load what it built.
Nothing is built or loaded at import time. No fast-math flags: the decode's
CTC prefix scores rely on f32 subnormals and full-precision ``expf``/``logf``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

from ...utils.locks import dir_lock

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}   # ptxas report of each library built here


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def build(names: Iterable[str]) -> float:
    """Compile every named source that has no up-to-date library, all
    ``nvcc`` processes started together. Returns the wall seconds taken."""
    t0 = time.perf_counter()
    with dir_lock(BUILD_DIR):
        _build_locked(names)
    return time.perf_counter() - t0


def _build_locked(names: Iterable[str]) -> None:
    procs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        build_log[name] = log
        if p.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed.
    ``signatures`` maps each C function to ``(restype, [argtypes])``: every
    pointer must be ``c_void_p``, or ctypes passes it as a 32-bit int."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def check_inputs(what: str, ref, *tensors) -> None:
    """Raise unless each ``(name, tensor, shape, dtype)`` is a contiguous
    tensor of that shape and dtype on ``ref``'s device."""
    for name, t, shape, dt in tensors:
        if (t.device != ref.device or t.dtype != dt
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous {dt} "
                             f"{tuple(shape)} tensor on {ref.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
