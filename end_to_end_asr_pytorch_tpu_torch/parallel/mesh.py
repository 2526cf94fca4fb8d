"""Data parallelism over several processes: the port's counterpart of the
JAX package's ``parallel/mesh.py`` data mesh.

The JAX package runs one process over every device, a 1-D ``('data',)``
mesh: batches sharded on their leading axis, parameters replicated, and the
gradient psum placed by XLA. Here that is one process per card, started by
``torchrun`` (``python -m torch.distributed.run``), which sets ``RANK``,
``LOCAL_RANK`` and ``WORLD_SIZE``; without them the world is 1, no process
group is made and every helper below is a no-op. The sharded step keeps the
JAX step's global-batch semantics by hand:

  * ``corpus.batch_size`` is the global batch. Every rank walks the same
    batch order, the batch is padded to a multiple of the world with
    zero-length rows (``pad_batch_to``, as the JAX package pads), and each
    rank assembles its rows (``row_range``), padded to the global batch's
    longest wave and label.
  * Losses are normalised by global counts (``all_reduce_sum`` before the
    backward) and the gradients are summed (``all_reduce_grads``), so the
    optimizer, its clip and its non-finite skip see the world-1 gradient.
  * Random draws with a batch axis (dropout, SpecAugment) are drawn at the
    global batch's shape from the step's generator and cut to the rank's
    rows (``rand`` / ``randint`` under ``batch_rows``), so every rank's
    generator advances as world 1's does.

The backend is NCCL for a CUDA device and gloo for the CPU; a card without
a working NCCL raises. ``init`` takes ``backend`` / ``init_method`` /
``rank`` / ``world`` for tests and smoke runs (gloo over CUDA tensors on
one card), never from the command line. The process group has a finite
timeout, so a lost rank ends the job instead of hanging it.
``model_parallel > 1`` (the JAX package's tensor-parallel axis) is not
ported: the solvers raise on it.
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 600.0              # process group timeout: a lost rank raises
BUCKET_BYTES = 128 << 20       # largest flat all-reduce bucket

_rows: Optional[Tuple[int, int, int]] = None   # see batch_rows
_axis = 0                                      # see time_major


def init(device: torch.device, backend: Optional[str] = None,
         init_method: Optional[str] = None, rank: Optional[int] = None,
         world: Optional[int] = None,
         timeout: float = TIMEOUT_S) -> Tuple[int, int]:
    """Join the process group and return ``(rank, world)``: ``(0, 1)`` and
    no group when neither ``torchrun``'s environment nor ``rank`` / ``world``
    is given; the existing group's when one is already made."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if rank is None and not ("RANK" in os.environ
                             and "WORLD_SIZE" in os.environ):
        return 0, 1
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world = int(os.environ["WORLD_SIZE"]) if world is None else int(world)
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("this PyTorch has no NCCL: data parallelism on "
                           "the card needs it")
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout))
    return rank, world


def active() -> bool:
    """Whether a process group is made (at any world size)."""
    return dist.is_initialized()


def backend() -> str:
    return dist.get_backend() if dist.is_initialized() else "none"


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def pad_batch_to(batch: Dict[str, Any], multiple: int) -> Dict[str, Any]:
    """Pad the batch dim up to a multiple of ``multiple`` with zero-length
    dummy rows (array entries zero, so ``text_len == 0`` masks them out of
    every loss and metric); list entries are padded with ``""``."""
    some = next(v for v in batch.values() if isinstance(v, np.ndarray))
    pad = (-some.shape[0]) % multiple
    if pad == 0:
        return batch
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            out[k] = np.concatenate(
                [v, np.zeros((pad,) + v.shape[1:], v.dtype)], axis=0)
        elif isinstance(v, list):
            out[k] = v + [""] * pad
        else:
            out[k] = v
    return out


def row_range(n: int, rank: int, world: int) -> Tuple[int, int]:
    """Rows ``[lo, hi)`` of rank ``rank`` in a batch of ``n`` rows, ``n`` a
    multiple of ``world`` (padded by ``pad_batch_to``)."""
    if n % world:
        raise ValueError(f"{n} rows do not split over {world} ranks")
    per = n // world
    return rank * per, (rank + 1) * per


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place (a no-op at world 1)."""
    if dist.is_initialized():
        dist.all_reduce(t)
    return t


def _buckets(tensors: Sequence[torch.Tensor]) -> Iterable[List[torch.Tensor]]:
    """Consecutive runs of one dtype and device, each <= BUCKET_BYTES (a
    larger tensor alone)."""
    run: List[torch.Tensor] = []
    size = 0
    for t in tensors:
        nb = t.numel() * t.element_size()
        if run and (t.dtype != run[0].dtype or t.device != run[0].device
                    or size + nb > BUCKET_BYTES):
            yield run
            run, size = [], 0
        run.append(t)
        size += nb
    if run:
        yield run


def all_reduce_grads(params: Dict[str, torch.Tensor],
                     extra: Sequence[torch.Tensor] = ()) -> None:
    """Sum every parameter's ``.grad`` (a missing one as zeros) and the
    ``extra`` tensors over the ranks, in place, through flat buckets: one
    all-reduce per bucket. A no-op without a process group."""
    if not dist.is_initialized():
        return
    tensors = []
    for p in params.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        tensors.append(p.grad)
    tensors += list(extra)
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat)
        off = 0
        for t in bucket:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def gather_rows(obj: Any) -> List[Any]:
    """Every rank's ``obj`` (any picklable), in rank order."""
    if not dist.is_initialized():
        return [obj]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def gather_batch(part: Dict[str, Any]) -> Dict[str, Any]:
    """The global batch from every rank's ``part``: arrays with a batch
    axis and lists joined in rank order, 0-d arrays and numbers summed
    (``part`` itself without a process group)."""
    if not dist.is_initialized():
        return part
    parts = gather_rows(part)
    out = {}
    for k, v in part.items():
        vs = [p[k] for p in parts]
        if isinstance(v, list):
            out[k] = [x for p in vs for x in p]
        elif isinstance(v, np.ndarray) and v.ndim:
            out[k] = np.concatenate(vs, axis=0)
        else:
            out[k] = sum(vs)
    return out


# ------------------------------------------------------- global-shape draws
@contextlib.contextmanager
def batch_rows(rows: Optional[Tuple[int, int, int]]):
    """Within the block, ``rand`` / ``randint`` draw at the global batch's
    shape and keep this rank's rows. ``rows = (lo, hi, total)``: the rank
    holds rows ``[lo, hi)`` of the padded global batch, whose first
    ``total`` rows are real; the draws take ``total`` rows (world 1's
    shape), and a dummy row past them gets zeros. ``None``: plain draws."""
    global _rows
    prev, _rows = _rows, rows
    try:
        yield
    finally:
        _rows = prev


@contextlib.contextmanager
def time_major():
    """Within the block, a draw's batch axis is 1 (time-major tensors)."""
    global _axis
    prev, _axis = _axis, 1
    try:
        yield
    finally:
        _axis = prev


def _cut(draw, shape: Sequence[int]) -> torch.Tensor:
    if _rows is None:
        return draw(tuple(shape))
    lo, hi, total = _rows
    if shape[_axis] != hi - lo:
        raise ValueError(f"a draw of shape {tuple(shape)} has {shape[_axis]}"
                         f" rows on axis {_axis}, the rank holds {hi - lo}")
    full = list(shape)
    full[_axis] = total
    u = draw(tuple(full))
    a, b = min(lo, total), min(hi, total)
    part = u.narrow(_axis, a, b - a)
    if b - a < hi - lo:
        pad = list(shape)
        pad[_axis] = hi - lo - (b - a)
        part = torch.cat([part, u.new_zeros(pad)], dim=_axis)
    return part


def rand(shape: Sequence[int], generator: torch.Generator, device=None,
         dtype=torch.float32) -> torch.Tensor:
    """``torch.rand(shape)`` of a tensor with a batch axis (0, or 1 within
    ``time_major``), drawn at the global shape under ``batch_rows``."""
    return _cut(lambda s: torch.rand(s, generator=generator, device=device,
                                     dtype=dtype), shape)


def randint(high: int, shape: Sequence[int], generator: torch.Generator,
            device=None) -> torch.Tensor:
    """``torch.randint(0, high, shape)``, drawn as ``rand`` is."""
    return _cut(lambda s: torch.randint(0, high, s, generator=generator,
                                        device=device), shape)
