"""Data and tensor parallelism over several processes: the port's
counterpart of the JAX package's ``parallel/mesh.py`` mesh.

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

Tensor parallelism (``model_parallel: M``, the JAX package's 2-D
``('data', 'model')`` mesh): ``set_model_parallel(M)`` lays the world of
``W = D x M`` ranks out as ``np.arange(W).reshape(D, M)`` does (rank ``r``
is data index ``r // M`` and model index ``r % M``) and makes one data
group for each model index and one model group for each data index; M that
does not divide the world raises ``ValueError``. The batch is then padded
to a multiple of W and split by data index over D, so every rank of a
model group holds the same rows and draws the same masks; the gradient
sum, the loss normalisers and the gathered outputs go over the data group
(each data group holds every row once). ``model_parallel_spec`` is the JAX
package's placement rule over the port's parameter names; ``parallel/tp.py``
computes with the parts it places. The model group's collectives are
all-reduces (``model_all_reduce``, and ``model_all_gather`` as an
all-reduce of a zero-filled whole buffer in which each rank wrote its
part): gloo has only ``broadcast`` and ``all_reduce`` for CUDA tensors, and
the one route runs on gloo and NCCL alike.

The input pipeline (``prefetch_to_device``, the JAX function of that name):
every training, validation and decode loop takes its batches from a
background thread that copies the next batch to the rank's card, from
pinned memory on a side stream, while the step runs on this one.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import queue
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

TIMEOUT_S = 600.0              # process group timeout: a lost rank raises
BUCKET_BYTES = 128 << 20       # largest flat all-reduce bucket

_rows: Optional[Tuple[int, int, int]] = None   # see batch_rows
_axis = 0                                      # see time_major


class _Layout:
    """The ``(data, model)`` layout of the world (``set_model_parallel``)."""

    def __init__(self, rank: int = 0, world: int = 1, m: int = 1,
                 data_group=None, model_group=None):
        self.rank, self.world, self.m = rank, world, m
        self.data_group, self.model_group = data_group, model_group

    @property
    def data_index(self) -> int:
        return self.rank // self.m

    @property
    def data_size(self) -> int:
        return self.world // self.m

    @property
    def model_index(self) -> int:
        return self.rank % self.m


_layout = _Layout()
# host ms and bytes of the model group's collectives while timing is on
# (``time_collectives``); each call then synchronises the device
_timing: Optional[Dict[str, float]] = None


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
    global _layout
    _layout = _Layout(rank, world)
    return rank, world


def active() -> bool:
    """Whether a process group is made (at any world size)."""
    return dist.is_initialized()


def backend() -> str:
    return dist.get_backend() if dist.is_initialized() else "none"


def shutdown() -> None:
    global _layout
    if dist.is_initialized():
        dist.destroy_process_group()
    _layout = _Layout()


def set_model_parallel(m: int) -> _Layout:
    """Lay the world out as ``(world // m, m)`` (data, model) and make the
    groups (every rank must call it, with the same ``m``). ``m`` that does
    not divide the world raises ``ValueError``, as the JAX package's
    ``make_mesh`` does, at world 1 too."""
    global _layout
    m = int(m)
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    if m < 1 or world % m:
        raise ValueError(f"model_parallel={m} does not divide {world} "
                         "processes")
    if (_layout.m, _layout.world, _layout.rank) == (m, world, rank):
        return _layout
    data_group = model_group = None
    if m > 1:
        grid = np.arange(world).reshape(-1, m)
        for j in range(m):                       # one data group a column
            g = dist.new_group([int(r) for r in grid[:, j]])
            if j == rank % m:
                data_group = g
        for i in range(world // m):              # one model group a row
            g = dist.new_group([int(r) for r in grid[i]])
            if i == rank // m:
                model_group = g
    _layout = _Layout(rank, world, m, data_group, model_group)
    return _layout


def model_size() -> int:
    """M, the model axis's size (1 without tensor parallelism)."""
    return _layout.m


def model_index() -> int:
    return _layout.model_index


def data_size() -> int:
    """D, the ranks that hold different rows."""
    return _layout.data_size if dist.is_initialized() else 1


def data_index() -> int:
    return _layout.data_index if dist.is_initialized() else 0


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
    """``t`` summed over the data group's ranks, in place (a no-op at world
    1): over every rank that holds other rows, each row once."""
    if dist.is_initialized():
        dist.all_reduce(t, group=_layout.data_group)
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
    ``extra`` tensors over the data group, in place, through flat buckets:
    one all-reduce per bucket. A no-op without a process group, and no
    collective when the data group is one rank."""
    if not dist.is_initialized():
        return
    tensors = []
    for p in params.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        tensors.append(p.grad)
    if data_size() == 1:
        return
    tensors += list(extra)
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=_layout.data_group)
        off = 0
        for t in bucket:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def gather_rows(obj: Any) -> List[Any]:
    """Every data index's ``obj`` (any picklable), in data order, over this
    rank's data group (the ranks of its model index: every row once)."""
    if not dist.is_initialized() or data_size() == 1:
        return [obj]
    out: List[Any] = [None] * data_size()
    dist.all_gather_object(out, obj, group=_layout.data_group)
    return out


def gather_batch(part: Dict[str, Any]) -> Dict[str, Any]:
    """The global batch from every data index's ``part``: arrays with a
    batch axis and lists joined in data order, 0-d arrays and numbers
    summed (``part`` itself when the data group is one rank)."""
    if not dist.is_initialized() or data_size() == 1:
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


# ------------------------------------------------------------ input pipeline
ASR_KEYS = ("wave", "wave_len", "text", "text_len")
# the step's dtype where it is not the loader's: labels and their lengths
# as int64 (the losses' gathers and the embedding lookups take them so);
# waves stay int16 on the wire where the loader packed them
STEP_DTYPES = {"text": np.int64, "text_len": np.int64}
SLOT_WAIT_S = 0.2           # the worker's cancellable wait for a free slot
_STOP = object()


def stage_batch(batch: Dict[str, Any], keys: Sequence[str],
                device: torch.device, stream=None):
    """``(device tensors, host tensors, event)`` of the entries of ``keys``
    that ``batch`` holds, each in its step dtype (``STEP_DTYPES``). On the
    CPU (``stream`` None) the host tensors are the device tensors, from
    ``torch.from_numpy``, and the event is None. On a card each array is
    pinned and copied under ``stream`` (``non_blocking``), and the event is
    recorded on ``stream`` after the copies: the pinned tensors must stay
    referenced until it has passed."""
    host = {k: torch.from_numpy(np.ascontiguousarray(batch[k],
                                                     STEP_DTYPES.get(k)))
            for k in keys if k in batch}
    if stream is None:
        return host, host, None
    host = {k: t.pin_memory() for k, t in host.items()}
    with torch.cuda.stream(stream):
        dev = {k: t.to(device, non_blocking=True) for k, t in host.items()}
        event = torch.cuda.Event()
        event.record(stream)
    return dev, host, event


def _ready(dev: Dict[str, torch.Tensor], event, batch: Dict[str, Any],
           device: torch.device):
    """``(dev, batch)`` once the current stream waits for the copies: each
    device tensor recorded on it, for the caching allocator."""
    if event is not None:
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        for v in dev.values():
            v.record_stream(current)
    return dev, batch


def prefetch_to_device(batches, device, depth: int = 2,
                       keys: Sequence[str] = ASR_KEYS):
    """Wrap a host-batch iterable with device-side double buffering, the
    counterpart of the JAX package's ``prefetch_to_device``: a daemon
    worker thread draws the batches, puts their ``keys`` entries on
    ``device`` (``stage_batch``) and queues them, so that the copy of the
    next batch overlaps the step on this one. Yields ``(device_batch,
    host_batch)``: the dict of device tensors and the loader's batch as it
    came (names, raw text, ``rows``, numpy arrays). It does not pad, as the
    JAX worker does: the loader already hands each rank its rows padded to
    the global batch (``data/dataset.py`` ``_rank_rows``).

    A prefetcher holds at most ``depth`` batches on the device, the one the
    consumer was given last included: the worker stages a batch only once
    it holds one of ``depth`` slots, and the consumer frees a slot when it
    asks for the next batch. So the source runs at most ``depth`` batches
    ahead of those taken, and two prefetchers alive at once (validation
    inside a training epoch) hold at most ``2 * depth``. The wait for a
    slot is the cancellable one: the JAX worker's ``put(timeout=0.2)``
    loop on its bounded queue, here on the slots, so the queue itself is
    unbounded and the stop sentinel always lands.

    On a card the worker binds its thread to ``device`` (under ``torchrun``
    the rank's ``cuda:$LOCAL_RANK``, not card 0) and owns one side stream:
    it pins each array, copies it under the side stream and records an
    event, and keeps the pinned tensors until that event has passed. The
    consumer makes its current stream wait for the event and calls
    ``record_stream`` on each device tensor before yielding it, so the
    caching allocator does not hand the block back to the side stream
    while the step still reads it. A failure to pin, copy or record raises
    in the consumer, as any producer exception does, after the batches
    already yielded; nothing falls back to an inline copy. The consumer's
    wait for a batch is the profiler range ``data.wait``.

    Closing the generator (a ``max_step`` break, an exception in the
    consumer) stops the worker, which closes the source iterator in its
    own thread (a generator cannot be closed from another thread while it
    runs; ``epoch_iter``'s ``finally`` shuts its thread pool down), waits
    for the worker and drops the queued batches. The worker makes no
    collective call; those stay on the consumer's thread."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    q: "queue.Queue" = queue.Queue()
    slots = threading.Semaphore(max(1, int(depth)))
    cancel = threading.Event()
    error: List[BaseException] = []

    def take_slot() -> bool:
        while not cancel.is_set():
            if slots.acquire(timeout=SLOT_WAIT_S):
                return True
        return False

    def staged(b, stream):
        # a function of its own, so that no local of the worker keeps a
        # device batch alive past its slot
        dev, host, event = stage_batch(b, keys, device, stream)
        if event is not None:
            event.synchronize()   # the copies are done: the pinned tensors go
        return dev, event, b

    def worker():
        it = None
        try:
            it = iter(batches)
            with (torch.cuda.device(device) if on_card
                  else contextlib.nullcontext()):
                stream = torch.cuda.Stream(device) if on_card else None
                for b in it:
                    if not take_slot():
                        return
                    q.put(staged(b, stream))
        except BaseException as e:  # the consumer raises it
            error.append(e)
        finally:
            try:
                close = getattr(it, "close", None)
                if close is not None:
                    close()
            except BaseException as e:
                error.append(e)
            finally:
                q.put(_STOP)

    t = threading.Thread(target=worker, name="prefetch_to_device",
                         daemon=True)
    t.start()
    try:
        while True:
            with record_function("data.wait"):
                item = q.get()
            if item is _STOP:
                if error:
                    raise error[0]
                return
            yield _ready(*item, device)
            item = None
            slots.release()
    finally:
        cancel.set()
        t.join()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break


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


# ------------------------------------------------------- tensor parallelism
# The JAX package's ``model_parallel_spec``, keyed on the last component of
# the port's parameter names (``utils/weights.port_name`` keeps the JAX
# leaf names), and so on the optimizer's slots, which take their
# parameter's name: the dimension a leaf is split along, or None
# (replicated: a name in no set, or a dimension M does not divide).
COL_SHARDED = {"w_ih", "w_hh", "w_q", "w_k", "w_v", "w_f", "v_energy",
               "ctc_w", "char_w", "out_w"}
VEC_SHARDED = {"b", "b_ih", "b_hh", "ctc_b", "char_b", "bias", "out_b"}
ROW_SHARDED = {"embed"}


def model_parallel_spec(name: str, shape: Sequence[int],
                        m: int) -> Optional[int]:
    leaf = name.rsplit(".", 1)[-1]
    shape = tuple(shape)
    if leaf in COL_SHARDED and len(shape) == 2 and shape[-1] % m == 0:
        return 1
    if leaf in VEC_SHARDED and len(shape) == 1 and shape[0] % m == 0:
        return 0
    if leaf in ROW_SHARDED and len(shape) == 2 and shape[0] % m == 0:
        return 0
    return None


def part_of(t: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's part of a whole tensor split along ``dim`` over the
    model group (a copy)."""
    n = t.shape[dim] // _layout.m
    return t.narrow(dim, model_index() * n, n).clone()


@contextlib.contextmanager
def time_collectives():
    """Within the block, each model-group collective synchronises the
    device before and after itself and adds its host ms and its bytes to
    the dict yielded (``ms``, ``bytes``, ``calls``)."""
    global _timing
    prev, _timing = _timing, {"ms": 0.0, "bytes": 0.0, "calls": 0.0}
    try:
        yield _timing
    finally:
        _timing = prev


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@contextlib.contextmanager
def _timed(t: torch.Tensor, nbytes: int):
    if _timing is None:
        yield
        return
    _sync(t)
    t0 = time.perf_counter()
    yield
    _sync(t)
    _timing["ms"] += (time.perf_counter() - t0) * 1e3
    _timing["bytes"] += nbytes
    _timing["calls"] += 1


def model_all_reduce(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the model group, in place."""
    if _layout.m > 1:
        with _timed(t, t.numel() * t.element_size()):
            dist.all_reduce(t, group=_layout.model_group)
    return t


def model_all_gather(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The model group's parts of ``t`` joined along ``dim`` in model
    order: an all-reduce of a zero-filled buffer holding this rank's part
    in its slot (every rank gets the same bits)."""
    m = _layout.m
    if m == 1:
        return t
    buf = t.new_zeros((m,) + tuple(t.shape))
    buf[model_index()] = t
    with _timed(t, buf.numel() * buf.element_size()):
        dist.all_reduce(buf, group=_layout.model_group)
    return torch.cat(buf.unbind(0), dim=dim)
