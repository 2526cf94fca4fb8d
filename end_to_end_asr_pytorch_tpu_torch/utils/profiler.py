"""Tracing and timing, the port of the JAX package's ``utils/profiler.py``:
- ``trace(logdir)``: a context manager around ``torch.profiler`` (CPU
  activity, and CUDA activity when a card is present) that writes a Chrome
  trace JSON into ``logdir`` (``trace.<pid>.<ns>.json``, the path it
  yields);
- ``benchmark(fn, *args)``: warm-up, then ``iters`` timed calls, the card
  synchronised before and after the timed loop when the output is on it;
  ms per call, calls per second and, given the batch's shape, utterances
  per second and the inverse real-time factor;
- ``device_memory()``: in-use, peak and limit bytes a card, from
  ``torch.cuda.memory_stats`` and ``mem_get_info`` (one ``cpu`` entry with
  -1 fields when there is no card).
"""
from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; yields the path of the Chrome trace, which is
    written into ``logdir`` when the block ends."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    path = Path(logdir) / f"trace.{os.getpid()}.{time.time_ns()}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield path
    prof.export_chrome_trace(str(path))


def _on_card(out: Any) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, dict):
        return any(_on_card(v) for v in out.values())
    if isinstance(out, (list, tuple)):
        return any(_on_card(v) for v in out)
    return False


def benchmark(fn: Callable, *args, iters: int = 10, warmup: int = 1,
              batch_utts: Optional[int] = None,
              audio_seconds: Optional[float] = None) -> Dict[str, Any]:
    """Time ``fn(*args)``; returns {ms_per_call, calls_per_sec,
    utts_per_sec? (with ``batch_utts``), inv_rtf? (with ``audio_seconds``
    too)}."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    sync = _on_card(out)
    if sync:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    if sync:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    res: Dict[str, Any] = {"ms_per_call": dt / iters * 1e3,
                           "calls_per_sec": iters / dt}
    if batch_utts:
        res["utts_per_sec"] = batch_utts * iters / dt
        if audio_seconds:
            res["inv_rtf"] = batch_utts * audio_seconds * iters / dt
    return res


def device_memory() -> Dict[str, Dict[str, int]]:
    """{device: {bytes_in_use, peak_bytes_in_use, bytes_limit}}."""
    if not torch.cuda.is_available():
        return {"cpu": {"bytes_in_use": -1, "peak_bytes_in_use": -1,
                        "bytes_limit": -1}}
    stats = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total)}
    return stats
