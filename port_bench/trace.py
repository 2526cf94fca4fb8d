"""The traced run's profile, reduced to what the per-layer readers and the
breakdown read: device operations (kernels, copies, sets) with their
launch times, the program's ``record_function`` ranges and the host ops
on the window's thread, all on the profiler's clock, inside the window
range ``bench.window`` that the harness records around the window.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW = "bench.window"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{what}_us")() * 1000)


def _kind(e) -> str:
    """The event's activity: from ``activity_type`` where the profiler has
    it, else from its device, annotation flag and name."""
    at = getattr(e, "activity_type", None)
    if at is not None:
        return str(at()).split(".")[-1]
    on_device = "CUDA" in str(e.device_type())
    if e.is_user_annotation():
        return "gpu_user_annotation" if on_device else "user_annotation"
    name = e.name()
    if on_device:
        return ("gpu_memcpy" if name.startswith("Memcpy") else
                "gpu_memset" if name.startswith("Memset") else "kernel")
    if name.startswith("cu") and "::" not in name:
        return "cuda_runtime"
    return "cpu_op"


class Trace:
    def __init__(self, prof):
        # (start, end, name, correlation) / (ts, thread) / (start, end, name,
        # thread): device operations, launches, host ops and ranges
        self.ops: List[Tuple[int, int, str, int]] = []
        self.launch: Dict[int, Tuple[int, int]] = {}
        self.ranges: Dict[str, List[Tuple[int, int, int]]] = defaultdict(list)
        self.host: List[Tuple[int, int, str, int]] = []
        kinds: List[str] = []
        for e in prof.profiler.kineto_results.events():
            kind = _kind(e)
            start = _ns(e, "start")
            end = start + _ns(e, "duration")
            if kind in DEVICE_KINDS:
                self.ops.append((start, end, e.name(), e.linked_correlation_id()))
                kinds.append(kind)
            elif kind == "cuda_runtime":
                self.launch[e.correlation_id()] = (start, e.start_thread_id())
            elif kind == "user_annotation":
                self.ranges[e.name()].append((start, end, e.start_thread_id()))
                self.host.append((start, end, e.name(), e.start_thread_id()))
            elif kind == "cpu_op":
                self.host.append((start, end, e.name(), e.start_thread_id()))
        if not self.ranges.get(WINDOW):
            raise RuntimeError("the trace holds no window range")
        self.t0, self.t1, self.thread = self.ranges[WINDOW][-1]
        inside = [o[1] > self.t0 and o[0] < self.t1 for o in self.ops]
        self.counts: Dict[str, int] = defaultdict(int)
        for k, keep in zip(kinds, inside):
            self.counts[k] += keep
        self.ops = sorted(o for o, keep in zip(self.ops, inside) if keep)
        self.host.sort()

    def count(self, kind: str) -> int:
        """Device operations of ``kind`` (``kernel``, ``gpu_memcpy``, ...)
        in the window."""
        return self.counts.get(kind, 0)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy(self) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals, clipped to the
        window."""
        out: List[Tuple[int, int]] = []
        for s, e, _, _ in self.ops:
            s, e = max(s, self.t0), min(e, self.t1)
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            elif e > s:
                out.append((s, e))
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def kernels(self, pattern: str) -> List[Tuple[int, int, str, int]]:
        """Device operations whose name matches ``pattern`` (a regex)."""
        rx = re.compile(pattern)
        return [o for o in self.ops if rx.search(o[2])]

    def device_s(self, pattern: str) -> float:
        return sum(e - s for s, e, _, _ in self.kernels(pattern)) / 1e9

    def in_range(self, name: str) -> List[Tuple[int, int, str, int]]:
        """Device operations launched from inside an occurrence of the range
        ``name`` on the window's thread."""
        spans = sorted((s, e) for s, e, t in self.ranges.get(name, [])
                       if t == self.thread and self.t0 <= s < self.t1)
        starts = [s for s, _ in spans]
        out = []
        for op in self.ops:
            ts, th = self.launch.get(op[3], (None, None))
            if ts is None or th != self.thread:
                continue
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= spans[i][1]:
                out.append(op)
        return out

    def range_ms(self, name: str) -> Optional[Tuple[float, int]]:
        """(mean ms, count) of the range ``name`` on the window's thread."""
        d = [(e - s) / 1e6 for s, e, t in self.ranges.get(name, [])
             if t == self.thread and self.t0 <= s < self.t1]
        return (sum(d) / len(d), len(d)) if d else None

    @staticmethod
    def _doing(t, host, starts, spans, span_starts) -> str:
        """What the window's thread was doing at ``t``: the op that started
        last before it and covers it, else the innermost program range,
        else Python between the program's ranges."""
        i = bisect.bisect_right(starts, t)
        for h in reversed(host[max(0, i - 400):i]):
            if h[1] >= t:
                return h[2]
        i = bisect.bisect_right(span_starts, t)
        for s, e, n in reversed(spans[max(0, i - 16):i]):
            if e >= t:
                return n
        return "(host, outside any range)"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the longest idle
        gaps summed by what the window's thread was doing (its innermost
        range or op over the gap's middle)."""
        by_op: Dict[str, float] = defaultdict(float)
        for s, e, n, _ in self.ops:
            by_op[n[:100]] += (min(e, self.t1) - max(s, self.t0)) / 1e9
        host = [h for h in self.host if h[3] == self.thread and h[2] != WINDOW]
        starts = [h[0] for h in host]
        spans = sorted((s, e, n) for n, occ in self.ranges.items() if n != WINDOW
                       for s, e, t in occ if t == self.thread)
        span_starts = [s for s, _, _ in spans]
        gaps: Dict[str, float] = defaultdict(float)
        prev = self.t0
        for s, e in self.busy() + [(self.t1, self.t1)]:
            if s > prev:
                gaps[self._doing((s + prev) // 2, host, starts, spans,
                                 span_starts)[:100]] += (s - prev) / 1e9
            prev = max(prev, e)
        def largest(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                    ][:top]
        return {"device_ops": largest(by_op), "idle_gaps": largest(gaps)}
