"""The tensor-core time scans of ``csrc/scan_tc.cuh``: the forward shared
by K2 and K4 (f32, with optional training residuals), K2-bf16 and K4-bf16,
and the backward shared by K2b and K4b. How a scan is split over a cluster
of blocks, its launch, and plain helpers that spell out the kernel's
arithmetic.

Arithmetic: the kernel's step product h @ W_hh runs on bf16 tensor cores
yet equals the f32 product to f32 rounding. The f32 carry h is split into
three bf16 parts whose sum is h (``split3``); W_hh is split into w_hi =
bf16(W_hh) and a remainder, which is zero when W_hh is bf16-valued (decode
amp rounds its weights, ``ops/amp.bf16_rounded_copy``). The products of bf16
values are exact in f32 and are summed in f32 (``split_product``); the
remainder passes run only where ``has_bf16_remainder`` is true, as for the
W_hh of training and of the f32 decode (K2 and K4 in f32).

The f32 backward scan (K2b and K4b, ``tc_bwd_kernel``) runs the same
arithmetic on the carry's product dhp @ W_hh^T (``split_product(dhp,
w_hh.t())``, dhp the previous walked step's gate gradients): dhp is split
each step, and training W_hh always takes the remainder passes.
``plan_bwd`` / ``run_bwd`` are its block split and launch.
"""
from __future__ import annotations

import ctypes
import math
from typing import Callable, Dict, Tuple

import torch

from . import build

CLUSTER, GRID = 0, 1   # the step exchange: thread-block cluster or grid
MAX_WARPS = 16
MAX_CLUSTER = 16       # blocks per cluster (the H100's non-portable size)


def split3(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """f32 h -> bf16 (hi, mid, lo) with hi + mid + lo == h: hi = bf16(h),
    mid = bf16(h - hi), lo = bf16(h - hi - mid), each rounded to nearest."""
    hi = h.to(torch.bfloat16)
    r = h - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def has_bf16_remainder(w: torch.Tensor) -> bool:
    """Whether f32 ``w`` holds a value that bf16 does not (the kernel's
    block-wide test, taken here over the whole matrix)."""
    return bool((w != w.to(torch.bfloat16).float()).any())


def split_product(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h (B, H) @ w (H, N) as the kernel computes it: bf16 parts, exact
    products, f32 sums; hi . w_hi in one sum, the smaller terms in another
    (each product widened to f32 and summed by torch's f32 matmul)."""
    hi, mid, lo = (p.float() for p in split3(h))
    w_hi, w_mid, w_lo = (p.float() for p in split3(w))
    small = mid @ w_hi + lo @ w_hi
    if has_bf16_remainder(w):
        small = small + hi @ w_mid + mid @ w_mid + hi @ w_lo
    return hi @ w_hi + small


def plan(H: int, n_gates: int) -> Tuple[int, int, int, int]:
    """(C, U, kw, kg) of a scan of width H with n_gates gates: C blocks of
    U = H / C units (U a multiple of 4), each block ceil(n_gates U / 16)
    m-tiles of 16 gate columns (zero-padded) times kg groups of kw k-steps
    of 16 that cover H (zero-padded; kw <= 16, the W fragments a warp holds
    in registers), at most 16 warps. C is the largest split of at most 16
    blocks (a cluster), one without padding columns first; where none fits,
    the smallest larger one (a cooperative grid only, e.g. H=1024). Raises
    for a width the kernel does not take."""
    if H <= 0 or H % 4:
        raise ValueError(f"tensor-core scan: H={H} is not a multiple of 4")
    ks = -(-H // 16)
    kg = -(-ks // 16)
    kw = -(-ks // kg)
    fits = [C for C in range(1, H // 4 + 1)
            if H % C == 0 and (H // C) % 4 == 0
            and -(-n_gates * (H // C) // 16) * kg <= MAX_WARPS]
    if not fits:
        raise ValueError(f"tensor-core scan: no block split for H={H} with "
                         f"{n_gates} gates")
    cluster = [C for C in fits if C <= MAX_CLUSTER]
    even = [C for C in cluster if n_gates * (H // C) % 16 == 0]
    C = max(even or cluster) if cluster else min(fits)
    return C, H // C, kw, kg


def warps(H: int, n_gates: int) -> int:
    """Warps per block of ``plan``'s split."""
    _, U, _, kg = plan(H, n_gates)
    return -(-n_gates * U // 16) * kg


def plan_bwd(H: int, n_gates: int) -> Tuple[int, int, int, int]:
    """(C, U, kw, kg) of the backward scan of width H: C blocks of U = H / C
    output units (U a multiple of 4, zero-padded to m-tiles of 16), each
    block kg groups of kw k-steps of 16 that cover the n_gates H columns of
    dhp it reduces over (kw <= 16), at most 16 warps. C is the largest split
    of at most 16 blocks (a cluster), one with U a multiple of 16 first;
    where none fits, the smallest larger one (a cooperative grid only, e.g.
    H=1024). Raises for a width the kernel does not take."""
    if H <= 0 or H % 4:
        raise ValueError(f"tensor-core backward scan: H={H} is not a "
                         f"multiple of 4")
    ks = -(-n_gates * H // 16)
    kg = -(-ks // 16)
    kw = -(-ks // kg)
    fits = [C for C in range(1, H // 4 + 1)
            if H % C == 0 and (H // C) % 4 == 0
            and -(-(H // C) // 16) * kg <= MAX_WARPS]
    if not fits:
        raise ValueError(f"tensor-core backward scan: no block split for "
                         f"H={H} with {n_gates} gates")
    cluster = [C for C in fits if C <= MAX_CLUSTER]
    even = [C for C in cluster if (H // C) % 16 == 0]
    C = max(even or cluster) if cluster else min(fits)
    return C, H // C, kw, kg


def warps_bwd(H: int, n_gates: int) -> int:
    """Warps per block of ``plan_bwd``'s split."""
    _, U, _, kg = plan_bwd(H, n_gates)
    return -(-U // 16) * kg


_groups: Dict[tuple, int] = {}


def max_groups(query: Callable, H: int, n_gates: int, rows: int,
               mode: int, planner: Callable = plan) -> int:
    """Groups of ``rows`` rows that can be resident at once (0 for clusters
    of more than 16 blocks, or where a block's shared memory does not
    fit). ``planner`` is ``plan`` (forward) or ``plan_bwd``."""
    key = (query.__name__, H, n_gates, rows, mode,
           torch.cuda.current_device())
    if key not in _groups:
        C, U, kw, kg = planner(H, n_gates)
        out = ctypes.c_int(0)
        build.check(query(H, U, C, kw, kg, rows, mode, ctypes.byref(out)),
                    "tensor-core scan occupancy query")
        _groups[key] = out.value
    return _groups[key]


def pick(query: Callable, H: int, n_gates: int, B: int,
         planner: Callable = plan, grid_first: bool = False
         ) -> Tuple[int, int]:
    """(mode, rows) of a launch at batch B. Fewer rows per group mean less
    work per block and step on more blocks, so the smallest group (8, then
    16 rows) is taken whose groups can all be resident at once: as clusters
    (the faster exchange, chip_smoke.py's scan_floor phase), else as one
    cooperative grid (on an H100 at most 7 clusters of 16 blocks fit, but 8
    groups of 16 blocks do as a grid). Else groups of 16 rows in waves
    (8 where a block of 16 rows does not fit, as in K2b's scan at H=512):
    clusters (the card runs them in waves), or grids launched in turn where
    the split has more than 16 blocks or the grid comes first.
    ``grid_first`` tries the grid before the clusters at each row count:
    the backward scan's exchange (3x the forward's for the GRU, 4x for the
    LSTM) ran faster through L2 than through distributed shared memory at
    B=32 on an H100 (chip_smoke.py's k4b design_ms)."""
    modes = ((CLUSTER, GRID) if planner(H, n_gates)[0] <= MAX_CLUSTER
             else (GRID,))
    if grid_first:
        modes = modes[::-1]
    for rows in (8, 16):
        groups = math.ceil(B / rows)
        for mode in modes:
            if groups <= max_groups(query, H, n_gates, rows, mode, planner):
                return mode, rows
    # in waves: 16-row groups where a block of them fits, else 8
    rows = 16 if max_groups(query, H, n_gates, 16, modes[0], planner) else 8
    return modes[0], rows


def schedule(query: Callable, H: int, n_gates: int, B: int,
             planner: Callable = plan, grid_first: bool = False,
             mode: int = None, rows: int = None) -> Tuple[int, int, int, int]:
    """(mode, rows, groups, per_launch) of a scan at batch B: the design
    (``mode`` and ``rows`` default to ``pick``'s), its groups of ``rows``
    rows, and how many of them one launch takes: all as clusters (the card
    runs them in waves), as many as can be resident as a grid."""
    if mode is None or rows is None:
        mode, rows = pick(query, H, n_gates, B, planner, grid_first)
    groups = math.ceil(B / rows)
    per_launch = (groups if mode == CLUSTER else
                  max(1, min(groups, max_groups(query, H, n_gates, rows,
                                                GRID, planner))))
    return mode, rows, groups, per_launch


def launches(query: Callable, H: int, n_gates: int, B: int,
             planner: Callable = plan, grid_first: bool = False) -> int:
    """Kernel launches of one ``run`` (or, with ``plan_bwd`` and
    ``grid_first``, one ``run_bwd``) at batch B in ``pick``'s design."""
    _, _, groups, per_launch = schedule(query, H, n_gates, B, planner,
                                        grid_first)
    return -(-groups // per_launch)


def run(launch: Callable, query: Callable, x_proj: torch.Tensor,
        w_hh: torch.Tensor, extra: tuple, mask: torch.Tensor, reverse: bool,
        n_gates: int, mode: int = None, rows: int = None, outs: tuple = ()
        ) -> Tuple[torch.Tensor, int]:
    """The scan on CUDA tensors -> (ys (T, B, H) in x_proj's dtype, kernel
    launches). ``launch`` / ``query`` are a scan library's ``*_tc_launch``
    and ``*_tc_max_groups``; ``extra`` the pointers between w_hh and the
    mask (the GRU's b_hh), ``outs`` those after ys (the f32 scans'
    residual outputs, or nulls). ``mode`` and ``rows`` default to
    ``pick``'s. One launch
    holds every group as clusters (the card runs them in waves) or as a
    grid where they can all be resident; a grid takes as many launches as
    it needs otherwise. A launch the card refuses raises."""
    T, B, G = x_proj.shape
    H = G // n_gates
    C, U, kw, kg = plan(H, n_gates)
    mode, rows, groups, per_launch = schedule(query, H, n_gates, B,
                                              mode=mode, rows=rows)
    dev = x_proj.device
    ys = torch.empty((T, B, H), dtype=x_proj.dtype, device=dev)
    # w_mid / w_lo fragments: 1024 bytes per warp and k-step
    wrem = torch.empty(C * warps(H, n_gates) * kw * 256, dtype=torch.float32,
                       device=dev)
    hbuf = (torch.empty((per_launch, 2, rows, H), dtype=torch.float32,
                        device=dev) if mode == GRID else None)
    m = mask.to(torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launches = 0
    for g0 in range(0, groups, per_launch):
        rc = launch(x_proj.data_ptr(), w_hh.data_ptr(),
                    *(t.data_ptr() for t in extra), m.data_ptr(),
                    ys.data_ptr(), *outs, wrem.data_ptr(),
                    None if hbuf is None else hbuf.data_ptr(),
                    T, B, H, U, C, kw, kg, rows, g0,
                    min(per_launch, groups - g0), mode, int(reverse), stream)
        build.check(rc, "tensor-core scan launch")
        launches += 1
    return ys, launches


def run_bwd(launch: Callable, query: Callable, ptrs: tuple, w_hh: torch.Tensor,
            T: int, B: int, n_gates: int, reverse: bool, mode: int = None,
            rows: int = None) -> int:
    """The backward scan on CUDA tensors; returns its kernel launches.
    ``launch`` / ``query`` are a scan library's ``*_tc_bwd_launch`` and
    ``*_tc_bwd_max_groups``; ``ptrs`` the data pointers the launch takes
    before its scratch (its inputs, the f32 mask, w_hh, its outputs).
    ``mode`` and ``rows`` default to ``pick``'s; groups that cannot all be
    resident run as clusters in waves (one launch) or as grids launched in
    turn. A launch the card refuses raises."""
    H = w_hh.shape[0]
    C, U, kw, kg = plan_bwd(H, n_gates)
    mode, rows, groups, per_launch = schedule(query, H, n_gates, B, plan_bwd,
                                              True, mode, rows)
    dev = w_hh.device
    wrem = torch.empty(C * warps_bwd(H, n_gates) * kw * 256,
                       dtype=torch.float32, device=dev)
    hbuf = (torch.empty((per_launch, 2, rows, n_gates * H),
                        dtype=torch.float32, device=dev)
            if mode == GRID else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launches = 0
    for g0 in range(0, groups, per_launch):
        rc = launch(*ptrs, wrem.data_ptr(),
                    None if hbuf is None else hbuf.data_ptr(),
                    T, B, H, U, C, kw, kg, rows, g0,
                    min(per_launch, groups - g0), mode, int(reverse), stream)
        build.check(rc, "tensor-core backward scan launch")
        launches += 1
    return launches


_FLOOR_SIG = {"scan_floor_launch": (ctypes.c_int, [
    ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7 + [
    ctypes.c_void_p])}


def floor_launch(T: int, H: int, C: int, rows: int, groups: int,
                 threads: int, mode: int) -> torch.Tensor:
    """One launch of the exchange floor (``csrc/scan_floor.cu``): T rounds
    of the barrier and the exchange of h, nothing else."""
    lib = build.load("scan_floor", _FLOOR_SIG)
    hbuf = (torch.empty((groups, 2, rows, H), dtype=torch.float32,
                        device="cuda") if mode == GRID else None)
    sink = torch.empty(C * groups, dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rc = lib.scan_floor_launch(None if hbuf is None else hbuf.data_ptr(),
                               sink.data_ptr(), T, H, C, rows, groups,
                               threads, mode, stream)
    build.check(rc, "scan floor launch")
    return sink
