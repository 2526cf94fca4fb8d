"""Run one benchmark cell of the PyTorch + CUDA port and print its result.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (weights and traffic from the seed,
the program's solver, the kernels' build on a checkout's first run, every
batch of the pool once) is timed as ``setup_s``; then the cell's driver
drives the program for ``--seconds`` (under ``torch.profiler`` with
``--trace 1``); then the program's state is freed and the plain reference
judges what the window produced. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's ``end_to_end`` metrics, or with ``--trace 1`` its ``per_layer``
ones), ``device``, with ``--trace 1`` ``breakdown``, and last ``compared``:
each number the check compared with its limit, which are also the last
lines of standard error.

Exits 2 with no result when the card or the cards the cell asks for are
missing, and 3 when JAX or the JAX package is loaded in this process.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from port_bench import cell as C  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "end_to_end_asr_pytorch_tpu")
CACHE = C.ROOT / "build" / "port_bench_cache"


class Reading:
    """What a metric reader reads (``metrics/__init__.py``)."""

    def __init__(self, cell, units, t0, setup_s, trace=None):
        self.cell, self.units, self.t0 = cell, units, t0
        self.setup_s, self.trace = setup_s, trace

    def rate(self):
        if not self.units:
            return None
        return sum(u["work"] for u in self.units) / (
            max(u["t"] for u in self.units) - self.t0)


def forbidden_modules():
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _sync(cell):
    import torch
    if cell.device.type == "cuda":
        torch.cuda.synchronize()


def measure(cell, seconds, traced, fault=None):
    """Set-up, the window and its metrics, the device record and, with
    ``traced``, the breakdown. Returns (driver, result without the check).
    ``fault`` plants one of the check's faults (its tests)."""
    import torch
    drv = C.driver(cell.mix["driver"]).Driver(cell)
    drv.fault = fault
    drv.setup()
    _sync(cell)
    setup_s = time.perf_counter() - T_START
    trace = None
    on_card = cell.device.type == "cuda"
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function
        from port_bench.trace import WINDOW, Trace
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                         else [])
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                t0 = drv.window(seconds)
        trace = Trace(prof)
        del prof
    else:
        t0 = drv.window(seconds)
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": int(cell.workload["chips"]),
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated()
                                       if on_card else 0)}
    for u in drv.units:             # each batch's or step's work counts
        u.update(drv.counts(u))
    ctx = Reading(cell, drv.units, t0, setup_s, trace)
    metrics = {}
    for m in cell.metrics("per_layer" if traced else "end_to_end"):
        v = C.reader(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    out = {"attempted": len(drv.units), "failed": 0, "metrics": metrics,
           "device": device}
    if traced:
        device.update(busy_s=trace.busy_s, window_s=trace.window_s)
        out["breakdown"] = trace.breakdown()
    return drv, out


def release(cell, drv):
    """Free the program's state before the reference runs."""
    import torch
    drv.close()
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()


def judge(cell, drv):
    """Free the program's state, then compare with the reference each
    number that the cell's limits name (a number the driver did not read
    counts as inf). Returns (correct, {number: {"value", "limit"}})."""
    release(cell, drv)
    readings = drv.readings("f32")
    compared = {k: {"value": float(readings.get(k, float("inf"))),
                    "limit": float(lim)} for k, lim in cell.limits.items()}
    correct = bool(compared) and all(c["value"] <= c["limit"]
                                     for c in compared.values())
    return correct, compared


def run_cell(cell, seconds, traced, fault=None):
    """Everything a run does after its look for the card: the result
    object, or None when JAX or the JAX package got loaded (named on
    standard error)."""
    drv, out = measure(cell, seconds, traced, fault)
    if forbidden_modules():
        return None
    correct, compared = judge(cell, drv)
    if forbidden_modules():
        return None
    return {"correct": correct, **out, "compared": compared}


def main(argv=None) -> int:
    args = parse(argv)
    spec = C.load_spec()
    w = {x["name"]: x for x in spec["workloads"]}.get(args.workload)
    if w is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"{args.workload} needs {w['chips']} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    from end_to_end_asr_pytorch_tpu_torch.utils.device import resolve_device
    cell = C.Cell(args.workload, args.seed, resolve_device(None), spec=spec)
    try:
        result = run_cell(cell, args.seconds, bool(args.trace))
    finally:
        C.remove_tree(cell.tmp)
    if result is None:
        print(f"loaded in this process: {', '.join(forbidden_modules())}",
              file=sys.stderr)
        return 3
    for k, c in result["compared"].items():
        print(f"compared {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
