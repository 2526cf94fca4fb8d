"""Readings that the limits of the check are set from, on the card at a
cell's own size, for many seeds in one process:

    python3 -m port_bench.control --workload <name> --seeds 1,2,3 \
        --seconds 5 [--control fp8|tf32] [--faults frozen,half_batch,...]

For each seed: the program's numbers (set-up, a window of ``--seconds``,
the check, as a run makes them: the lower readings), the control's (the
reference computed one precision below what the configuration states, in
the program's place, against the reference: the upper readings) and each
planted fault's (``half_batch``: half of every batch left out, the mean
taken over the rest; ``frozen``: a training step that leaves its state as
it was, or a beam step whose speller returns the state it was given;
``alter_token``: every best hypothesis's first token altered where it is
produced). One JSON line each, also appended to ``--out``. The benchmark's
own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys

from port_bench import cell as C, run

CONTROL = {"bf16": "fp8", "f32": "tf32"}


def readings(cell, seconds, fault=None, control=None):
    drv, out = run.measure(cell, seconds, False, fault)
    run.release(cell, drv)
    rows = [{"kind": fault or "program", "units": out["attempted"],
             **drv.readings("f32")}]
    if control:
        rows.append({"kind": control, **drv.readings(control)})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", default="auto")
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    from end_to_end_asr_pytorch_tpu_torch.utils.device import resolve_device
    dev = resolve_device(None)
    spec = C.load_spec()
    for seed in (int(s) for s in a.seeds.split(",")):
        cell = C.Cell(a.workload, seed, dev, spec=spec)
        control = a.control
        if control == "auto":
            prec = cell.config["precision"]
            control = CONTROL[prec["decode" if cell.mix["driver"] == "decode"
                                   else "train"]]
        try:
            rows = readings(cell, a.seconds, control=control or None)
            for f in filter(None, a.faults.split(",")):
                rows += readings(cell, a.seconds, fault=f)
        finally:
            C.remove_tree(cell.tmp)
        for r in rows:
            line = json.dumps({"workload": a.workload, "seed": seed, **r})
            print(line, flush=True)
            if a.out:
                with open(a.out, "a") as fh:
                    fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
