"""Recurrent scans: the least time of the LSTM recurrences the window's
inputs need (``work.scan_work`` of each scan call a driver lists at true
lengths: every encoder layer and direction, or every LM layer; forward,
and backward in training) over the scans' device time in the traced
window. The scans' kernels: ``tc_scan_kernel`` and ``tc_bwd_kernel``
(``csrc/scan_tc.cuh`` through ``lstm_scan.cu``)."""
from port_bench import work

KERNELS = r"\btc_(scan|bwd)_kernel\b"


def read(ctx):
    calls = [c for u in ctx.units for c in u["scans"]
             if str(c[3]).lower() == "lstm"]
    t = ctx.trace.device_s(KERNELS)
    if not calls or not t:
        return None
    return 100.0 * sum(work.least_s(*work.scan_work(*c)) for c in calls) / t
