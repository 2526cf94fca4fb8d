"""Front end: K1's least time (``work.fbank_work`` on each batch's waves,
bf16 rate and HBM bandwidth) over its device time in the traced window.
K1's kernels: ``fbank_kernel``, ``fbank_split_kernel`` (``csrc/fbank.cu``)."""
from port_bench import work

KERNELS = r"\bfbank_(split_)?kernel\b"


def read(ctx):
    t = ctx.trace.device_s(KERNELS)
    if not t:
        return None
    least = 0.0
    for u in ctx.units:
        least += work.least_s(*work.fbank_work(len(u["wave_len"]),
                                               u["shape"][1]))
    return 100.0 * least / t
