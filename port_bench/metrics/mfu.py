"""Whole step: the configuration's model FLOPs of the traced window's
batches or steps, as each driver counts them with ``work.py`` (products
and convolutions at true lengths, beam steps as run, forward plus twice
that backward in training), over the traced window's seconds at the bf16
peak."""
from port_bench import work


def read(ctx):
    f = sum(u["flops"] for u in ctx.units)
    return 100.0 * f / (ctx.trace.window_s * work.PEAKS["flops"])
