"""Optimizer: device ms a step of the kernels launched inside the
program's ``lm.optimizer`` range (``optim.py`` through
``solvers/train_lm.py``)."""


def read(ctx):
    r = ctx.trace.range_ms("lm.optimizer")
    ops = ctx.trace.in_range("lm.optimizer")
    if r is None or not ops:
        return None
    return sum(e - s for s, e, _, _ in ops) / 1e6 / r[1]
