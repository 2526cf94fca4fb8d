"""Beam loop: kernel launches on the card in the traced window over the
beam steps its batches ran (``BeamDecoder.last_steps`` summed)."""


def read(ctx):
    steps = sum(u["steps"] for u in ctx.units)
    n = ctx.trace.count("kernel")
    return n / steps if steps and n else None
