"""Device: the share of the traced window in which no operation ran on
the card."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
