"""Set-up seconds: from the process's start to the window's, loading,
weights, traffic, the kernels' build (a checkout's first run) and the
warm-up steps included."""


def read(ctx):
    return ctx.setup_s
