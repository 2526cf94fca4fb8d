"""Input pipeline: mean ms a batch or step waited in the program's
``data.wait`` range (``parallel/mesh.py`` ``prefetch_to_device``)."""


def read(ctx):
    r = ctx.trace.range_ms("data.wait")
    return None if r is None else r[0]
