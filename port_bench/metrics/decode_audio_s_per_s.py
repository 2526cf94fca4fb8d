"""Work completed per second of window (host clock): the completed
batches' or steps' work (true audio seconds or true tokens) over the time
from the window's start to the last completion."""


def read(ctx):
    return ctx.rate()
