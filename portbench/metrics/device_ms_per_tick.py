"""The union of the device's op intervals in the profiled part of the
window (averaged over the cards), per tick."""


def read(ctx):
    t = ctx.trace
    return t.busy_s / t.ticks * 1e3 if t is not None and t.ticks and t.busy_s else None
