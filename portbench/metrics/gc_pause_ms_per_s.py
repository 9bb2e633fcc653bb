"""Milliseconds the interpreter's collector ran (``gc.callbacks`` start and
stop pairs) per second of the host part of the window."""


def read(ctx):
    return ctx.gc_s / ctx.host_seconds * 1e3 if ctx.host_seconds > 0 else None
