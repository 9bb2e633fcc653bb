"""100 x (window - union of the device's op intervals) / window, over the
profiled part of the window. A union: overlapping ops count once."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.busy_s:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
