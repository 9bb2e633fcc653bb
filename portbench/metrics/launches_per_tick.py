"""Device kernel events in the profiled part of the window (every card;
copies and fills left out) per tick."""


def read(ctx):
    t = ctx.trace
    return t.launches / t.ticks if t is not None and t.ticks and t.launches else None
