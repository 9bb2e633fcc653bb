"""Process start to the first timed tick: imports, the card, the kernel
library (built on a checkout's first run), the mirrors made from the seed,
the first upload and the warm-up ticks."""


def read(ctx):
    return ctx.setup_s
