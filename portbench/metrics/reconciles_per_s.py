"""Objects x ticks completed in the window / the window's seconds: every
tick re-decides every object (BASELINE.json's rate). The objects are the
configuration's ``objects``, those that exist at the start; the absent rows
of the bucket's padding are not counted."""


def read(ctx):
    return ctx.objects * ctx.ticks / ctx.window_s
