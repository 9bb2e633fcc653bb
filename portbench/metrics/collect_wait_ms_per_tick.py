"""The program's histogram ``fused_collect_wait_seconds`` over the host part of
the traced run's window, per tick."""


def read(ctx):
    total, n = ctx.host_phases["collect_wait"]
    return total / ctx.host_ticks * 1e3 if n and ctx.host_ticks else None
