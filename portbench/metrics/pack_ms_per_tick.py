"""The program's histograms ``fused_pack_seconds`` and ``fused_put_seconds``
(the fleet batch's pack and its upload call) over the host part of the
traced run's window, per tick."""


def read(ctx):
    (pack, n), (put, _m) = ctx.host_phases["pack"], ctx.host_phases["put"]
    return (pack + put) / ctx.host_ticks * 1e3 if n and ctx.host_ticks else None
