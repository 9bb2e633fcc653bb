"""``decide_and_match``'s share of its roofline: the bytes its call must
move (``kernels.decide_and_match_bytes``, from the cell's shapes) over the
card's peak bandwidth (``peaks.py``), divided by the kernel's device time
per tick in the profiled part of the window. The card's power limit is in
the result's ``device.card``."""

from portbench.kernels import decide_and_match_bytes
from portbench.peaks import PEAKS


def read(ctx):
    t, peak = ctx.trace, PEAKS.get(ctx.kind)
    if t is None or peak is None or not t.ticks:
        return None
    runs = [v for k, v in t.ops.items() if "decide_match_kernel" in k]
    seconds = sum(v[1] for v in runs)
    if not seconds:
        return None
    bound = decide_and_match_bytes(ctx.rows, ctx.slots) / peak["hbm_bytes_per_s"]
    return 100.0 * bound / (seconds / t.ticks)
