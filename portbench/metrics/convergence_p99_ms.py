"""The 99th percentile, over the changes churned in the host part of the
traced run's window, of the time from a change's churn to the apply of its
first patch. A per-layer reading: the host's speed, which wanders, paces
the tail too much for a bound (PERF.md §2)."""

import numpy as np


def read(ctx):
    lat = ctx.host_latencies_ms
    return float(np.percentile(lat, 99)) if lat.shape[0] else None
