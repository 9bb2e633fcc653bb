"""Lock factory (the port's copy of ``kcp_tpu.analysis.sanitize.make_lock``).

The reference swaps in an order-tracking lock under its sanitizer; the
port has no sanitizer yet, so every named lock is a plain
``threading.Lock``. The name is kept so call sites read the same."""

from __future__ import annotations

import threading


def make_lock(name: str) -> threading.Lock:
    del name  # the lock-order graph's node id in the reference
    return threading.Lock()
