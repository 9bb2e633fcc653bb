"""Rate-limited work queue with batch drain.

Behavioral parity with client-go's workqueue as the reference uses it
(dedup while pending, per-item exponential backoff, 5 retries then drop —
pkg/syncer/syncer.go:272-291, pkg/reconciler/cluster/controller.go:243-263)
plus the one capability the batched device backend needs that client-go never had:
:meth:`drain` — collect up to N ready items in one await, so a reconcile
tick can process a whole batch in a single vectorized step instead of one
goroutine wakeup per key.
"""

from __future__ import annotations

import asyncio
import heapq
import re
import time
from collections import deque
from typing import Hashable

from ..utils.trace import REGISTRY

Item = Hashable

BASE_DELAY = 0.005  # client-go default rate limiter: 5ms * 2^n, capped
MAX_DELAY = 1000.0


def queue_metrics(name: str):
    """(depth gauge, queue-seconds histogram) for a named workqueue —
    the backpressure observables (client-go's workqueue_depth /
    workqueue_queue_duration_seconds analogs): operators watch depth
    climb and queue time stretch to see admission throttling propagate
    into the controllers. Shared by WorkQueue and FairWorkQueue."""
    suffix = re.sub(r"[^A-Za-z0-9_]", "_", name)
    depth = REGISTRY.gauge(
        f"workqueue_depth_{suffix}",
        f"items ready or delayed in the {name} workqueue")
    wait = REGISTRY.histogram(
        "workqueue_queue_seconds",
        "time items spent queued before a worker picked them up")
    return depth, wait


class WorkQueue:
    def __init__(self, name: str = "queue"):
        self.name = name
        self._ready: deque[Item] = deque()
        self._pending: set[Item] = set()  # dedup: queued or scheduled
        self._processing: set[Item] = set()
        self._redo: set[Item] = set()  # re-added while processing
        self._delayed: list[tuple[float, int, Item]] = []  # heap
        self._seq = 0
        self._retries: dict[Item, int] = {}
        self._wakeup: asyncio.Event = asyncio.Event()
        self._shutdown = False
        self._depth_gauge, self._wait_hist = queue_metrics(name)
        self._enq_t: dict[Item, float] = {}

    # ------------------------------------------------------------ adding

    def add(self, item: Item) -> None:
        if self._shutdown:
            return
        if item in self._processing:
            self._redo.add(item)
            return
        if item in self._pending:
            return
        self._pending.add(item)
        self._ready.append(item)
        self._enq_t.setdefault(item, time.monotonic())
        self._depth_gauge.set(len(self))
        self._wakeup.set()

    def add_after(self, item: Item, delay: float) -> None:
        if self._shutdown:
            return
        if delay <= 0:
            self.add(item)
            return
        if item in self._pending and item not in self._processing:
            return
        self._seq += 1
        heapq.heappush(self._delayed, (time.monotonic() + delay, self._seq, item))
        self._depth_gauge.set(len(self))
        self._wakeup.set()

    def add_rate_limited(self, item: Item) -> None:
        """Requeue with exponential per-item backoff (5ms * 2^n, capped)."""
        n = self._retries.get(item, 0)
        self._retries[item] = n + 1
        self.add_after(item, min(BASE_DELAY * (2**n), MAX_DELAY))

    def num_requeues(self, item: Item) -> int:
        return self._retries.get(item, 0)

    def forget(self, item: Item) -> None:
        self._retries.pop(item, None)

    # ------------------------------------------------------- batch forms
    # (the native FairWorkQueue crosses ctypes once per batch; these
    # fallback loops keep the interface identical)

    def add_many(self, items) -> None:
        for item in items:
            self.add(item)

    def complete_many(self, items, forget_flags) -> None:
        """forget (where flagged) + done for a processed tick batch."""
        for item, fg in zip(items, forget_flags):
            if fg:
                self.forget(item)
            self.done(item)

    # ---------------------------------------------------------- consuming

    def _promote_delayed(self) -> float | None:
        """Move due delayed items to ready; return seconds until next due."""
        now = time.monotonic()
        while self._delayed and self._delayed[0][0] <= now:
            _, _, item = heapq.heappop(self._delayed)
            if item in self._processing:
                self._redo.add(item)
            elif item not in self._pending:
                self._pending.add(item)
                self._ready.append(item)
                self._enq_t.setdefault(item, now)
        if self._delayed:
            return max(0.0, self._delayed[0][0] - now)
        return None

    def _took(self, item: Item, now: float) -> None:
        t = self._enq_t.pop(item, None)
        if t is not None:
            self._wait_hist.observe(now - t)

    async def get(self) -> Item | None:
        """Next item, or None on shutdown. Caller must call done(item)."""
        while True:
            next_due = self._promote_delayed()
            if self._ready:
                item = self._ready.popleft()
                self._pending.discard(item)
                self._processing.add(item)
                self._took(item, time.monotonic())
                self._depth_gauge.set(len(self))
                return item
            if self._shutdown:
                return None
            self._wakeup.clear()
            try:
                await asyncio.wait_for(
                    self._wakeup.wait(), timeout=next_due if next_due is not None else None
                )
            except asyncio.TimeoutError:
                pass

    async def drain(self, max_items: int = 1024, max_wait: float = 0.005) -> list[Item]:
        """Batch get: await the first ready item, then keep collecting until
        the queue momentarily empties or ``max_items`` is hit.

        ``max_wait`` is the micro-batching window — the latency/batch-size
        dial for p99 convergence (SURVEY.md §7.3).
        """
        first = await self.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + max_wait
        while len(batch) < max_items:
            self._promote_delayed()
            if self._ready:
                item = self._ready.popleft()
                self._pending.discard(item)
                self._processing.add(item)
                self._took(item, time.monotonic())
                batch.append(item)
                continue
            remaining = deadline - time.monotonic()
            if remaining <= 0 or self._shutdown:
                break
            self._wakeup.clear()
            try:
                await asyncio.wait_for(self._wakeup.wait(), timeout=remaining)
            except asyncio.TimeoutError:
                break
        self._depth_gauge.set(len(self))
        return batch

    def done(self, item: Item) -> None:
        self._processing.discard(item)
        if item in self._redo:
            self._redo.discard(item)
            self.add(item)

    # ----------------------------------------------------------- control

    def shut_down(self) -> None:
        self._shutdown = True
        self._wakeup.set()

    def __len__(self) -> int:
        return len(self._ready) + len(self._delayed)

    @property
    def shutting_down(self) -> bool:
        return self._shutdown
