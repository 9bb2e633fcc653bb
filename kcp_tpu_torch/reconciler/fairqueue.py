"""FairWorkQueue: the native per-tenant-fair queue behind the WorkQueue
interface.

Cross-tenant controllers (negotiation, cluster lifecycle, namespace
sweep) share one queue across every logical cluster; with plain FIFO a
tenant flooding events starves the rest. The native scheduler
(native/workqueue.cc) keeps the client-go contract — dedup while
pending, per-item exponential backoff, redo-after-done — and drains
round-robin across tenants, so each batch carries at most one item per
tenant per pass.

Drop-in for :class:`kcp_tpu_torch.reconciler.queue.WorkQueue` (same methods,
same Controller/BatchController compatibility). ``tenant_of`` maps an
item to its tenant; the default treats tuple items' first element as
the tenant (the (cluster, name) key shape every controller here uses).
When the native library is unavailable, :func:`make_queue` falls back
to the plain WorkQueue — correctness intact, fairness best-effort.
"""

from __future__ import annotations

import asyncio
import ctypes
import time
from typing import Callable, Hashable

from .queue import WorkQueue, queue_metrics

Item = Hashable


def _default_tenant(item: Item) -> str:
    if isinstance(item, tuple) and item:
        return str(item[0])
    return ""


class FairWorkQueue:
    """WorkQueue-compatible wrapper over the native fair scheduler."""

    def __init__(self, name: str = "fairqueue",
                 tenant_of: Callable[[Item], str] = _default_tenant):
        from ..native import load

        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._q = lib.wq_new()
        self.name = name
        self.tenant_of = tenant_of
        self._ids: dict[Item, int] = {}
        self._items: dict[int, Item] = {}
        self._next_id = 1
        self._tenants: dict[str, int] = {}
        self._wakeup = asyncio.Event()
        self._shutdown = False
        # backpressure observables (see queue.queue_metrics): queue time
        # is measured from immediate adds only — delayed/rate-limited
        # requeues would fold their intentional backoff into the
        # histogram and hide real queueing
        self._depth_gauge, self._wait_hist = queue_metrics(name)
        self._enq_t: dict[int, float] = {}

    # ---------------------------------------------------------- id mapping

    def _id(self, item: Item) -> int:
        i = self._ids.get(item)
        if i is None:
            i = self._next_id
            self._next_id += 1
            self._ids[item] = i
            self._items[i] = item
        return i

    def _tenant(self, item: Item) -> int:
        t = self.tenant_of(item)
        tid = self._tenants.get(t)
        if tid is None:
            tid = len(self._tenants)
            self._tenants[t] = tid
        return tid

    # -------------------------------------------------------------- adding

    def add(self, item: Item) -> None:
        if self._shutdown:
            return
        i = self._id(item)
        self._lib.wq_add(self._q, i, self._tenant(item))
        self._enq_t.setdefault(i, time.monotonic())
        self._depth_gauge.set(self._lib.wq_len(self._q))
        self._wakeup.set()

    def add_many(self, items) -> None:
        """Batch add: one ctypes crossing + one wakeup for a whole
        churn/feedback batch (the round-4 profile's top host cost)."""
        if self._shutdown:
            return
        items = list(items)
        n = len(items)
        if not n:
            return
        ids = (ctypes.c_uint64 * n)()
        tenants = (ctypes.c_uint32 * n)()
        now = time.monotonic()  # one clock read for the whole batch
        enq = self._enq_t
        for j, item in enumerate(items):
            i = self._id(item)
            ids[j] = i
            tenants[j] = self._tenant(item)
            enq.setdefault(i, now)
        self._lib.wq_add_many(self._q, ids, tenants, n)
        self._depth_gauge.set(self._lib.wq_len(self._q))
        self._wakeup.set()

    def complete_many(self, items, forget_flags) -> None:
        """Batch forget+done for a processed tick batch; releases the id
        interning of every item that left the queue."""
        items = list(items)
        n = len(items)
        if not n:
            return
        ids = (ctypes.c_uint64 * n)()
        forgets = (ctypes.c_uint8 * n)()
        released = (ctypes.c_uint8 * n)()
        known: list[tuple[int, Item, int]] = []
        for item, fg in zip(items, forget_flags):
            i = self._ids.get(item)
            if i is None:
                continue
            j = len(known)
            ids[j] = i
            forgets[j] = 1 if fg else 0
            known.append((j, item, i))
        if not known:
            return
        self._lib.wq_complete_many(self._q, ids, forgets, len(known), released)
        for j, item, i in known:
            if released[j]:
                del self._ids[item]
                del self._items[i]
                self._enq_t.pop(i, None)
        # done() may have requeued redo items natively — wake any getter
        self._wakeup.set()

    def add_after(self, item: Item, delay: float) -> None:
        if self._shutdown:
            return
        self._lib.wq_add_after(self._q, self._id(item), self._tenant(item),
                               time.monotonic(), delay)
        self._wakeup.set()

    def add_rate_limited(self, item: Item) -> None:
        if self._shutdown:
            return
        self._lib.wq_add_rate_limited(self._q, self._id(item),
                                      self._tenant(item), time.monotonic())
        self._wakeup.set()

    def num_requeues(self, item: Item) -> int:
        i = self._ids.get(item)
        return self._lib.wq_num_requeues(self._q, i) if i is not None else 0

    def forget(self, item: Item) -> None:
        i = self._ids.get(item)
        if i is not None:
            self._lib.wq_forget(self._q, i)
            self._release(item, i)

    def _release(self, item: Item, i: int) -> None:
        """Drop the id interning once the queue no longer references the
        id anywhere — without this, high-churn keys leak the maps."""
        if self._lib.wq_release(self._q, i):
            del self._ids[item]
            del self._items[i]
            self._enq_t.pop(i, None)

    # ------------------------------------------------------------ consuming

    def _pop_ready(self, max_items: int) -> list[Item]:
        buf = (ctypes.c_uint64 * max_items)()
        now = time.monotonic()
        n = self._lib.wq_drain(self._q, now, buf, max_items)
        if n:
            enq = self._enq_t
            observe = self._wait_hist.observe
            for i in range(n):
                t = enq.pop(buf[i], None)
                if t is not None:
                    observe(now - t)
            self._depth_gauge.set(self._lib.wq_len(self._q))
        return [self._items[buf[i]] for i in range(n)]

    async def get(self) -> Item | None:
        while True:
            got = self._pop_ready(1)
            if got:
                return got[0]
            if self._shutdown:
                return None
            next_due = self._lib.wq_promote(self._q, time.monotonic())
            # promote may itself have moved a just-due item into the ready
            # ring; re-check before sleeping or that item is stranded until
            # the next add() (there may be no further delayed entries to
            # bound the wait)
            got = self._pop_ready(1)
            if got:
                return got[0]
            self._wakeup.clear()
            try:
                await asyncio.wait_for(
                    self._wakeup.wait(),
                    timeout=next_due if next_due >= 0 else None)
            except asyncio.TimeoutError:
                pass

    async def drain(self, max_items: int = 1024, max_wait: float = 0.005) -> list[Item]:
        first = await self.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + max_wait
        while len(batch) < max_items:
            more = self._pop_ready(max_items - len(batch))
            if more:
                batch.extend(more)
                continue
            remaining = deadline - time.monotonic()
            if remaining <= 0 or self._shutdown:
                break
            self._wakeup.clear()
            try:
                await asyncio.wait_for(self._wakeup.wait(), timeout=remaining)
            except asyncio.TimeoutError:
                break
        return batch

    def done(self, item: Item) -> None:
        i = self._ids.get(item)
        if i is not None:
            self._lib.wq_done(self._q, i)
            # done() may have re-queued a redo item natively — wake any
            # getter so it is not stranded until the next add()
            self._wakeup.set()
            self._release(item, i)

    # ------------------------------------------------------------- control

    def shut_down(self) -> None:
        self._shutdown = True
        self._wakeup.set()

    def __len__(self) -> int:
        return self._lib.wq_len(self._q)

    @property
    def shutting_down(self) -> bool:
        return self._shutdown

    def __del__(self):
        if getattr(self, "_q", None):
            self._lib.wq_free(self._q)
            self._q = None


def make_queue(name: str = "queue",
               tenant_of: Callable[[Item], str] = _default_tenant):
    """FairWorkQueue when the native library loads, else WorkQueue."""
    try:
        return FairWorkQueue(name, tenant_of)
    except RuntimeError:  # native library unavailable
        return WorkQueue(name)
