"""Controller runtime: the reconcile pattern with a swappable backend.

The reference replicates one pattern in every controller (SURVEY.md §1
layer 5): informer -> rate-limited workqueue -> N worker goroutines ->
``process(key)`` -> reconcile -> status write; 5 retries then drop;
RetryableError retries forever (pkg/reconciler/cluster/
controller.go:226-263).

This runtime keeps that contract but makes the execution model swappable:

- :class:`Controller` — item-at-a-time async workers (``Backend=host``),
  the differential-testing reference path
- :class:`BatchController` — a reconcile *tick*: drain the queue into a
  batch, hand the whole batch to ``process_batch`` (which typically
  encodes it and runs one batched device step), apply the returned
  effects. One batched step across all logical clusters instead of a
  goroutine per key — the fused device backend.

Retry semantics are identical in both: items whose processing raised are
requeued rate-limited up to ``max_retries`` (then dropped), RetryableError
indefinitely.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Awaitable, Callable, Iterable, Sequence

from ..utils.errors import is_retryable
from .fairqueue import make_queue
from .queue import Item, WorkQueue

log = logging.getLogger(__name__)

DEFAULT_RETRIES = 5

ProcessFn = Callable[[Item], Awaitable[None]]
# process_batch returns the items that FAILED (to be retried); everything
# else in the batch is considered reconciled.
ProcessBatchFn = Callable[[Sequence[Item]], Awaitable[Iterable[tuple[Item, Exception]]]]


class Controller:
    """Item-at-a-time controller (the host reference backend).

    The default queue is per-tenant fair (:func:`make_queue`: the native
    FairWorkQueue when the library loads, plain WorkQueue otherwise).
    ``tenant_of`` maps an item to its fairness key; the default uses a
    tuple item's first element — pass a custom extractor when the tenant
    sits deeper in the item shape.
    """

    def __init__(
        self,
        name: str,
        process: ProcessFn,
        queue: WorkQueue | None = None,
        max_retries: int = DEFAULT_RETRIES,
        tenant_of=None,
    ):
        self.name = name
        if queue is None:
            queue = make_queue(name, tenant_of) if tenant_of else make_queue(name)
        self.queue = queue
        self.process = process
        self.max_retries = max_retries
        self._workers: list[asyncio.Task] = []

    def enqueue(self, item: Item) -> None:
        self.queue.add(item)

    def enqueue_many(self, items) -> None:
        """Batch enqueue (one queue crossing; see WorkQueue.add_many)."""
        self.queue.add_many(items)

    def enqueue_after(self, item: Item, delay: float) -> None:
        self.queue.add_after(item, delay)

    async def start(self, num_workers: int = 2) -> None:
        """Spawn ``num_workers`` worker tasks (reference default 2,
        pkg/server/server.go:241,250)."""
        for i in range(num_workers):
            self._workers.append(asyncio.create_task(self._worker(i)))

    async def _worker(self, i: int) -> None:
        while True:
            item = await self.queue.get()
            if item is None:
                return
            try:
                await self.process(item)
            except Exception as err:  # noqa: BLE001 — reconcile errors are data
                self._handle_error(item, err)
            else:
                self.queue.forget(item)
            finally:
                self.queue.done(item)

    def _handle_error(self, item: Item, err: Exception) -> None:
        if is_retryable(err):
            log.info("%s: retryable error on %r: %s", self.name, item, err)
            self.queue.add_rate_limited(item)
            return
        if self.queue.num_requeues(item) < self.max_retries:
            log.info("%s: error on %r (retry %d): %s", self.name, item,
                     self.queue.num_requeues(item), err)
            self.queue.add_rate_limited(item)
            return
        log.warning("%s: dropping %r after %d retries: %s", self.name, item,
                    self.max_retries, err)
        self.queue.forget(item)

    async def stop(self) -> None:
        self.queue.shut_down()
        if self._workers:
            await asyncio.gather(*self._workers, return_exceptions=True)
        self._workers.clear()


class BatchController(Controller):
    """Tick-based controller: drain -> one batched reconcile -> apply.

    ``process_batch`` receives the deduped drained items and returns the
    (item, error) pairs that failed; those are retried under the same
    policy as :class:`Controller`. A single worker loop is enough — the
    parallelism lives inside the batch program, not in the scheduler.

    ``overlap_drain=True`` pipelines the drain stage: the NEXT tick's
    queue drain (including its ``batch_window`` micro-batching wait)
    runs concurrently with the CURRENT tick's processing, so a tick that
    dispatches a device step and applies a previous step's patches never
    serializes with event accumulation. Safe because drained items sit
    in the queue's ``_processing`` set until ``complete_many`` — a
    concurrent drain can never hand out an item the in-flight tick still
    owns (re-adds park in ``_redo`` exactly as without overlap).
    """

    def __init__(
        self,
        name: str,
        process_batch: ProcessBatchFn,
        queue: WorkQueue | None = None,
        max_retries: int = DEFAULT_RETRIES,
        max_batch: int = 4096,
        batch_window: float = 0.005,
        tenant_of=None,
        overlap_drain: bool = False,
    ):
        async def _unused(_: Item) -> None:  # pragma: no cover
            raise NotImplementedError

        super().__init__(name, _unused, queue, max_retries, tenant_of=tenant_of)
        self.process_batch = process_batch
        self.max_batch = max_batch
        self.batch_window = batch_window
        self.overlap_drain = overlap_drain
        self.ticks = 0
        self.items_processed = 0

    async def start(self, num_workers: int = 1) -> None:
        # one tick loop; num_workers kept for interface parity
        self._workers.append(asyncio.create_task(self._tick_loop()))

    async def _tick_loop(self) -> None:
        next_drain: asyncio.Task | None = None
        while True:
            if next_drain is not None:
                batch = await next_drain
                next_drain = None
            else:
                batch = await self.queue.drain(self.max_batch, self.batch_window)
            if not batch:
                if self.queue.shutting_down:
                    return
                continue
            if self.overlap_drain and not self.queue.shutting_down:
                # start draining the next batch NOW: its micro-batch
                # window elapses while this tick encodes/dispatches
                next_drain = asyncio.create_task(
                    self.queue.drain(self.max_batch, self.batch_window))
            self.ticks += 1
            self.items_processed += len(batch)
            try:
                failed = list(await self.process_batch(batch))
            except Exception as err:  # noqa: BLE001 — whole-batch failure
                log.exception("%s: batch tick failed", self.name)
                failed = [(item, err) for item in batch]
            failed_items = set()
            for item, err in failed:
                failed_items.add(item)
                self._handle_error(item, err)
            # one queue crossing for the whole batch (forget successes,
            # done everything), not one per item
            self.queue.complete_many(
                batch, [item not in failed_items for item in batch])
