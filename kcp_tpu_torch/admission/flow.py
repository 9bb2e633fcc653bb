"""APF-style flow control for the write path.

Kubernetes' API Priority and Fairness (KEP-1040) is the proven design
for the overload shape this server faces: one tenant flooding writes
must not starve the other 9,999. The machinery, scaled to this repo:

- **classification**: every mutating request maps to a *flow*
  ``(tenant, verb-class)`` — the target logical cluster crossed with the
  verb (create/update/delete each get their own bucket, so a create
  flood cannot starve the same tenant's deletes);
- **per-flow token buckets**: each flow refills at ``rate`` tokens/s up
  to ``burst``; a request with no token is rejected immediately with
  429 + a precise ``Retry-After`` computed from the refill rate — the
  flooding tenant is throttled at its budget, not queued unboundedly;
- **shuffle-sharded bounded queues**: requests holding a token but
  finding the global concurrency limit saturated wait in one of ``Q``
  bounded FIFO queues; each flow hashes (seeded, deterministic) to a
  small *hand* of candidate queues and enqueues on the shortest, so a
  misbehaving flow can poison at most its hand while everyone else's
  queues drain normally (the APF shuffle-sharding argument);
- **bounded everything**: a full candidate queue is 429, never an
  unbounded buffer.

The controller is event-loop-affine (the REST handler's serving loop);
the fast path — token available, free concurrency slot, nothing queued —
is a few dict/float ops and never allocates a future. Composition with
PR 2's degraded-mode machinery is by construction: a 429 is an HTTP
answer, so the client-side circuit breaker (transport failures only)
never trips on throttling, and the typed ``TooManyRequestsError`` gives
informers/syncers the pacing hint instead of a blind retry.

Reads never touch this module (zero-cost by omission: the handler only
classifies mutating verbs).
"""

from __future__ import annotations

import math
import os
import random
import time
from collections import deque

from ..faults import maybe_fail
from ..utils.errors import TooManyRequestsError
from ..utils.trace import REGISTRY

VERB_CLASSES = ("create", "update", "delete")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


class FlowController:
    """Token buckets + shuffle-sharded queues + global concurrency.

    ``concurrency=0`` disables flow control entirely (build_chain then
    wires no controller). All state lives on the serving loop.
    """

    def __init__(self, concurrency: int = 64, rate: float = 500.0,
                 burst: float | None = None, queues: int = 16,
                 queue_depth: int = 32, hand_size: int = 4,
                 seed: int = 0, clock=time.monotonic):
        self.concurrency = int(concurrency)
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else 2 * rate)
        self.queue_depth = int(queue_depth)
        self.hand_size = max(1, min(int(hand_size), int(queues)))
        self.seed = seed
        self._clock = clock
        self._in_flight = 0
        # shuffle shards: deque of (future, flow-id) waiters per queue
        self._queues: list[deque] = [deque() for _ in range(int(queues))]
        self._qdepth = 0  # waiters across all queues
        self._rr = 0  # round-robin dispatch pointer
        # per-flow interned state: plain python floats (the hot path is
        # one request at a time — scalar numpy would cost ufunc dispatch)
        self._fids: dict[tuple[str, str], int] = {}
        self._flow_keys: list[tuple[str, str]] = []
        self._tokens: list[float] = []
        self._last: list[float] = []
        self._hand: list[tuple[int, ...]] = []
        self._wait_hist = REGISTRY.histogram(
            "flow_wait_seconds", "time requests spent queued by flow control")
        self._depth_gauge = REGISTRY.gauge(
            "flow_queue_depth", "requests currently parked in flow queues")
        self._rejected = REGISTRY.counter(
            "flow_rejected_total", "requests rejected 429 by flow control")
        # one bound method reused by every fast-path admit (and by the
        # chain's shared FastTicket) instead of a fresh binding per call
        self._release_cb = self.release

    @classmethod
    def from_env(cls) -> "FlowController | None":
        """KCP_FLOW_* environment knobs; KCP_FLOW_CONCURRENCY=0 = off."""
        concurrency = _env_int("KCP_FLOW_CONCURRENCY", 64)
        if concurrency <= 0:
            return None
        rate = _env_float("KCP_FLOW_RATE", 500.0)
        return cls(
            concurrency=concurrency,
            rate=rate,
            burst=_env_float("KCP_FLOW_BURST", 2 * rate),
            queues=_env_int("KCP_FLOW_QUEUES", 16),
            queue_depth=_env_int("KCP_FLOW_QUEUE_DEPTH", 32),
            hand_size=_env_int("KCP_FLOW_HAND", 4),
            seed=_env_int("KCP_FLOW_SEED", 0),
        )

    # -------------------------------------------------------------- flows

    def _fid(self, tenant: str, verb_class: str) -> int:
        fid = self._fids.get((tenant, verb_class))
        if fid is None:
            fid = len(self._tokens)
            self._fids[(tenant, verb_class)] = fid
            self._flow_keys.append((tenant, verb_class))
            self._tokens.append(self.burst)
            self._last.append(self._clock())
            # deterministic shuffle shard: the flow's hand of candidate
            # queues from a seeded PRNG keyed by the flow identity
            rnd = random.Random(f"{self.seed}:{tenant}:{verb_class}")
            self._hand.append(tuple(
                rnd.sample(range(len(self._queues)), self.hand_size)))
        return fid

    # ------------------------------------------------------------ admit

    def try_acquire(self, tenant: str, verb_class: str):
        """Admit one mutating request. Returns the release callable on
        the fast path (token + free concurrency slot); returns the flow
        id (int) when the caller must ``await queue_wait(fid)``; raises
        TooManyRequestsError (with ``retry_after``) on token exhaustion
        or a full candidate queue. ``admission.flow`` is a KCP_FAULTS
        injection point."""
        maybe_fail("admission.flow")
        fid = self._fids.get((tenant, verb_class))
        if fid is None:
            fid = self._fid(tenant, verb_class)
        tokens_l = self._tokens
        last_l = self._last
        now = self._clock()
        tokens = tokens_l[fid] + (now - last_l[fid]) * self.rate
        burst = self.burst
        if tokens > burst:
            tokens = burst
        last_l[fid] = now
        if tokens < 1.0:
            tokens_l[fid] = tokens
            self._reject(tenant, verb_class,
                         retry_after=(1.0 - tokens) / self.rate)
        tokens_l[fid] = tokens - 1.0
        if self._in_flight < self.concurrency and not self._qdepth:
            # fast path: free slot, nobody queued ahead
            self._in_flight += 1
            return self._release_cb
        q = min((self._queues[i] for i in self._hand[fid]), key=len)
        if len(q) >= self.queue_depth:
            self._reject(tenant, verb_class, retry_after=1.0)
        return fid

    async def queue_wait(self, fid: int):
        """Park in the flow's shortest candidate queue until a released
        slot dispatches us; returns the release callable."""
        import asyncio

        q = min((self._queues[i] for i in self._hand[fid]), key=len)
        if len(q) >= self.queue_depth:
            # the queue filled between try_acquire and here
            tenant, verb_class = self._flow_keys[fid]
            self._reject(tenant, verb_class, retry_after=1.0)
        fut = asyncio.get_running_loop().create_future()
        q.append(fut)
        self._qdepth += 1
        self._depth_gauge.set(self._qdepth)
        # liveness: cancelled waiters (disconnected clients) linger in
        # the queues until popped, so _qdepth can be nonzero with free
        # slots — run a dispatch pass so this waiter never parks behind
        # ghosts when capacity is actually available
        if self._in_flight < self.concurrency:
            self._dispatch()
        t0 = self._clock()
        try:
            await fut
        except asyncio.CancelledError:
            # client went away while queued: either give the slot back
            # (we were already dispatched) or just leave the queue (the
            # dispatcher skips cancelled futures)
            if fut.done() and not fut.cancelled():
                self.release()
            raise
        finally:
            self._wait_hist.observe(self._clock() - t0)
        return self._release_cb

    async def acquire(self, tenant: str, verb_class: str):
        """try_acquire + queue_wait in one call (tests, simple callers)."""
        got = self.try_acquire(tenant, verb_class)
        if isinstance(got, int):
            return await self.queue_wait(got)
        return got

    def _reject(self, tenant: str, verb_class: str, retry_after: float):
        self._rejected.inc()
        err = TooManyRequestsError(
            f'write flow ({tenant}, {verb_class}) is over its budget')
        err.retry_after = max(0.05, math.ceil(retry_after * 20) / 20)
        raise err

    def release(self) -> None:
        """Free a concurrency slot and dispatch the next queued waiter."""
        self._in_flight -= 1
        if self._qdepth:
            self._dispatch()

    def _dispatch(self) -> None:
        """Hand free concurrency slots to queued waiters, round-robin
        across shuffle-shard queues (per-queue FIFO, no queue starves);
        cancelled waiters are skimmed off on the way."""
        while self._in_flight < self.concurrency and self._qdepth:
            dispatched = False
            nq = len(self._queues)
            for off in range(nq):
                q = self._queues[(self._rr + off) % nq]
                while q:
                    fut = q.popleft()
                    self._qdepth -= 1
                    if fut.cancelled():
                        continue
                    self._rr = (self._rr + off + 1) % nq
                    self._in_flight += 1
                    fut.set_result(None)
                    dispatched = True
                    break
                if dispatched:
                    break
            if not dispatched:
                break
        self._depth_gauge.set(self._qdepth)
