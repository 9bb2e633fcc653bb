"""Race detection for the asyncio control plane — the `go test -race` analog.

The reference's CI runs every test under Go's race detector
(.github/workflows/ci.yaml:64, SURVEY.md §5); its controllers are
goroutine soups where unsynchronized access is the failure mode. This
framework's concurrency model is different — ONE asyncio loop owns all
mutable control-plane state (store, informer caches, fused buckets), and
threads exist only at the edges (ServerThread embedding, applier
handoffs, the profiler) — so the race class to detect is exactly one:
**state touched from a thread that does not own it**. That is also
precisely what Go's detector catches: cross-goroutine unsynchronized
access.

Two tools:

- :class:`AffinityGuard` — objects register their owning thread at
  creation; ``check()`` asserts the caller is that thread. Zero-cost
  when disabled (``enabled()`` is False unless KCP_RACE=1); under
  KCP_RACE=1 every store mutation is affinity-checked, so the whole test
  suite runs race-checked the way `go test -race ./...` does.
- :class:`LoopWatchdog` — a sampling thread that measures event-loop
  callback latency; a loop stalled past the threshold is the asyncio
  analog of a blocked scheduler (a reconcile doing synchronous I/O on
  the tick loop), reported with the stacks captured by the profiler
  machinery (utils/trace.py).
"""

from __future__ import annotations

import asyncio
import logging
import os
import threading
import time

log = logging.getLogger(__name__)

_ENV = "KCP_RACE"


def enabled() -> bool:
    return os.environ.get(_ENV, "") == "1"


class RaceError(AssertionError):
    """Unsynchronized cross-thread access to loop-owned state."""


class AffinityGuard:
    """Thread-affinity assertion for loop-owned state.

    The owner is (re)bound lazily: the first checked access from a
    thread CLAIMS the object if it is unowned — objects built on a main
    thread and then handed to a server loop re-home on first use there
    (``rebind()`` makes the handoff explicit). After that, access from
    any other thread raises :class:`RaceError` naming both threads.
    """

    __slots__ = ("name", "_owner", "_owner_name")

    def __init__(self, name: str):
        self.name = name
        self._owner: int | None = None
        self._owner_name = ""

    def rebind(self) -> None:
        """Explicitly hand ownership to the current thread (the embedding
        seam: ServerThread moving a store into its loop)."""
        t = threading.current_thread()
        self._owner, self._owner_name = t.ident, t.name

    def check(self) -> None:
        if not enabled():
            return
        t = threading.current_thread()
        if self._owner is None:
            self._owner, self._owner_name = t.ident, t.name
            return
        if t.ident != self._owner:
            raise RaceError(
                f"race detected: {self.name} is owned by thread "
                f"{self._owner_name!r} but was mutated from {t.name!r} — "
                f"loop-owned state must only be touched on its loop "
                f"(hand off with call_soon_threadsafe / run_coroutine_"
                f"threadsafe, or rebind() at an explicit ownership seam)")


class LoopWatchdog:
    """Detect event-loop stalls (a blocked tick loop = a blocked
    scheduler). A daemon thread schedules a heartbeat callback onto the
    loop at ``interval`` and measures how long it takes to run; latency
    over ``threshold`` logs the offending stack via the profiler's
    sampler."""

    def __init__(self, loop: asyncio.AbstractEventLoop,
                 threshold: float = 0.25, interval: float = 0.05):
        self.loop = loop
        self.threshold = threshold
        self.interval = interval
        self.stalls: list[float] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "LoopWatchdog":
        self._thread = threading.Thread(
            target=self._run, name="kcp-loop-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        # no join: stop() is typically called from the monitored loop
        # itself (Server.shutdown) — joining would block the loop on a
        # heartbeat that cannot run while the loop is blocked, freezing
        # shutdown and then logging a spurious stall. The daemon thread
        # observes _stop and exits on its own.
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            seen = threading.Event()
            t0 = time.perf_counter()
            try:
                self.loop.call_soon_threadsafe(seen.set)
            except RuntimeError:  # loop closed
                return
            # wait generously; a stall is measured, not assumed
            seen.wait(timeout=max(self.threshold * 40, 10.0))
            dt = time.perf_counter() - t0
            if dt > self.threshold and not self._stop.is_set():
                self.stalls.append(dt)
                from .trace import _sample_once

                agg: dict = {}
                _sample_once(agg, threading.get_ident())
                top = sorted(agg.items(), key=lambda kv: -kv[1])[:3]
                frames = [list(stack)[:5] for (_tid, stack), _n in top]
                log.warning(
                    "event loop stalled %.3fs (> %.3fs): a callback blocked "
                    "the reconcile loop; top stacks: %s", dt, self.threshold,
                    frames)
            self._stop.wait(self.interval)
