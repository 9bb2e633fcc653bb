"""Circuit breaker for remote I/O (RestClient, remote-store frontends).

A dead peer must fail FAST: without a breaker, every verb against an
unreachable backend eats a full connect timeout (30 s here) on the
store-I/O executor — a handful of stuck requests and the serving loop's
thread pool is gone. The breaker trips after ``failure_threshold``
consecutive transport failures; while OPEN every call fails immediately
with :class:`~kcp_tpu_torch.utils.errors.UnavailableError`; after a jittered
exponential backoff one HALF_OPEN probe is let through — success closes
the circuit, failure re-opens it with a doubled (capped) interval.

Only *transport* failures count (connection refused/reset, timeouts):
an HTTP error status is the peer answering, which is the opposite of
dead. Jitter comes from a per-breaker seeded PRNG so fault-injection
schedules stay replayable (KCP_FAULTS contract, kcp_tpu_torch/faults.py).

State is exported on the metrics registry: ``circuit_state`` (0 closed /
1 open / 2 half-open; per-breaker gauges carry a sanitized name suffix),
``circuit_open_total`` and ``circuit_fastfail_total``.
"""

from __future__ import annotations

import logging
import random
import re
import threading
import time

from ..analysis.sanitize import make_lock

from .errors import UnavailableError
from .trace import REGISTRY

log = logging.getLogger(__name__)

CLOSED, OPEN, HALF_OPEN = 0, 1, 2
_STATE_NAMES = {CLOSED: "closed", OPEN: "open", HALF_OPEN: "half-open"}


def _metric_suffix(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_]", "_", name)


class CircuitBreaker:
    """Thread-safe three-state breaker around one remote peer."""

    def __init__(self, name: str, failure_threshold: int = 5,
                 reset_timeout: float = 0.5, max_timeout: float = 30.0,
                 jitter: float = 0.2, clock=time.monotonic,
                 seed: int | str | None = None):
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self.max_timeout = max_timeout
        self.jitter = jitter
        self._clock = clock
        self._rng = random.Random(seed if seed is not None else name)
        self._lock = make_lock("circuit.breaker")
        self._state = CLOSED
        self._failures = 0
        self._backoff = reset_timeout
        self._probe_at = 0.0
        self._set_gauges()

    # ------------------------------------------------------------- state

    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    def _set_gauges(self) -> None:
        REGISTRY.gauge(
            "circuit_state",
            "most recent breaker transition: 0 closed, 1 open, 2 half-open",
        ).set(self._state)
        REGISTRY.gauge(
            f"circuit_state_{_metric_suffix(self.name)}",
            f"breaker state for {self.name}: 0 closed, 1 open, 2 half-open",
        ).set(self._state)

    def _transition(self, state: int) -> None:
        if state != self._state:
            log.info("circuit %s: %s -> %s", self.name,
                     _STATE_NAMES[self._state], _STATE_NAMES[state])
        self._state = state
        self._set_gauges()

    # ------------------------------------------------------------- calls

    def allow(self) -> bool:
        """True if a call may proceed. An OPEN breaker past its backoff
        deadline admits exactly one HALF_OPEN probe; everything else
        while not CLOSED is refused."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN and self._clock() >= self._probe_at:
                self._transition(HALF_OPEN)
                return True
            return False

    def check(self) -> None:
        """:meth:`allow` or raise UnavailableError (the fail-fast path)."""
        if not self.allow():
            REGISTRY.counter(
                "circuit_fastfail_total",
                "calls refused immediately by an open circuit breaker").inc()
            raise UnavailableError(
                f"circuit breaker open for {self.name} "
                f"(retry in <= {self._backoff:.2f}s)")

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._backoff = self.reset_timeout
            if self._state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == HALF_OPEN:
                # failed probe: re-open with doubled, capped backoff
                self._backoff = min(self._backoff * 2, self.max_timeout)
                self._open()
            elif (self._state == CLOSED
                  and self._failures >= self.failure_threshold):
                self._backoff = self.reset_timeout
                self._open()

    def _open(self) -> None:
        delay = self._backoff * (1.0 + self.jitter * self._rng.random())
        self._probe_at = self._clock() + delay
        self._transition(OPEN)
        REGISTRY.counter(
            "circuit_open_total",
            "breaker trips (closed/half-open -> open)").inc()
        log.warning("circuit %s: OPEN for %.2fs after %d consecutive "
                    "failures", self.name, delay, self._failures)
