"""Observability: metrics registry and timing spans (copy of the parts of
``kcp_tpu.utils.trace`` the serving core uses).

- a process-global :class:`Registry` of counters / gauges / histograms
  with Prometheus-style text exposition,
- :func:`span` — a context manager timing a named section into a
  histogram (host-side structured timing).

The reference's ``device_trace`` (a ``jax.profiler`` trace) has no
counterpart here yet; a ``torch.profiler`` version comes with a later
slice.
"""

from __future__ import annotations

import contextlib
import threading
import time
from bisect import bisect_left
from dataclasses import dataclass, field

from .locks import make_lock

_DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# small-integer occupancy histograms (e.g. the fused tick pipeline's
# in-flight depth, ``fused_pipeline_depth``): the time-shaped default
# edges would fold every observation into one bucket
DEPTH_BUCKETS = (0.0, 1.0, 2.0, 3.0, 4.0, 8.0)


@dataclass
class Counter:
    name: str
    help: str = ""
    value: float = 0.0
    # increments can come from executor threads: a read-add-store needs
    # a leaf lock (never held while acquiring anything else)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


@dataclass
class Gauge:
    name: str
    help: str = ""
    value: float = 0.0

    def set(self, value: float) -> None:
        self.value = value  # single store: atomic under the GIL


@dataclass
class Histogram:
    name: str
    help: str = ""
    buckets: tuple = _DEFAULT_BUCKETS
    counts: list = field(default_factory=list)
    total: float = 0.0
    n: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def __post_init__(self):
        if not self.counts:
            self.counts = [0] * (len(self.buckets) + 1)

    def observe(self, value: float) -> None:
        # bisect_left: an observation equal to a bucket edge belongs in
        # that bucket (Prometheus's inclusive `le` semantics)
        i = bisect_left(self.buckets, value)
        with self._lock:
            self.counts[i] += 1
            self.total += value
            self.n += 1

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def quantile(self, q: float) -> float:
        """Approximate quantile from bucket boundaries (upper edge)."""
        if not self.n:
            return 0.0
        target = q * self.n
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return self.buckets[i] if i < len(self.buckets) else float("inf")
        return float("inf")


class Registry:
    """Named metrics with Prometheus text exposition."""

    def __init__(self):
        self._lock = make_lock("trace.registry")
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_make(name, lambda: Counter(name, help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_make(name, lambda: Gauge(name, help))

    def histogram(self, name: str, help: str = "",
                  buckets: tuple = _DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_make(name, lambda: Histogram(name, help, buckets))

    def _get_or_make(self, name, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            return m

    @staticmethod
    def _escape_help(text: str) -> str:
        return text.replace("\\", "\\\\").replace("\n", "\\n")

    def expose(self) -> str:
        """Prometheus text format (the /metrics body)."""
        out: list[str] = []
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                if m.help:
                    out.append(f"# HELP {name} {self._escape_help(m.help)}")
                if isinstance(m, Counter):
                    out.append(f"# TYPE {name} counter")
                    out.append(f"{name} {m.value}")
                elif isinstance(m, Gauge):
                    out.append(f"# TYPE {name} gauge")
                    out.append(f"{name} {m.value}")
                else:
                    out.append(f"# TYPE {name} histogram")
                    with m._lock:
                        counts, total, n = list(m.counts), m.total, m.n
                    cum = 0
                    for edge, c in zip(m.buckets, counts):
                        cum += c
                        out.append(f'{name}_bucket{{le="{edge}"}} {cum}')
                    out.append(f'{name}_bucket{{le="+Inf"}} {n}')
                    out.append(f"{name}_sum {total}")
                    out.append(f"{name}_count {n}")
        return "\n".join(out) + "\n"

    def snapshot(self) -> dict:
        """Structured dump for tests/logging."""
        with self._lock:
            out = {}
            for name, m in self._metrics.items():
                if isinstance(m, (Counter, Gauge)):
                    out[name] = m.value
                else:
                    out[name] = {"count": m.n, "mean": m.mean,
                                 "p50": m.quantile(0.5), "p99": m.quantile(0.99)}
            return out


REGISTRY = Registry()


@contextlib.contextmanager
def span(name: str, registry: Registry = REGISTRY):
    """Time a section into histogram ``<name>_seconds``."""
    h = registry.histogram(f"{name}_seconds")
    t0 = time.perf_counter()
    try:
        yield
    finally:
        h.observe(time.perf_counter() - t0)
