"""Observability: metrics registry, timing spans, device profiling.

The reference has no first-party tracing — its forked apiserver serves
standard ``/metrics`` and ``/debug/pprof`` endpoints that nothing in the
repo touches (SURVEY.md §5). For a TPU control plane that is not enough:
the interesting time is split between host orchestration (asyncio
controllers, encode, apply) and device ticks (launch, transfer, kernel
time), so this module provides

- a process-global :class:`Registry` of counters / gauges / histograms
  with Prometheus-style text exposition (served at ``/metrics`` by the
  API server),
- :func:`span` — a context manager timing a named section into a
  histogram (host-side structured timing),
- :func:`device_trace` — a context manager around ``torch.profiler``
  writing a Chrome trace (``trace.json``) when deeper device attribution
  is needed.

Everything is dependency-free and safe to call on hot paths: a span is
two ``perf_counter`` calls and a dict update.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from bisect import bisect_left
from dataclasses import dataclass, field

from ..analysis.sanitize import make_lock

log = logging.getLogger(__name__)

_DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# small-integer occupancy histograms (e.g. the fused tick pipeline's
# in-flight depth, ``fused_pipeline_depth``): the time-shaped default
# edges would fold every observation into one bucket
DEPTH_BUCKETS = (0.0, 1.0, 2.0, 3.0, 4.0, 8.0)

# count-shaped histograms (batch sizes, e.g. ``watch_fanout_batch_size``):
# powers of two up to the store's emit-batch ceiling
SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0)


@dataclass
class Counter:
    name: str
    help: str = ""
    value: float = 0.0
    # REST clients, the store-I/O pool, and the router's scatter executor
    # all inc() off the serving loop: `self.value += amount` is a
    # read-add-store that can drop increments under thread interleaving.
    # A plain leaf lock (never held while acquiring anything else) keeps
    # the hot path one uncontended acquire.
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
        # that bucket (Prometheus's inclusive `le` semantics). The lock
        # makes the three mutations one transaction — observe() runs on
        # executor threads too, and a torn counts/total/n triple yields
        # impossible exposition (count < bucket cum sums).
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

    def histogram(self, name: str, help: str = "", buckets: tuple = _DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_make(name, lambda: Histogram(name, help, buckets))

    def _get_or_make(self, name, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            return m

    @staticmethod
    def _escape_help(text: str) -> str:
        """Prometheus text-format HELP escaping: backslash and newline
        are the two characters the exposition grammar reserves — an
        unescaped newline in help text splits the line and corrupts
        every scrape of the whole page."""
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


TRACE_FILE = "trace.json"

_trace_warm_lock = make_lock("trace.warm")
_trace_warmed = False


def _trace_activities() -> list:
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return activities


def warm_device_trace() -> None:
    """Start and stop one empty profiler session, once per process.

    A process's first profiler session initialises the profiler's tracing
    libraries, which takes seconds with CUDA. :func:`device_trace` calls
    this from a worker thread, which keeps that start-up off the serving
    loop, so the session it then starts on the loop starts in
    milliseconds. That session itself stays on the loop's thread: the
    profiler records the CPU ops of the thread that starts it, and
    stopping it from another thread fails."""
    global _trace_warmed
    from torch.autograd import profiler as autograd_profiler
    from torch.profiler import profile

    with _trace_warm_lock:
        if _trace_warmed or autograd_profiler._is_profiler_enabled:
            return
        try:
            prof = profile(activities=_trace_activities())
            prof.start()
            prof.stop()
        except Exception as e:  # noqa: BLE001 — device_trace reports its own
            log.warning("device trace warm-up failed: %s", e)
        _trace_warmed = True


@contextlib.asynccontextmanager
async def device_trace(log_dir: str, timings: dict):
    """``torch.profiler`` trace around a block of the running loop, written
    as a Chrome trace to ``log_dir/trace.json`` (open it in Perfetto or
    chrome://tracing).

    Records CUDA activity when a card is present, CPU activity always,
    of the loop's thread. The profiler's one-time start-up
    (:func:`warm_device_trace`) and the file's export run in worker
    threads; the session starts and stops on the loop, whose CPU ops it
    records. ``timings`` receives the seconds of each step
    (``warm_s``, ``start_s``, ``stop_s``, ``export_s``). Yields whether
    the profiler started; when it cannot (another profiler session is
    active in this process, or the profiler is unavailable) the block
    runs untraced and nothing is written.
    """
    import asyncio

    from torch.autograd import profiler as autograd_profiler
    from torch.profiler import profile

    t = timings
    t0 = time.perf_counter()
    await asyncio.to_thread(warm_device_trace)
    t["warm_s"] = time.perf_counter() - t0
    prof = None
    if autograd_profiler._is_profiler_enabled:
        # a second session would take over (and end) the running one
        log.warning("device trace did not start: another profiler session is active")
    else:
        try:
            t0 = time.perf_counter()
            prof = profile(activities=_trace_activities())
            prof.start()
            t["start_s"] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — report, run untraced
            log.warning("device trace did not start: %s", e)
            prof = None
    try:
        yield prof is not None
    finally:
        if prof is not None:
            try:
                t0 = time.perf_counter()
                prof.stop()
                t["stop_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                os.makedirs(log_dir, exist_ok=True)
                await asyncio.to_thread(prof.export_chrome_trace,
                                        os.path.join(log_dir, TRACE_FILE))
                t["export_s"] = time.perf_counter() - t0
            except Exception as e:  # noqa: BLE001 — the caller sees no file
                log.warning("device trace not written: %s", e)


# ---------------------------------------------------------------------------
# Host profiling (the reference inherits /debug/pprof from its generic
# apiserver chain, pkg/server/server.go:145; this is the asyncio-native
# analog): a sampling wall profiler over every thread's stack plus an
# asyncio task dump, served at /debug/profile by the REST handler.
# ---------------------------------------------------------------------------


def dump_tasks() -> list[dict]:
    """All live asyncio tasks of the running loop with their current
    coroutine stacks — who is waiting where."""
    import asyncio

    try:
        loop = asyncio.get_running_loop()
    except RuntimeError:
        return []
    out = []
    for t in asyncio.all_tasks(loop):
        frames = []
        for f in t.get_stack(limit=8):
            frames.append(f"{f.f_code.co_filename.rsplit('/', 1)[-1]}:"
                          f"{f.f_lineno} {f.f_code.co_name}")
        out.append({
            "name": t.get_name(),
            "coro": getattr(t.get_coro(), "__qualname__", str(t.get_coro())),
            "done": t.done(),
            "stack": frames,
        })
    return sorted(out, key=lambda d: d["name"])


def _sample_once(agg: dict, skip_thread: int) -> None:
    import sys

    for tid, frame in sys._current_frames().items():
        if tid == skip_thread:
            continue
        stack = []
        f = frame
        depth = 0
        while f is not None and depth < 24:
            stack.append(f"{f.f_code.co_filename.rsplit('/', 1)[-1]}:"
                         f"{f.f_lineno} {f.f_code.co_name}")
            f = f.f_back
            depth += 1
        key = (tid, tuple(stack))
        agg[key] = agg.get(key, 0) + 1


async def sample_profile(seconds: float = 2.0, hz: float = 97.0) -> dict:
    """Statistical wall profile: a sampler thread walks every thread's
    stack at ~hz for ``seconds`` while the loop keeps serving. Returns
    aggregated stacks with sample counts (top 20), plus the asyncio task
    dump and the span/metric snapshot — everything needed to answer
    "where does tick time go" without stopping the server."""
    import asyncio
    import threading

    seconds = max(0.1, min(float(seconds), 10.0))
    agg: dict = {}
    done = threading.Event()

    def run() -> None:
        me = threading.get_ident()
        interval = 1.0 / hz
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            _sample_once(agg, me)
            time.sleep(interval)
        done.set()

    t = threading.Thread(target=run, name="kcp-profiler", daemon=True)
    tasks_before = dump_tasks()
    t.start()
    while not done.is_set():
        await asyncio.sleep(0.02)

    names = {th.ident: th.name for th in threading.enumerate()}
    total = sum(agg.values()) or 1
    stacks = sorted(agg.items(), key=lambda kv: -kv[1])[:20]
    return {
        "seconds": seconds,
        "samples": total,
        "stacks": [
            {
                "thread": names.get(tid, str(tid)),
                "count": n,
                "pct": round(100.0 * n / total, 1),
                "stack": list(stack),
            }
            for (tid, stack), n in stacks
        ],
        "tasks": tasks_before,
        "spans": REGISTRY.snapshot(),
    }
