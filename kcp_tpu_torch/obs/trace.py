"""Distributed tracing: W3C-traceparent contexts + per-process span buffers.

The reference punts on cross-process attribution — its forked apiserver
serves ``/metrics`` and ``/debug/pprof`` that nothing first-party touches
(SURVEY.md §5) — and upstream later closed the gap with API-server request
tracing (KEP-647, W3C ``traceparent`` propagation). This module is that
layer for the kcp-tpu fleet, Dapper-style:

- a :class:`TraceContext` (trace id, span id, sampled flag) minted by the
  first hop (RestClient or the serving handler) and propagated as a
  ``traceparent`` request header across router → shard → replica hops;
- head-based sampling (``KCP_TRACE_SAMPLE``, default 1-in-64) decided by
  a seeded coin BEFORE any ids are minted — the unsampled fast path
  costs one RNG draw, and a fixed ``KCP_TRACE_SEED`` reproduces the
  exact decision sequence; fault-injected runs (an active ``KCP_FAULTS``
  schedule) are always sampled, and the serving layer force-records
  requests that breach the SLO (``KCP_TRACE_SLO_MS``) even when the head
  decision said no;
- finished spans land in a bounded per-process ring buffer
  (``KCP_TRACE_BUFFER`` entries) served by ``GET /debug/trace?id=`` /
  ``?slowest=N`` — the router scatter-gathers shard buffers to assemble
  cross-process trees (:mod:`.assemble`);
- the fused tick loop's timeline: each reconcile tick of
  ``syncer.core.FusedCore`` takes a root from :meth:`Tracer.tick_context`
  (head-sampled, or every tick while the tracer is *armed*), and its
  stage spans are stamped on the wall clock that ``torch.profiler``'s
  events use, so they lay over a device trace. :meth:`Tracer.arm` /
  :meth:`Tracer.disarm` bracket a recording window: the spans of the
  ticks it traces go to an unbounded list, returned whole, instead of
  the ring, where every other span still goes;
- reconcile causality: a sampled spec write's context rides its WAL
  record (``rec["tc"]``) and its shared watch :class:`Event` (one stamp
  for every watcher, the shared-Event discipline), plus an
  object-identity link (:func:`link_obj`) so an in-process informer's
  snapshot resolves back to the committing trace with one dict probe;
- the convergence decomposition: :func:`phase` records one contiguous
  segment of the spec→status timeline as both a ``conv.<phase>`` span
  and a ``convergence_<phase>_seconds`` histogram — phases share
  boundary timestamps, so their sum telescopes to the end-to-end wall
  time by construction (the ``bench.py --trace`` reconciliation gate).

Wire neutrality is a hard contract: tracing adds a request header on
client hops and nothing else — response bytes, watch streams, and stored
objects are byte-identical with tracing on or off (``KCP_TRACE=0``
disables even the header), proven by the differential fuzz in
tests/test_tracing.py. Off-path cost when disabled is one attribute read
per hop; when enabled-but-unsampled, one contextvar read plus a
deterministic modulo per minted trace.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Iterator

from ..analysis.sanitize import make_lock
from ..utils.trace import REGISTRY

#: the W3C propagation header (lower-cased: the httpd lower-cases keys)
TRACEPARENT = "traceparent"

#: the convergence phases, in timeline order. ``write`` (client spec
#: write round trip), ``propagate`` (ack → syncer staged; derived from
#: span boundaries), ``stage`` (staged → tick start), ``tick`` (the
#: device/host reconcile tick that carried the row), ``patch`` (tick end
#: → downstream write applied), ``downstream`` (downstream status churn
#: → re-staged), ``upstatus`` (status upsync to the upstream store),
#: ``observe`` (status committed → the driver observed it; derived).
PHASES = ("write", "propagate", "stage", "tick", "patch", "downstream",
          "upstatus", "observe")

_current: contextvars.ContextVar["TraceContext | None"] = \
    contextvars.ContextVar("kcp_trace_ctx", default=None)

# lazily-bound faults module: the sampling coin checks for an active
# injector on every draw, and a per-call `from .. import` statement is
# measurable on the request fast path
_faults = None


@dataclass(frozen=True)
class TraceContext:
    """One position in a trace: (trace id, span id, sampled)."""

    trace_id: str  # 32 hex chars
    span_id: str  # 16 hex chars
    sampled: bool

    def header(self) -> str:
        """The W3C ``traceparent`` header value."""
        return f"00-{self.trace_id}-{self.span_id}-" \
               f"{'01' if self.sampled else '00'}"


class _Noop:
    """Reusable no-op context manager: the unsampled-path cost of
    :func:`span` is one contextvar read and this singleton."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: object) -> bool:
        return False


_NOOP = _Noop()


class Tracer:
    """Per-process trace state: sampling policy + the span ring buffer."""

    def __init__(self) -> None:
        self._lock = make_lock("obs.tracer")
        self.reconfigure()

    def reconfigure(self) -> None:
        """(Re-)read the KCP_TRACE* environment — called at import and by
        tests/benches that flip modes mid-process."""
        self.enabled = os.environ.get("KCP_TRACE", "1").lower() not in (
            "0", "false", "off")
        self.sample_n = max(1, int(os.environ.get("KCP_TRACE_SAMPLE", "64")))
        self.slo_s = float(os.environ.get("KCP_TRACE_SLO_MS", "200")) / 1000.0
        seed = os.environ.get("KCP_TRACE_SEED", "")
        self._rng = random.Random(int(seed)) if seed else random.Random()
        self.proc = os.environ.get("KCP_TRACE_PROC", f"pid{os.getpid()}")
        self._buf: deque[dict] = deque(
            maxlen=max(64, int(os.environ.get("KCP_TRACE_BUFFER", "4096"))))
        # while armed (arm/disarm), the spans of the ticks traced since
        # arm() land here instead of the ring; those traces' ids
        self._armed: list[dict] | None = None
        self._armed_traces: set[str] = set()
        # time.time() - time.perf_counter(), refreshed by each traced tick:
        # wall() puts the tick loop's perf_counter points on the wall clock
        self.perf_offset = time.time() - time.perf_counter()
        # object-identity links: id(snapshot) -> (snapshot, ctx, seq).
        # Entries hold a strong snapshot ref (presence implies identity,
        # the encode-cache discipline); bounded FIFO — the deque carries
        # (id, seq) and eviction only removes a map entry whose seq still
        # matches, so a re-linked id is never evicted by its stale slot.
        self._links: deque[tuple[int, int]] = deque()
        self._link_seq = 0
        self._link_map: dict[int, tuple[dict, TraceContext, int]] = {}
        self._recorded = REGISTRY.counter(
            "trace_spans_recorded_total",
            "spans recorded into the per-process trace ring buffer")

    # --------------------------------------------------------- contexts

    def head_sampled(self) -> bool:
        """The head sampling coin — drawn from the seeded RNG BEFORE any
        ids exist, so the unsampled fast path never pays for id minting
        (one RNG draw ≈ 0.3µs vs ~5µs of hex formatting). A fixed
        ``KCP_TRACE_SEED`` reproduces the decision sequence exactly;
        fault-injected runs (an active ``KCP_FAULTS`` schedule) always
        sample — a chaos run's whole point is explaining what the
        injected failure did."""
        if self.sample_n <= 1:
            return True
        global _faults
        if _faults is None:
            from .. import faults as _faults_mod

            _faults = _faults_mod
        if _faults._ACTIVE is not None:
            return True
        # getrandbits is a single C call (GIL-atomic): no lock needed
        return self._rng.getrandbits(30) % self.sample_n == 0

    def mint(self, sampled: bool | None = None) -> TraceContext | None:
        """A fresh root context (None when tracing is disabled)."""
        if not self.enabled:
            return None
        if sampled is None:
            sampled = self.head_sampled()
        rng = self._rng
        return TraceContext(f"{rng.getrandbits(128):032x}",
                            f"{rng.getrandbits(64):016x}", sampled)

    def tick_context(self) -> TraceContext | None:
        """The root context of one reconcile tick: a fresh sampled root
        while armed, else one on the head coin's say-so; None when
        tracing is disabled (no draw) or the coin says no. A traced tick
        also refreshes :attr:`perf_offset`."""
        if not self.enabled:
            return None
        if self._armed is None and not self.head_sampled():
            return None
        self.perf_offset = time.time() - time.perf_counter()
        ctx = self.mint(sampled=True)
        with self._lock:
            if self._armed is not None:
                self._armed_traces.add(ctx.trace_id)
        return ctx

    def child(self, ctx: TraceContext) -> TraceContext:
        """Same trace, fresh span id (the caller becomes the parent)."""
        return TraceContext(ctx.trace_id,
                            f"{self._rng.getrandbits(64):016x}",
                            ctx.sampled)

    def from_headers(self, headers: dict) -> TraceContext | None:
        """Parse an incoming ``traceparent`` header (None = absent or
        malformed or tracing disabled)."""
        if not self.enabled:
            return None
        tp = headers.get(TRACEPARENT)
        if not tp:
            return None
        parts = tp.split("-")
        if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
            return None
        try:
            sampled = bool(int(parts[3], 16) & 1)
            int(parts[1], 16), int(parts[2], 16)
        except ValueError:
            return None
        return TraceContext(parts[1], parts[2], sampled)

    # --------------------------------------------------------- recording

    def record(self, name: str, ctx: TraceContext, parent: str | None,
               t0: float, dur: float, attrs: dict | None = None,
               force: bool = False) -> None:
        """Append one finished span (no-op unless sampled or forced)."""
        if not self.enabled or not (ctx.sampled or force):
            return
        span = {
            "trace": ctx.trace_id, "span": ctx.span_id, "parent": parent,
            "name": name, "proc": self.proc,
            "t0": round(t0, 6), "dur": round(max(0.0, dur), 6),
        }
        if attrs:
            span["attrs"] = attrs
        with self._lock:
            if self._armed is not None and ctx.trace_id in self._armed_traces:
                self._armed.append(span)
            else:
                self._buf.append(span)
        self._recorded.inc()

    # ------------------------------------------------------------ arming

    def arm(self) -> None:
        """Start a recording window: every tick is traced, and the spans
        of the ticks traced from now on go to a list that :meth:`disarm`
        returns (not to the ring; every other span still goes to the
        ring). Arming an armed tracer starts the list afresh."""
        with self._lock:
            self._armed = []
            self._armed_traces = set()

    def disarm(self) -> list[dict]:
        """End the recording window: the spans of the ticks it traced,
        oldest first ([] when not armed). Those ticks' spans recorded
        later go to the ring."""
        with self._lock:
            spans, self._armed = self._armed, None
            self._armed_traces = set()
        return spans or []

    @property
    def armed(self) -> bool:
        return self._armed is not None

    # ----------------------------------------------------- object links

    def link_obj(self, obj: dict, ctx: TraceContext,
                 limit: int = 512) -> None:
        """Associate a stored snapshot with the trace that committed it
        (in-process informers resolve causality with one dict probe)."""
        with self._lock:
            oid = id(obj)
            self._link_seq += 1
            self._link_map[oid] = (obj, ctx, self._link_seq)
            self._links.append((oid, self._link_seq))
            while len(self._links) > limit:
                old, seq = self._links.popleft()
                ent = self._link_map.get(old)
                if ent is not None and ent[2] == seq:
                    del self._link_map[old]

    def obj_link(self, obj: dict | None) -> TraceContext | None:
        """The committing trace context of a snapshot, if linked."""
        if obj is None or not self._link_map:
            return None
        ent = self._link_map.get(id(obj))
        if ent is not None and ent[0] is obj:
            return ent[1]
        return None

    # ------------------------------------------------------------ query

    def spans(self) -> list[dict]:
        with self._lock:
            return list(self._buf)

    def get(self, trace_id: str) -> list[dict]:
        """Every buffered span of one trace, oldest first."""
        with self._lock:
            return [s for s in self._buf if s["trace"] == trace_id]

    def slowest(self, n: int = 3) -> list[dict]:
        """The ``n`` slowest buffered traces: grouped by trace id, ranked
        by wall extent (max span end - min span start)."""
        by_trace: dict[str, list[dict]] = {}
        with self._lock:
            for s in self._buf:
                by_trace.setdefault(s["trace"], []).append(s)
        ranked = []
        for tid, spans in by_trace.items():
            t0 = min(s["t0"] for s in spans)
            t1 = max(s["t0"] + s["dur"] for s in spans)
            ranked.append({"id": tid, "dur": round(t1 - t0, 6),
                           "spans": spans})
        ranked.sort(key=lambda t: -t["dur"])
        return ranked[:max(1, n)]


TRACER = Tracer()


# ---------------------------------------------------------------------------
# module-level helpers — the call-site API (and what the kcp-lint span-
# table checker reads: literal names in obs.span/obs.phase/obs.record_span
# calls must appear in the trace-span table of docs/operations.md or of
# the port's docs/operations_torch.md)
# ---------------------------------------------------------------------------


def current() -> TraceContext | None:
    return _current.get()


def wall(perf_t: float) -> float:
    """A ``time.perf_counter()`` reading of a traced tick on the wall
    clock that spans (and ``torch.profiler``'s events) are stamped on."""
    return perf_t + TRACER.perf_offset


def set_current(ctx: TraceContext | None) -> contextvars.Token:
    return _current.set(ctx)


def reset_current(token: contextvars.Token) -> None:
    _current.reset(token)


@contextlib.contextmanager
def use(ctx: TraceContext | None) -> Iterator[TraceContext | None]:
    """Install ``ctx`` as the current trace context for a block."""
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


class _Span:
    __slots__ = ("name", "ctx", "attrs", "t0", "_token", "sub")

    def __init__(self, name: str, ctx: TraceContext, attrs: dict):
        self.name = name
        self.ctx = ctx
        self.attrs = attrs

    def __enter__(self) -> TraceContext:
        self.sub = TRACER.child(self.ctx)
        self._token = _current.set(self.sub)
        self.t0 = time.time()
        return self.sub

    def __exit__(self, etype, exc, tb) -> bool:
        _current.reset(self._token)
        if etype is not None:
            self.attrs["error"] = repr(exc)[:160]
        TRACER.record(self.name, self.sub, self.ctx.span_id, self.t0,
                      time.time() - self.t0, self.attrs or None)
        return False


def span(name: str, **attrs: Any):
    """Time a block as a child span of the current context; near-free
    (:data:`_NOOP`) when untraced or unsampled."""
    ctx = _current.get()
    if ctx is None or not ctx.sampled:
        return _NOOP
    return _Span(name, ctx, attrs)


def record_span(name: str, ctx: TraceContext, parent: str | None,
                t0: float, dur: float, attrs: dict | None = None,
                force: bool = False) -> None:
    """Record an explicitly-timed span (the non-context-manager twin of
    :func:`span`, for sites that measure their own boundaries)."""
    TRACER.record(name, ctx, parent, t0, dur, attrs, force=force)


def phase(name: str, ctx: TraceContext | None, t0: float, t1: float,
          **attrs: Any) -> None:
    """One convergence phase: a ``convergence_<phase>_seconds``
    observation always, plus a ``conv.<name>`` span when sampled.
    Adjacent phases share boundary timestamps, so the per-phase sum
    telescopes to the end-to-end wall time."""
    dur = max(0.0, t1 - t0)
    REGISTRY.histogram(
        f"convergence_{name}_seconds",
        "one phase of the spec-to-status convergence timeline").observe(dur)
    if ctx is not None and ctx.sampled and TRACER.enabled:
        sub = TRACER.child(ctx)
        TRACER.record("conv." + name, sub, ctx.span_id, t0, dur,
                      attrs or None)


def write_ctx() -> TraceContext | None:
    """The current context if it is worth stamping onto a commit
    (sampled), else None — the store's one-attribute fast path."""
    ctx = _current.get()
    return ctx if ctx is not None and ctx.sampled else None


def link_obj(obj: dict, ctx: TraceContext) -> None:
    TRACER.link_obj(obj, ctx)


def obj_link(obj: dict | None) -> TraceContext | None:
    if not TRACER.enabled:
        return None
    return TRACER.obj_link(obj)


def ctx_from_wal(tc: Any) -> TraceContext | None:
    """Rebuild a context from a WAL record's ``tc`` field
    (``[trace_id, span_id]``); None-safe and shape-tolerant."""
    if (not isinstance(tc, (list, tuple)) or len(tc) != 2
            or not all(isinstance(x, str) for x in tc)):
        return None
    return TraceContext(tc[0], tc[1], True)


def conv_begin(obj: dict | None) -> TraceContext | None:
    """The context a syncer engine should attribute a staged row to: the
    committing write's own context when the snapshot is identity-linked
    (in-process informers), else a fresh root ONLY under always-on
    sampling (cross-process engines correlate fragments by rv — see
    :mod:`.assemble` — and minting per event at default sampling would
    put an RNG call on the event hot path for nothing)."""
    t = TRACER
    if not t.enabled:
        return None
    ctx = t.obj_link(obj) if t._link_map else None
    if ctx is not None:
        return ctx
    if t.sample_n <= 1:
        return t.mint(sampled=True)
    return None
