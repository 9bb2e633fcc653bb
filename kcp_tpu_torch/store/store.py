"""LogicalStore: the multi-tenant keyspace + watch hub.

This is the storage layer of the framework — the analog of the reference's
embedded etcd plus the forked apiserver's logical-cluster storage prefixing
(reference: pkg/etcd/etcd.go; docs/investigations/logical-clusters.md:66-74,
key scheme ``/<resource>/<cluster>/<namespace>/<name>``). It is deliberately
also the test fake: the same object backs unit tests, the in-process API
server, and the fake physical clusters.

Semantics implemented (inferred from the reference's call sites, since the
kcp-dev/kubernetes fork is not vendored there):

- logical-cluster prefix keys; ``*`` (WILDCARD) lists/watches across all
  tenants (logical-clusters.md:70-74)
- a single monotonically increasing resourceVersion per store (etcd
  revision analog); lists carry the store RV, watches can resume from an RV
- optimistic concurrency: update with a stale metadata.resourceVersion
  raises ConflictError
- generation bumps on spec (non-status) changes only; status subresource
  updates never bump generation
- finalizers: delete sets deletionTimestamp first; object is removed when
  the finalizer list is empty
- label-selector filtered list/watch
- optional durability via an append-only JSON-lines WAL with snapshot
  compaction (restart resumes from durable storage, matching the
  reference's restart-resumes-from-etcd model, server.go:80-97)

Read path (KCP_STORE_INDEX=1, the default):

- secondary ``resource -> cluster -> namespace`` buckets are maintained
  on every mutation (and rebuilt on WAL/snapshot restore), so ``list``
  touches only candidate keys instead of every object in the process;
- copy-on-write objects: stored snapshots are never mutated in place
  (every write replaces the whole dict), so ``list`` results and watch
  ``Event`` objects share references with the store and the deep copy
  is deferred to the mutation boundary — callers treat listed objects
  and event payloads as frozen and re-``get`` (or deepcopy) before
  editing, exactly like client-go informer caches;
- watch fan-out is batched: ``_emit`` coalesces events into
  micro-batches and matches each batch against all registered watch
  selectors in one vectorized pass (ops/labelmatch host twins over
  interned label ids — exact, no hash collisions), preserving the
  old-match/new-match ADDED/MODIFIED/DELETED rewrite semantics of
  :meth:`Watch._transform`. Batches flush at the asyncio loop boundary
  (``call_soon``), on a size threshold, and lazily whenever a consumer
  touches a watch, so delivery semantics are unchanged.

``KCP_STORE_INDEX=0`` (or ``indexed=False``) keeps the pre-index scan +
per-event deepcopy path for A/B measurement (``bench.py --store``).

Encode-once serving (KCP_ENCODE_CACHE=1, the default, indexed stores):

- the CoW contract above makes serialized bytes a *pure function of the
  snapshot object*: a per-record byte cache (:meth:`encode_obj`) is
  populated lazily on first encode and needs no invalidation protocol —
  a mutation replaces the snapshot, so the identity-keyed entry simply
  stops matching (replaced/deleted snapshots are evicted for memory
  only, not correctness);
- watch events carry their encoded ``{"type", "object"}`` wire line on
  the :class:`Event` itself (:meth:`encode_event`), so a burst fanned
  out to 64 relays is encoded once, not 64 times — rewritten
  (label-transition) events are shared across matched watches for the
  same reason;
- ``KCP_ENCODE_CACHE=0`` keeps the per-call ``json.dumps`` serving path
  for A/B (``bench.py --encode``), and the ``encode.cache`` KCP_FAULTS
  point force-drops cached entries to exercise the re-encode fallback.

Watcher scale:

- the retained history is the **watch-cache window** (``KCP_WATCH_WINDOW``
  events) with a bisect-able shared index: a resume is one binary search
  plus a suffix replay of shared Event instances (so the encode-once wire
  bytes are shared across every resumer of a reconnect storm);
- per-watcher queues are **bounded** (``KCP_WATCH_QUEUE``): a consumer
  that stops draining is EVICTED — ``Watch.evicted`` set, stream closed —
  and the HTTP relay turns that into a terminal in-stream typed 410 so
  informers relist-NOW and resume (the ``watch.evict`` fault point drills
  the path);
- the fan-out keeps a per-resource watch index with cached scope/selector
  arrays (rebuilt only when the watch set changes), so a flush is
  O(events + deliveries), not O(live watchers).

Write path: group commit (KCP_GROUP_COMMIT=1, the default):

- concurrent mutations apply to the in-memory state one at a time as
  always (RV allocation, conflict checks, event emission unchanged),
  but their WAL records coalesce into a bounded **commit window**
  (KCP_COMMIT_WINDOW_MAX rows / KCP_COMMIT_WINDOW_US linger; 0 = close
  at the next loop pass) whose flush is ONE buffered WAL append + ONE
  KCP_WAL_SYNC-policy flush/fsync (both backends — the native engine's
  ws_batch_begin/commit), ONE replication batch, and ONE watch fan-out
  flush;
- writers needing a durability barrier await :meth:`commit_durable`,
  which resolves with the window's high RV after the sync (the serving
  layer parks every writer's semi-sync standby wait there — one ack
  per window) — with an idle fast path that flushes synchronously when
  nothing else can join, so a lone writer pays the serial path's
  latency;
- a window whose sync fails fails every parked writer with a typed 503
  and commits NONE of its records (``store.commit_window`` faults
  drill the split/failure/abort paths); sync-context callers (no
  running loop) keep the serial append — durable on return;
- ``KCP_GROUP_COMMIT=0`` keeps the serial path as the A/B reference:
  state, event streams and WAL bytes are identical either way
  (tests/test_group_commit.py differential fuzz; bench.py --writes).

Thread-model: single-threaded synchronous core intended to be called from
one asyncio event loop; watches buffer into deques and optionally notify an
asyncio.Event so async consumers can await new events.
"""

from __future__ import annotations

import asyncio
import base64
import copy
import json
import logging
import os
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Mapping

import numpy as np

from .. import obs
from ..analysis import sanitize as _sanitize
from ..faults import maybe_fail, should_drop
from ..utils.errors import (
    AlreadyExistsError,
    ConflictError,
    GoneError,
    InvalidError,
    NotFoundError,
    UnavailableError,
)
from ..utils.trace import REGISTRY, SIZE_BUCKETS
from .selectors import LabelSelector, everything

log = logging.getLogger(__name__)

WILDCARD = "*"

# KEP-3157-style watch-list: the sync bookmark that ends the initial
# ADDED stream carries this annotation set to "true"
BOOKMARK = "BOOKMARK"
INITIAL_EVENTS_END = "kcp.io/initial-events-end"


def encode_continue(rv: int, last_key: tuple | list | None) -> str:
    """Opaque KEP-365-style continue token: urlsafe base64 of
    ``{"rv": N, "k": [cluster, namespace, name] | null}``. ``k=null``
    means "from the start, pinned at rv" (the router synthesizes these
    for shards whose first page it discards)."""
    payload = {"rv": int(rv), "k": list(last_key) if last_key else None}
    raw = json.dumps(payload, separators=(",", ":")).encode()
    return base64.urlsafe_b64encode(raw).decode()


def decode_continue(token: str) -> tuple[int, tuple | None]:
    """Inverse of :func:`encode_continue`; raises ValueError on any
    malformed token (callers answer typed 410 — the client re-lists)."""
    try:
        payload = json.loads(base64.urlsafe_b64decode(token.encode()))
        rv = int(payload["rv"])
        k = payload.get("k")
        if k is not None:
            k = tuple(k)
            if len(k) != 3 or not all(isinstance(p, str) for p in k):
                raise ValueError(f"bad continue key {k!r}")
        return rv, k
    except (ValueError, KeyError, TypeError) as e:
        raise ValueError(f"malformed continue token: {e}") from None


def _env_indexed() -> bool:
    return os.environ.get("KCP_STORE_INDEX", "1").lower() not in ("0", "false", "off")


def _env_encode_cache() -> bool:
    return os.environ.get("KCP_ENCODE_CACHE", "1").lower() not in ("0", "false", "off")


def _env_watch_window() -> int:
    """Retained watch-cache window (events): how far back a
    ``watch(since_rv=...)`` resume can reach before answering 410."""
    return int(os.environ.get("KCP_WATCH_WINDOW", "200000"))


def _env_watch_queue() -> int:
    """Per-watcher event-queue bound (0 = unbounded, the legacy
    behavior). A watcher whose consumer stops draining past the bound is
    EVICTED — closed with ``Watch.evicted`` set, which the HTTP relay
    turns into a terminal in-stream typed 410 (informers relist-NOW and
    resume) — instead of buffering the window into unbounded memory."""
    return int(os.environ.get("KCP_WATCH_QUEUE", "65536"))


def _env_group_commit() -> bool:
    """Group commit (KCP_GROUP_COMMIT, default on): concurrent mutations
    coalesce into one commit window — the window's WAL records append as
    ONE buffered write + ONE sync, ship to replication as ONE batch, and
    fan out to watchers in ONE flush. ``=0`` keeps the serial
    append-per-record path (the A/B reference; byte-identical WAL/state
    either way)."""
    return os.environ.get("KCP_GROUP_COMMIT", "1").lower() not in (
        "0", "false", "off")


def _env_commit_window_max() -> int:
    """Commit-window row bound (KCP_COMMIT_WINDOW_MAX): a window holding
    this many records flushes immediately instead of waiting out the
    linger — bounds both ack latency and the blast radius of one failed
    sync."""
    return max(1, int(os.environ.get("KCP_COMMIT_WINDOW_MAX", "256")))


def _env_commit_window_us() -> float:
    """Commit-window linger (KCP_COMMIT_WINDOW_US, microseconds). ``0``
    (the default) closes the window at the next event-loop pass — every
    mutation already runnable this pass joins it, so the idle case pays
    one loop iteration, not a timer. ``>0`` holds the window open that
    long to accumulate more writers per sync at the cost of added write
    latency."""
    return max(0.0, float(os.environ.get("KCP_COMMIT_WINDOW_US", "0")))


def _env_wal_sync() -> str:
    """WAL sync policy (KCP_WAL_SYNC): what one commit (window or serial
    record) costs in durability terms.

    - ``flush`` (default): python/user-space buffers flushed to the OS
      per commit; the native engine keeps its legacy ``sync_every``
      batched fsync. Survives process death, NOT power loss.
    - ``fsync``: fsync per commit — full durability; group commit is
      what makes this affordable (one fsync per window, not per write).
    - ``off``: no explicit flush at all; the OS (and python's buffer)
      decide. Maximum throughput, weakest guarantee.
    """
    mode = os.environ.get("KCP_WAL_SYNC", "flush").lower()
    if mode not in ("flush", "fsync", "off"):
        raise InvalidError(
            f"unknown KCP_WAL_SYNC {mode!r} (flush|fsync|off)")
    return mode


class _CommitWindow:
    """One open group-commit window: the records awaiting their shared
    WAL append + sync, the future every writer of the window parks on
    (resolved with the window's high RV after a successful sync; the
    typed sync error otherwise), and the scheduled flush callback."""

    __slots__ = ("recs", "fut", "high_rv", "handle", "flushed")

    def __init__(self, fut: "asyncio.Future"):
        self.recs: list[dict] = []
        self.fut = fut
        self.high_rv = 0
        self.handle = None
        self.flushed = False

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"

Key = tuple[str, str, str, str]  # (resource, cluster, namespace, name)


@dataclass(frozen=True)
class Event:
    type: str  # ADDED | MODIFIED | DELETED
    resource: str
    cluster: str
    namespace: str
    name: str
    object: dict
    rv: int
    old_object: dict | None = None  # prior state on MODIFIED/DELETED

    @property
    def key(self) -> Key:
        return (self.resource, self.cluster, self.namespace, self.name)


class Watch:
    """A filtered subscription to store events.

    Sync consumers call :meth:`drain`; async consumers iterate with
    ``async for``. Closing is idempotent.
    """

    def __init__(
        self,
        store: "LogicalStore",
        resource: str,
        cluster: str,
        namespace: str | None,
        selector: LabelSelector,
    ):
        self._store = store
        self.resource = resource
        self.cluster = cluster
        self.namespace = namespace
        self.selector = selector
        self._events: deque[Event] = deque()
        self._closed = False
        # backpressure policy (KCP_WATCH_QUEUE): a consumer that stops
        # draining past the bound gets evicted instead of pinning the
        # window in unbounded per-watcher memory; `evicted` tells the
        # serving layer to end the stream with a typed 410 rather than
        # a silent close
        self._max_queue = store._watch_queue
        self.evicted = False
        self._wakeup: asyncio.Event | None = None
        # batched fan-out (indexed stores): a single-equality selector
        # matches via one interned pair id (the fanout_match shape), a
        # general kernel-shaped one via a CompiledSelector; both None =>
        # exact per-event python matching (_transform)
        self._eq_pid: int | None = None
        self._compiled = None

    def _scope_match(self, ev: Event) -> bool:
        if ev.resource != self.resource:
            return False
        if self.cluster != WILDCARD and ev.cluster != self.cluster:
            return False
        return self.namespace is None or ev.namespace == self.namespace

    @staticmethod
    def _labels(obj: dict | None) -> dict:
        return ((obj or {}).get("metadata") or {}).get("labels") or {}

    def _transform(self, ev: Event) -> Event | None:
        """Filter/rewrite an event for this watch's selector.

        Kubernetes apiserver semantics for selector-bound watches: an
        object whose labels *stop* matching surfaces as DELETED (so caches
        evict it), one whose labels *start* matching on an update surfaces
        as ADDED. Without this, selector-bound informer caches go
        permanently stale on label transitions.
        """
        if not self._scope_match(ev):
            return None
        if self.selector.empty:
            return ev
        new_match = ev.type != DELETED and self.selector.matches(self._labels(ev.object))
        old_match = self.selector.matches(self._labels(ev.old_object))
        if ev.type == ADDED:
            return ev if new_match else None
        if ev.type == DELETED:
            return ev if old_match or new_match else None
        if new_match and old_match:
            return ev
        if new_match:
            return Event(ADDED, ev.resource, ev.cluster, ev.namespace, ev.name,
                         ev.object, ev.rv, ev.old_object)
        if old_match:
            return Event(DELETED, ev.resource, ev.cluster, ev.namespace, ev.name,
                         ev.object, ev.rv, ev.old_object)
        return None

    def _push(self, ev: Event) -> None:
        if self._closed:
            return
        if should_drop("watch"):
            # injected stream loss (KCP_FAULTS `watch:drop...`): the event
            # is lost and the watch dies mid-stream, exactly like a
            # dropped connection — consumers must re-list (informers do)
            self.close()
            return
        if should_drop("watch.evict") or (
                self._max_queue and len(self._events) >= self._max_queue):
            # queue overflow (or an injected eviction drill): this
            # consumer is too slow to keep its seat — evict it rather
            # than buffer without bound. The event is NOT appended: the
            # stream ends with a typed 410 and the client relists.
            self._evict()
            return
        self._events.append(ev)
        depth = len(self._events)
        if depth >= 64 and depth & (depth - 1) == 0:
            # sampled at powers of two: queue depth visibility without a
            # histogram transaction on every push of the hot path
            self._store._queue_depth.observe(depth)
        if self._wakeup is not None:
            self._wakeup.set()

    def _evict(self) -> None:
        self.evicted = True
        self._store._evicted_total.inc()
        log.warning(
            "watch %s/%s evicted: consumer fell %d events behind "
            "(KCP_WATCH_QUEUE=%d)", self.resource, self.cluster,
            len(self._events), self._max_queue)
        self.close()

    def drain(self) -> list[Event]:
        """Return and clear all buffered events (sync consumers/tests)."""
        self._store._flush_events()
        out = list(self._events)
        self._events.clear()
        if self._wakeup is not None:
            self._wakeup.clear()
        return out

    def pending(self) -> int:
        self._store._flush_events()
        return len(self._events)

    def close(self) -> None:
        if not self._closed:
            # deliver what was emitted before the close — with deferred
            # fan-out, an event committed pre-close must still land in
            # this watch's buffer (legacy _emit delivered synchronously)
            self._store._flush_events()
            self._closed = True
            self._store._unsubscribe(self)
            if self._wakeup is not None:
                self._wakeup.set()

    @property
    def closed(self) -> bool:
        return self._closed

    def __aiter__(self) -> "Watch":
        return self

    async def __anext__(self) -> Event:
        while True:
            self._store._flush_events()
            if self._events:
                return self._events.popleft()
            if self._closed:
                raise StopAsyncIteration
            if self._wakeup is None:
                self._wakeup = asyncio.Event()
            self._wakeup.clear()
            await self._wakeup.wait()

    async def next_batch(self, max_wait: float = 0.05) -> list[Event]:
        """Await at least one event (or closure), then drain the buffer.

        The batching primitive for the TPU backend: the reconcile tick
        collects a delta batch instead of handling events one at a time.
        """
        self._store._flush_events()
        if not self._events and not self._closed:
            if self._wakeup is None:
                self._wakeup = asyncio.Event()
            self._wakeup.clear()
            try:
                await asyncio.wait_for(self._wakeup.wait(), timeout=max_wait)
            except asyncio.TimeoutError:
                pass
        return self.drain()


@dataclass
class _WalConfig:
    path: str
    fh: Any = None
    mutations_since_snapshot: int = 0
    snapshot_every: int = 50_000


def _wal_key(key: Key) -> bytes:
    """NUL-joined key tuple: ordered by (resource, cluster, ns, name) so
    native prefix scans follow the etcd range-scan idiom."""
    return "\x00".join(key).encode("utf-8")


_WAL_MAGIC = b"KCPWAL1\n"  # stamped by native/walstore.cc on every file


def _inject(point: str) -> None:
    """KCP_FAULTS injection for a store verb: may raise an injected 503
    (UnavailableError) or sleep an injected latency. Near-free when no
    injector is active."""
    delay = maybe_fail(point)
    if delay:
        time.sleep(delay)


def _detect_wal_format(path: str) -> str | None:
    """Detect an existing WAL's format: "json" (JSON-lines), "native"
    (binary, identified by its magic header), or None (absent/empty).

    The magic header is authoritative — a binary record length whose low
    byte happens to be 0x7B ('{') must never read as JSON. JSON-lines
    files (which always start with ``{"op":`` or a ``{`` snapshot) are
    recognized explicitly; any other nonempty content is treated as
    native so the engine's CRC replay (which tolerates legacy
    magic-less files) gets to decide.
    """
    for candidate in (path, path + ".snap"):
        try:
            with open(candidate, "rb") as f:
                head = f.read(len(_WAL_MAGIC))
        except OSError:
            continue
        if not head:
            continue
        if head == _WAL_MAGIC:
            return "native"
        return "json" if head.lstrip()[:1] == b"{" else "native"
    return None


class LogicalStore:
    """The multi-tenant object store + watch hub."""

    def __init__(
        self,
        wal_path: str | None = None,
        clock: Callable[[], float] = time.time,
        wal_backend: str = "auto",
        wal_sync_every: int = 256,
        namespace_lifecycle: bool = False,
        indexed: bool | None = None,
        encode_cache: bool | None = None,
    ):
        """``indexed``: None reads ``KCP_STORE_INDEX`` (default on) —
        False keeps the pre-index linear-scan/deepcopy read path and the
        per-watch python fan-out for A/B measurement.

        ``encode_cache``: None reads ``KCP_ENCODE_CACHE`` (default on) —
        False keeps per-call ``json.dumps`` serving for A/B
        (``bench.py --encode``). Only effective on indexed stores: the
        cache's validity rests on the CoW snapshot contract, which the
        legacy deepcopy-per-read path does not provide.

        ``wal_backend``: "auto" uses the native C++ engine
        (native/walstore.cc — binary records, CRC32 torn-write recovery,
        batched fsync) when the library loads, else the JSON-lines
        fallback; "native"/"json" force a choice.

        ``namespace_lifecycle``: stamp the ``kubernetes`` finalizer on
        namespaces at create (admission-style). Only enable where a
        NamespaceLifecycleController will actually release it — the kcp
        server does; bare stores and physical-cluster fakes must not,
        or their namespaces can never finish deleting.
        """
        self.namespace_lifecycle = namespace_lifecycle
        # Attachable /openapi/v2 (swagger) document for this store's
        # API surface — the discovery metadata the CRD puller's schema
        # synthesis consumes (reference: kube-openapi models fed into
        # SchemaConverter, pkg/crdpuller/discovery.go:190-207). Not
        # persisted: it is serving metadata, not state.
        self.openapi_doc: dict | None = None
        # race detection (KCP_RACE=1, the `go test -race` analog): the
        # store is loop-owned single-threaded state — every mutation
        # asserts it runs on the owning thread (utils/raceguard.py)
        from ..utils.raceguard import AffinityGuard

        self._race_guard = AffinityGuard("LogicalStore")
        # runtime sanitizer (KCP_SANITIZE=1): stored snapshots freeze
        # (mutation raises at the violating line) and the encode caches
        # verify every hit against a fresh encode — the crash-loudly
        # twin of the CoW/frozen-bytes lint contracts
        self._sanitize = _sanitize.enabled()
        # admission quota accounting: called (resource, cluster, +1/-1)
        # whenever the object map gains/loses a key — the mutation-level
        # usage hook the QuotaLedger attaches (admission/quota.py). None
        # (the default) is one attribute read per mutation.
        self._usage_hook = None
        # replication hook: called with every committed WAL record dict
        # (both durability backends and in-memory stores alike) — the
        # primary-side ReplicationHub attaches here to ship the log.
        self._repl_hook = None
        # read-only stores (replicas, standbys pre-promotion, fenced
        # zombie primaries) refuse mutating verbs with a 503; None means
        # writable, a string carries the human-readable reason. Fenced
        # rejections are additionally counted (repl_fenced_writes_total).
        self.read_only: str | None = None
        self.fenced = False
        # replication epoch: bumped on standby promotion and stamped on
        # every shipped stream so a superseded primary's late records
        # are rejected. Persisted with the WAL (epoch record / snapshot
        # field / native OP_EPOCH) so a restart cannot rewind the fence.
        self.epoch = 0
        # RV honesty for replicas: a watch resume beyond the applied RV
        # is knowledge this store does not have — with this flag set the
        # watch answers a typed 410 instead of silently subscribing
        # "live" at a point the client is already past.
        self.reject_future_rv = False
        # elastic scale-out (sharding/migrate.py): per-cluster write
        # fences (cluster -> cutover RV) held while that cluster's data
        # streams to its new owning shard, and per-cluster RV floors on
        # the RECEIVING shard (cluster -> first post-migration RV) so a
        # resume carrying a source-shard RV answers a typed 410 instead
        # of silently resuming against an unrelated RV history.
        self._cluster_fences: dict[str, int] = {}
        self._migration_floors: dict[str, int] = {}
        self._objects: dict[Key, dict] = {}
        self._rv = 0
        self._watches: list[Watch] = []
        # watch hub index: resource -> live watches, maintained on
        # subscribe/unsubscribe with a version stamp per resource so the
        # fan-out's per-watch scope/selector arrays are built once per
        # watch-set change, not once per flush (at 10k watchers the
        # per-flush rebuild WAS the fan-out cost)
        self._watches_by_res: dict[str, list[Watch]] = {}
        self._watch_ver: dict[str, int] = {}
        self._fanout_cache: dict[str, tuple] = {}
        # the watch-cache window (KCP_WATCH_WINDOW events): both the
        # resume source and the bound on how far back since_rv may reach
        self._history: deque[Event] = deque(maxlen=_env_watch_window())
        # shared resume window: a bisect-able mirror of _history (event
        # refs + their rvs, compacted lazily) so a reconnect storm of N
        # watchers resuming from nearby rvs costs N binary searches over
        # ONE shared index instead of N independent tail-scans. The
        # mirror self-heals against direct _history surgery (tests shrink
        # or swap the deque): a cheap end-identity check at resume time
        # rebuilds it when out of sync.
        self._hist_events: list[Event] = []
        self._hist_rvs: list[int] = []
        self._hist_start = 0
        self._watch_queue = _env_watch_queue()
        self._clock = clock
        self._indexed = _env_indexed() if indexed is None else bool(indexed)
        # secondary index: resource -> cluster -> namespace -> {key: obj};
        # maintained on every mutation (both modes — clusters()/
        # resources()/locate() read it), pruned empty so the bucket keys
        # are exactly the live (resource, cluster, namespace) triples
        self._buckets: dict[str, dict[str, dict[str, dict[Key, dict]]]] = {}
        # batched watch fan-out (indexed mode)
        self._pending: list[Event] = []
        self._flush_scheduled = False
        self._flushing = False
        self._emit_batch = max(1, int(os.environ.get("KCP_STORE_EMIT_BATCH", "128")))
        # exact label interning for the vectorized matchers: distinct
        # (key, value) pairs / keys get sequential nonzero uint32 ids, so
        # unlike the device kernels' 32-bit hashes two labels can never
        # alias — watch semantics stay byte-identical to _transform
        self._intern_pairs: dict = {}
        self._intern_keys: dict[str, int] = {}
        self._labelmatch = None  # lazy ops.labelmatch module
        # encode-once byte cache: id(snapshot) -> (snapshot, bytes). The
        # entry holds a strong ref to its snapshot, so a live id can
        # never be reused by a different object — presence implies
        # identity. Mutation replaces the snapshot (CoW), which is the
        # whole invalidation story; _put_obj/_del_obj evict replaced
        # snapshots purely to bound memory to the live object set.
        self._encode_cache = (_env_encode_cache() if encode_cache is None
                              else bool(encode_cache)) and self._indexed
        self._enc_bytes: dict[int, tuple[dict, bytes]] = {}
        # per-bucket list spans: (resource, cluster, namespace) ->
        # (bucket version, b", ".join of the bucket's sorted item
        # bytes). A mutation bumps the bucket's version, so an
        # unselected list re-joins only the buckets that changed and
        # concatenates the rest — no global sort, no per-item probe.
        self._span_cache: dict[tuple[str, str, str], tuple[int, bytes]] = {}
        self._bucket_ver: dict[tuple[str, str, str], int] = {}
        self._enc_hits = REGISTRY.counter(
            "encode_cache_hits_total",
            "serializations served from the encode-once byte cache")
        self._enc_misses = REGISTRY.counter(
            "encode_cache_misses_total",
            "serializations that had to run json.dumps")
        self._enc_shared = REGISTRY.counter(
            "encode_cache_bytes_shared_total",
            "response bytes served from cached encodings")
        self._resume_shared = REGISTRY.counter(
            "watch_resume_shared_total",
            "watch resumes answered from the shared in-sync window index "
            "(one bisect, no per-watcher history scan)")
        self._evicted_total = REGISTRY.counter(
            "watch_evicted_total",
            "watchers evicted for falling behind (per-watcher queue "
            "overflow or socket buffer past KCP_WATCH_BUFFER_MAX)")
        self._queue_depth = REGISTRY.histogram(
            "watch_queue_depth",
            "per-watcher buffered events, sampled at powers of two >= 64",
            buckets=SIZE_BUCKETS)
        # global cluster/namespace interning for the fan-out scope
        # matrices: ids are stable across batches, so the per-watch
        # scope arrays can be cached per watch-set version instead of
        # re-interned against every batch
        self._intern_cl: dict[str, int] = {}
        self._intern_ns: dict[str, int] = {}
        self._wal: _WalConfig | None = None
        self._engine = None
        self._engine_mutations = 0
        self._engine_snapshot_every = 50_000
        # WAL sync policy (KCP_WAL_SYNC=flush|fsync|off): read before the
        # engine opens — fsync/off take over sync scheduling explicitly,
        # so the engine's own sync_every batching is disabled for them
        self._wal_sync = _env_wal_sync()
        # group commit (KCP_GROUP_COMMIT, default on): concurrent
        # mutations coalesce into a bounded commit window that appends as
        # ONE buffered write + ONE sync, ships ONE replication batch, and
        # fires ONE watch fan-out flush. Windows only form on stores with
        # a sink (WAL or replication hook) under a running event loop;
        # sync-context callers keep the serial path record for record.
        self._gc_enabled = _env_group_commit()
        self._gc_max = _env_commit_window_max()
        self._gc_linger_s = _env_commit_window_us() / 1e6
        self._gc_window: _CommitWindow | None = None
        self._gc_windows_total = REGISTRY.counter(
            "store_commit_windows_total",
            "group-commit windows flushed (one WAL append + one sync + "
            "one replication batch + one fan-out flush each)")
        self._gc_window_size = REGISTRY.histogram(
            "store_commit_window_size",
            "mutations coalesced per group-commit window",
            buckets=SIZE_BUCKETS)
        self._wal_sync_total = REGISTRY.counter(
            "wal_sync_total",
            "explicit WAL flush/fsync operations (KCP_WAL_SYNC policy); "
            "group commit amortizes these across a whole window")
        self._wal_sync_seconds = REGISTRY.histogram(
            "wal_sync_seconds",
            "time spent in one WAL durable append + flush/fsync call")
        # batched replication hook: set alongside _repl_hook — a flushed
        # window ships once through this instead of once per record
        self._repl_batch = None
        if wal_backend not in ("auto", "native", "json"):
            raise InvalidError(f"unknown wal_backend {wal_backend!r} (auto|native|json)")
        if wal_path:
            existing = _detect_wal_format(wal_path)
            if wal_backend == "auto":
                # never reinterpret an existing WAL under a different
                # format — the native engine would truncate a JSON WAL as
                # a torn tail and destroy it
                use_native = existing != "json"
            elif wal_backend == "native":
                if existing == "json":
                    raise InvalidError(
                        f"{wal_path} holds a JSON-lines WAL; migrate it (load with "
                        f"wal_backend='json', snapshot to a fresh path) before "
                        f"forcing the native engine"
                    )
                use_native = True
            else:
                if existing == "native":
                    raise InvalidError(
                        f"{wal_path} holds a native binary WAL; it cannot be "
                        f"opened with wal_backend='json'"
                    )
                use_native = False
            if use_native:
                try:
                    from ..native import WalEngine

                    # flush (default) keeps the engine's legacy batched
                    # fsync; fsync/off schedule syncs explicitly (per
                    # record / per window / never), so the engine's own
                    # sync_every counter is disabled for them
                    eng_sync = (wal_sync_every
                                if self._wal_sync == "flush" else 0)
                    self._engine = WalEngine(wal_path, sync_every=eng_sync)
                except Exception:
                    if wal_backend == "native":
                        raise
                    if existing == "native":
                        raise  # a binary WAL is unreadable without the engine
            if self._engine is not None:
                self._load_engine()
            else:
                self._wal = _WalConfig(path=wal_path)
                self._load_wal()
                self._wal.fh = open(wal_path, "a", encoding="utf-8")

    # ------------------------------------------------------------------ RV

    @property
    def resource_version(self) -> int:
        return self._rv

    def _next_rv(self) -> int:
        self._rv += 1
        return self._rv

    # ------------------------------------------------------------- helpers

    @staticmethod
    def _key(resource: str, cluster: str, namespace: str, name: str) -> Key:
        if not resource or not cluster or not name:
            raise InvalidError("resource, cluster and name are required")
        if cluster == WILDCARD:
            raise InvalidError("wildcard cluster is read-only")
        return (resource, cluster, namespace or "", name)

    @staticmethod
    def _meta(obj: Mapping) -> dict:
        return obj.get("metadata") or {}

    def _now(self) -> str:
        return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(self._clock()))

    # ------------------------------------------------------------- index

    def _put_obj(self, key: Key, obj: dict) -> dict:
        """Insert/replace an object in the map and the secondary index.
        Returns the stored snapshot — under the sanitizer it is a frozen
        proxy, and callers emit/log THAT object so events keep sharing
        the stored snapshot's identity."""
        if self._sanitize:
            obj = _sanitize.freeze(obj)
        old = self._objects.get(key)
        if self._usage_hook is not None and old is None:
            self._usage_hook(key[0], key[1], 1)
        if self._encode_cache:
            if old is not None and self._enc_bytes:
                # memory hygiene only: the replaced snapshot's cached
                # bytes can never be served again (identity mismatch)
                self._enc_bytes.pop(id(old), None)
            bk = key[:3]
            self._bucket_ver[bk] = self._bucket_ver.get(bk, 0) + 1
        self._objects[key] = obj
        r, c, n, _ = key
        self._buckets.setdefault(r, {}).setdefault(c, {}).setdefault(n, {})[key] = obj
        return obj

    def _del_obj(self, key: Key) -> None:
        old = self._objects.get(key)
        if old is not None:
            if self._usage_hook is not None:
                self._usage_hook(key[0], key[1], -1)
            if self._encode_cache:
                self._enc_bytes.pop(id(old), None)
                bk = key[:3]
                self._bucket_ver[bk] = self._bucket_ver.get(bk, 0) + 1
        self._objects.pop(key, None)
        r, c, n, _ = key
        res = self._buckets.get(r)
        if res is None:
            return
        cl = res.get(c)
        if cl is None:
            return
        ns = cl.get(n)
        if ns is None:
            return
        ns.pop(key, None)
        if not ns:
            self._span_cache.pop(key[:3], None)
            del cl[n]
            if not cl:
                del res[c]
                if not res:
                    del self._buckets[r]

    def locate(self, resource: str, name: str, namespace: str = "") -> list[str]:
        """Clusters holding (resource, namespace, name) — the index-driven
        answer to wildcard single-object reads (server.handler scans
        tenants for the unique owner)."""
        ns = namespace or ""
        out = []
        for c, nss in self._buckets.get(resource, {}).items():
            if (resource, c, ns, name) in nss.get(ns, ()):
                out.append(c)
        return sorted(out)

    # --------------------------------------------------------------- CRUD

    def _check_writable(self) -> None:
        """Refuse mutations on read-only stores (replicas, unpromoted
        standbys, fenced ex-primaries). 503 rather than 403: informers
        and retrying clients treat it as a routing problem — the write
        belongs on the current primary — not a policy denial."""
        if self.read_only is not None:
            if self.fenced:
                REGISTRY.counter(
                    "repl_fenced_writes_total",
                    "writes refused because this store was fenced by a "
                    "newer replication epoch").inc()
            raise UnavailableError(f"store is read-only: {self.read_only}")

    def _check_cluster_writable(self, cluster: str) -> None:
        """Refuse writes to a cluster whose migration cutover is in
        progress. 503 like the store-wide fence: the write belongs on
        the cluster's NEW owner — clients retry, and by the time they
        do the ring has flipped (the fence window is one WAL stream)."""
        cut = self._cluster_fences.get(cluster)
        if cut is not None:
            REGISTRY.counter(
                "migration_fenced_writes_total",
                "writes refused because the cluster was fenced at its "
                "migration cutover RV (retry lands on the new owner)").inc()
            raise UnavailableError(
                f"cluster {cluster!r} is migrating to a new shard "
                f"(fenced at rv {cut}); retry")

    def _commit_trace(self, tctx, t0: float, key: Key, rv: int,
                      rec: dict, obj: dict | None) -> None:
        """Stamp a sampled write's trace onto its WAL record (``tc``
        rides the replication feed) and link the stored snapshot to the
        committing context (in-process informers resolve causality by
        object identity); records the ``store.commit`` span. One stamp
        covers every watcher/subscriber — the events already carry the
        context (see :meth:`_emit`)."""
        sub = obs.TRACER.child(tctx)
        rec["tc"] = [sub.trace_id, sub.span_id]
        obs.record_span(
            "store.commit", sub, tctx.span_id, t0, time.time() - t0,
            {"resource": key[0], "cluster": key[1], "name": key[3],
             "rv": str(rv), "op": rec["op"]})
        if obj is not None:
            obs.link_obj(obj, sub)

    def create(self, resource: str, cluster: str, obj: dict, namespace: str = "") -> dict:
        self._race_guard.check()
        self._check_writable()
        self._check_cluster_writable(cluster)
        tctx = obs.write_ctx()
        t0 = time.time() if tctx is not None else 0.0
        _inject("store.put")
        obj = copy.deepcopy(obj)
        meta = obj.setdefault("metadata", {})
        name = meta.get("name")
        if not name:
            if meta.get("generateName"):
                name = meta["generateName"] + uuid.uuid4().hex[:6]
                meta["name"] = name
            else:
                raise InvalidError("metadata.name is required")
        namespace = namespace or meta.get("namespace") or ""
        key = self._key(resource, cluster, namespace, name)
        if key in self._objects:
            raise AlreadyExistsError(f"{resource} {cluster}/{namespace}/{name} already exists")
        if resource == "namespaces" and self.namespace_lifecycle:
            # admission-style lifecycle finalizer, stamped synchronously at
            # create (as the real apiserver's NamespaceLifecycle admission
            # does) so a create+delete race can never skip the content
            # sweep in reconcilers/namespace.py
            fins = meta.setdefault("finalizers", [])
            if "kubernetes" not in fins:
                fins.append("kubernetes")
        meta["namespace"] = namespace
        meta["clusterName"] = cluster
        meta["uid"] = meta.get("uid") or str(uuid.uuid4())
        meta["creationTimestamp"] = self._now()
        meta["generation"] = 1
        rv = self._next_rv()
        meta["resourceVersion"] = str(rv)
        obj = self._put_obj(key, obj)
        self._emit(ADDED, key, obj, rv, tc=tctx)
        rec = {"op": "put", "key": list(key), "obj": obj, "rv": rv}
        if tctx is not None:
            self._commit_trace(tctx, t0, key, rv, rec, obj)
        self._log_wal(rec)
        return copy.deepcopy(obj)

    def get(self, resource: str, cluster: str, name: str, namespace: str = "") -> dict:
        _inject("store.get")
        key = self._key(resource, cluster, namespace, name)
        obj = self._objects.get(key)
        if obj is None:
            raise NotFoundError(f"{resource} {cluster}/{namespace}/{name} not found")
        return copy.deepcopy(obj)

    def get_snapshot(self, resource: str, cluster: str, name: str,
                     namespace: str = "") -> dict:
        """The stored snapshot itself, no copy — the CoW read for encode
        paths (callers must not mutate the result; mutators start from
        :meth:`get`). Fault-injected exactly like :meth:`get` so cached
        and uncached serving fail identically under KCP_FAULTS."""
        _inject("store.get")
        key = self._key(resource, cluster, namespace, name)
        obj = self._objects.get(key)
        if obj is None:
            raise NotFoundError(f"{resource} {cluster}/{namespace}/{name} not found")
        return obj

    def update(
        self,
        resource: str,
        cluster: str,
        obj: dict,
        namespace: str = "",
        subresource: str | None = None,
    ) -> dict:
        self._race_guard.check()
        self._check_writable()
        self._check_cluster_writable(cluster)
        tctx = obs.write_ctx()
        t0 = time.time() if tctx is not None else 0.0
        _inject("store.put")
        obj = copy.deepcopy(obj)
        meta = self._meta(obj)
        name = meta.get("name")
        if not name:
            raise InvalidError("metadata.name is required")
        namespace = namespace or meta.get("namespace") or ""
        key = self._key(resource, cluster, namespace, name)
        existing = self._objects.get(key)
        if existing is None:
            raise NotFoundError(f"{resource} {cluster}/{namespace}/{name} not found")
        ex_meta = existing["metadata"]
        supplied_rv = meta.get("resourceVersion")
        if supplied_rv and supplied_rv != ex_meta["resourceVersion"]:
            raise ConflictError(
                f"{resource} {cluster}/{namespace}/{name}: stale resourceVersion "
                f"{supplied_rv} (current {ex_meta['resourceVersion']})"
            )
        if subresource == "status":
            new_obj = copy.deepcopy(existing)
            new_obj["status"] = obj.get("status")
        else:
            new_obj = obj
            # status is only writable through the status subresource
            if "status" in existing:
                new_obj["status"] = copy.deepcopy(existing["status"])
            elif "status" in new_obj:
                del new_obj["status"]
        new_meta = new_obj.setdefault("metadata", {})
        if subresource != "status":
            # metadata edits (labels/annotations/finalizers) ride spec updates
            preserved = {
                "uid": ex_meta.get("uid"),
                "creationTimestamp": ex_meta.get("creationTimestamp"),
                "clusterName": cluster,
                "namespace": namespace,
                "name": name,
            }
            new_meta.update(preserved)
            if ex_meta.get("deletionTimestamp"):
                new_meta["deletionTimestamp"] = ex_meta["deletionTimestamp"]
        else:
            new_obj["metadata"] = copy.deepcopy(ex_meta)
            new_meta = new_obj["metadata"]

        spec_changed = subresource != "status" and self._non_status_changed(existing, new_obj)
        new_meta["generation"] = ex_meta.get("generation", 1) + (1 if spec_changed else 0)
        rv = self._next_rv()
        new_meta["resourceVersion"] = str(rv)
        new_obj = self._put_obj(key, new_obj)

        # finalizer-driven deletion completion
        if new_meta.get("deletionTimestamp") and not new_meta.get("finalizers"):
            self._del_obj(key)
            self._emit(DELETED, key, new_obj, rv, old=existing, tc=tctx)
            rec = {"op": "del", "key": list(key), "rv": rv}
            if tctx is not None:
                self._commit_trace(tctx, t0, key, rv, rec, None)
            self._log_wal(rec)
        else:
            self._emit(MODIFIED, key, new_obj, rv, old=existing, tc=tctx)
            rec = {"op": "put", "key": list(key), "obj": new_obj, "rv": rv}
            if tctx is not None:
                self._commit_trace(tctx, t0, key, rv, rec, new_obj)
            self._log_wal(rec)
        return copy.deepcopy(new_obj)

    def update_status(self, resource: str, cluster: str, obj: dict, namespace: str = "") -> dict:
        return self.update(resource, cluster, obj, namespace, subresource="status")

    def delete(self, resource: str, cluster: str, name: str, namespace: str = "") -> None:
        self._race_guard.check()
        self._check_writable()
        self._check_cluster_writable(cluster)
        tctx = obs.write_ctx()
        t0 = time.time() if tctx is not None else 0.0
        _inject("store.delete")
        key = self._key(resource, cluster, namespace, name)
        existing = self._objects.get(key)
        if existing is None:
            raise NotFoundError(f"{resource} {cluster}/{namespace}/{name} not found")
        meta = existing["metadata"]
        if meta.get("finalizers"):
            if not meta.get("deletionTimestamp"):
                obj = copy.deepcopy(existing)
                obj["metadata"]["deletionTimestamp"] = self._now()
                rv = self._next_rv()
                obj["metadata"]["resourceVersion"] = str(rv)
                obj = self._put_obj(key, obj)
                self._emit(MODIFIED, key, obj, rv, old=existing, tc=tctx)
                rec = {"op": "put", "key": list(key), "obj": obj, "rv": rv}
                if tctx is not None:
                    self._commit_trace(tctx, t0, key, rv, rec, obj)
                self._log_wal(rec)
            return
        self._del_obj(key)
        rv = self._next_rv()
        self._emit(DELETED, key, existing, rv, old=existing, tc=tctx)
        rec = {"op": "del", "key": list(key), "rv": rv}
        if tctx is not None:
            self._commit_trace(tctx, t0, key, rv, rec, None)
        self._log_wal(rec)

    # --------------------------------------------------------------- list

    def list(
        self,
        resource: str,
        cluster: str = WILDCARD,
        namespace: str | None = None,
        selector: LabelSelector | None = None,
    ) -> tuple[list[dict], int]:
        """Return (items, list resourceVersion).

        Indexed mode walks only the (resource, cluster, namespace)
        candidate buckets and returns shared references (CoW contract:
        callers must not mutate items — re-``get`` or deepcopy before
        editing). Legacy mode is the pre-index O(total-objects) scan
        with a deepcopy per match.
        """
        _inject("store.list")
        selector = selector or everything()
        if not self._indexed:
            out = []
            for (res, cl, ns, _name), obj in self._objects.items():
                if res != resource:
                    continue
                if cluster != WILDCARD and cl != cluster:
                    continue
                if namespace is not None and ns != namespace:
                    continue
                labels = (obj.get("metadata") or {}).get("labels") or {}
                if not selector.matches(labels):
                    continue
                out.append(copy.deepcopy(obj))
            out.sort(key=lambda o: (o["metadata"].get("clusterName", ""),
                                    o["metadata"].get("namespace", ""),
                                    o["metadata"]["name"]))
            self._list_metrics(len(self._objects), len(out))
            return out, self._rv

        scanned = 0
        pairs: list[tuple[Key, dict]] = []
        res_b = self._buckets.get(resource)
        if res_b:
            if cluster != WILDCARD:
                cl_bs = [res_b[cluster]] if cluster in res_b else []
            else:
                cl_bs = list(res_b.values())
            empty = selector.empty
            for cl_b in cl_bs:
                if namespace is not None:
                    ns_bs = [cl_b[namespace]] if namespace in cl_b else []
                else:
                    ns_bs = list(cl_b.values())
                for ns_b in ns_bs:
                    scanned += len(ns_b)
                    if empty:
                        pairs.extend(ns_b.items())
                    else:
                        for key, obj in ns_b.items():
                            labels = (obj.get("metadata") or {}).get("labels") or {}
                            if selector.matches(labels):
                                pairs.append((key, obj))
        # key order == metadata (clusterName, namespace, name) order: the
        # key IS the metadata triple (resource is constant here and keys
        # are unique, so the dicts never get compared), and the bare
        # tuple sort stays in C — no per-element key lambda
        pairs.sort()
        out = [obj for _, obj in pairs]
        self._list_metrics(scanned, len(out))
        return out, self._rv

    @staticmethod
    def _list_metrics(scanned: int, returned: int) -> None:
        REGISTRY.counter("store_list_scanned_total",
                         "objects examined by store list scans").inc(scanned)
        REGISTRY.counter("store_list_returned_total",
                         "objects returned by store lists").inc(returned)

    def set_usage_hook(self, hook) -> None:
        """Install the per-mutation usage callback
        ``hook(resource, cluster, delta)`` (admission quota ledger)."""
        self._usage_hook = hook

    def counts(self) -> dict[tuple[str, str], int]:
        """Object counts per (resource, cluster) from the secondary
        index — the naive full recount the quota ledger reconciles
        against (bucket lengths only, no object walk)."""
        return {
            (r, c): sum(len(ns) for ns in cl.values())
            for r, res in self._buckets.items()
            for c, cl in res.items()
        }

    def resources(self) -> list[str]:
        """Distinct resource names present in the store."""
        return sorted(self._buckets)

    def clusters(self) -> list[str]:
        """Distinct logical-cluster names present in the store."""
        return sorted({c for res in self._buckets.values() for c in res})

    def __len__(self) -> int:
        return len(self._objects)

    # ------------------------------------------------ encode-once serving

    @property
    def encode_cache_enabled(self) -> bool:
        """True when serving paths may splice cached snapshot bytes
        (KCP_ENCODE_CACHE on an indexed/CoW store)."""
        return self._encode_cache

    def encode_obj(self, obj: dict) -> bytes:
        """Default-format JSON bytes of a stored snapshot, computed once
        per snapshot object.

        The bytes are valid for exactly as long as the snapshot object is
        reachable: CoW means a mutation replaces the snapshot, so a stale
        entry can never be looked up again (its id only matches while the
        entry's own strong reference keeps the old object alive). The
        ``encode.cache`` fault point force-drops a cached entry to
        exercise the re-encode fallback.
        """
        if not self._encode_cache:
            return json.dumps(obj).encode()
        ent = self._enc_bytes.get(id(obj))
        if ent is not None and ent[0] is obj:
            if should_drop("encode.cache"):
                del self._enc_bytes[id(obj)]
            else:
                if self._sanitize:
                    _sanitize.verify_bytes(
                        ent[1], json.dumps(obj).encode(), "snapshot bytes")
                self._enc_hits.inc()
                self._enc_shared.inc(len(ent[1]))
                return ent[1]
        data = json.dumps(obj).encode()
        self._enc_misses.inc()
        self._enc_bytes[id(obj)] = (obj, data)
        return data

    def encode_many(self, objs: list[dict]) -> list[bytes]:
        """:meth:`encode_obj` over a list result, with the per-item
        bookkeeping hoisted out of the loop (one counter update per call,
        fault checks only while an injector is active) — the list
        response splice path runs this over 100k items per request."""
        if not self._encode_cache:
            return [json.dumps(o).encode() for o in objs]
        from .. import faults as _faults

        if (_faults._ACTIVE is not None or not _faults._ENV_CHECKED
                or self._sanitize):
            # an active KCP_FAULTS schedule must see one encode.cache
            # decision per entry, exactly like the per-item path — and
            # the sanitizer verifies each hit there
            return [self.encode_obj(o) for o in objs]
        cache = self._enc_bytes
        dumps = json.dumps
        out: list[bytes] = []
        hits = misses = shared = 0
        for o in objs:
            ent = cache.get(id(o))
            if ent is not None and ent[0] is o:
                data = ent[1]
                hits += 1
                shared += len(data)
            else:
                data = dumps(o).encode()
                cache[id(o)] = (o, data)
                misses += 1
            out.append(data)
        if hits:
            self._enc_hits.inc(hits)
            self._enc_shared.inc(shared)
        if misses:
            self._enc_misses.inc(misses)
        return out

    def list_encoded(
        self,
        resource: str,
        cluster: str = WILDCARD,
        namespace: str | None = None,
    ) -> tuple[list[bytes], int]:
        """Encode-once fast path for *unselected* lists: ``(spans, rv)``
        where each span is one candidate bucket's sorted item bytes
        pre-joined with ``b", "`` — from the per-bucket span caches, so
        an unchanged bucket costs one list append instead of a sort +
        per-item probe (the caller splices spans straight into the
        response envelope with a single join). Scope semantics, result
        ordering, fault injection and list metrics are identical to
        :meth:`list` with an empty selector (bucket keys iterate in
        sorted order, which *is* the global ``(clusterName, namespace,
        name)`` sort — resource is constant and names sort within their
        bucket)."""
        _inject("store.list")
        scanned = 0
        spans: list[bytes] = []
        res_b = self._buckets.get(resource)
        if res_b:
            if cluster != WILDCARD:
                cl_keys = [cluster] if cluster in res_b else []
            else:
                cl_keys = sorted(res_b)
            for c in cl_keys:
                cl_b = res_b[c]
                if namespace is not None:
                    ns_keys = [namespace] if namespace in cl_b else []
                else:
                    ns_keys = sorted(cl_b)
                for n in ns_keys:
                    ns_b = cl_b[n]
                    scanned += len(ns_b)
                    spans.append(self._bucket_span((resource, c, n), ns_b))
        self._list_metrics(scanned, scanned)  # empty selector: all returned
        return spans, self._rv

    def _bucket_span(self, bk: tuple[str, str, str], ns_b: dict) -> bytes:
        from .. import faults as _faults

        ver = self._bucket_ver.get(bk, 0)
        if _faults._ACTIVE is None and _faults._ENV_CHECKED \
                and not self._sanitize:
            ent = self._span_cache.get(bk)
            if ent is not None and ent[0] == ver:
                self._enc_hits.inc()
                self._enc_shared.inc(len(ent[1]))
                return ent[1]
            span = b", ".join(self.encode_many(
                [obj for _, obj in sorted(ns_b.items())]))
            self._span_cache[bk] = (ver, span)
            return span
        # active fault schedule: every entry decision must reach the
        # per-record cache (encode.cache drops), so spans are neither
        # read nor stored
        return b", ".join(self.encode_many(
            [obj for _, obj in sorted(ns_b.items())]))

    # ------------------------------------------- paginated (chunked) lists

    def _page_metrics(self) -> None:
        REGISTRY.counter("list_pages_total",
                         "list pages served (limit/continue chunking)").inc()

    def _check_continue_window(self, rv_pin: int) -> None:
        """A continue token is only honorable while the watch window
        still covers ``(rv_pin, now]`` — the exact bound a watch resume
        uses, because the RV pin is reconstructed from the same retained
        history. Outside it: typed 410, the client re-lists."""
        if rv_pin > self._rv:
            REGISTRY.counter("list_continue_410_total",
                             "continue tokens answered with 410").inc()
            raise GoneError(
                f"continue token rv {rv_pin} is ahead of this store's "
                f"rv {self._rv}; re-list")
        if rv_pin < self._rv:
            oldest = self._history[0].rv if self._history else None
            if oldest is None or oldest > rv_pin + 1:
                REGISTRY.counter("list_continue_410_total",
                                 "continue tokens answered with 410").inc()
                raise GoneError(
                    f"continue token expired: pinned rv {rv_pin}, oldest "
                    f"retained {oldest}; re-list")

    def _pairs_at_pin(
        self,
        resource: str,
        cluster: str,
        namespace: str | None,
        rv_pin: int,
    ) -> list[tuple[Key, dict]]:
        """Sorted scoped ``(key, obj)`` pairs exactly as of ``rv_pin``
        (caller has verified the window covers the gap): start from the
        live buckets and undo retained events newer than the pin, newest
        first — ``old_object`` is the CoW snapshot each event displaced,
        so the rewound objects ARE the objects a list at ``rv_pin``
        returned, byte-cache and all."""
        pairs: dict[Key, dict] = {}
        res_b = self._buckets.get(resource)
        if res_b:
            if cluster != WILDCARD:
                cl_bs = [res_b[cluster]] if cluster in res_b else []
            else:
                cl_bs = list(res_b.values())
            for cl_b in cl_bs:
                if namespace is not None:
                    ns_bs = [cl_b[namespace]] if namespace in cl_b else []
                else:
                    ns_bs = list(cl_b.values())
                for ns_b in ns_bs:
                    pairs.update(ns_b)
        if rv_pin < self._rv:
            for ev in reversed(self._resume_slice(rv_pin)):
                if ev.resource != resource:
                    continue
                if cluster != WILDCARD and ev.cluster != cluster:
                    continue
                if namespace is not None and ev.namespace != namespace:
                    continue
                if ev.type == ADDED:
                    pairs.pop(ev.key, None)
                else:  # MODIFIED / DELETED: restore the displaced snapshot
                    if ev.old_object is not None:
                        pairs[ev.key] = ev.old_object
        return sorted(pairs.items())

    def list_page(
        self,
        resource: str,
        cluster: str = WILDCARD,
        namespace: str | None = None,
        selector: LabelSelector | None = None,
        limit: int = 0,
        continue_token: str | None = None,
    ) -> tuple[list[dict], int, str]:
        """KEP-365-style chunked list: ``(items, rv, next_token)``.

        The first page pins the list at the current rv; every
        continuation serves from the state *as of that pin* (rewound via
        the retained watch window), so concatenated pages are exactly
        the one-shot list at the pinned rv no matter what mutated in
        between. A token the window no longer covers answers typed 410.
        With a selector, the continue key is the last *matched* item's
        key — the filtered order is a subsequence of the raw key order,
        so the resume position is still exact.
        """
        _inject("store.list")
        selector = selector or everything()
        if (limit <= 0 and not continue_token) or not self._indexed:
            # no chunking asked for — or the legacy store, which has no
            # CoW history to pin against: serve the one-shot list (no
            # continue, so paging clients fall back cleanly)
            items, rv = self.list(resource, cluster, namespace, selector)
            return items, rv, ""
        last_key: tuple | None = None
        if continue_token:
            try:
                rv_pin, last_key = decode_continue(continue_token)
            except ValueError:
                REGISTRY.counter("list_continue_410_total",
                                 "continue tokens answered with 410").inc()
                raise GoneError("malformed continue token; re-list") \
                    from None
            self._check_continue_window(rv_pin)
        else:
            self._flush_events()
            rv_pin = self._rv
        pairs = self._pairs_at_pin(resource, cluster, namespace, rv_pin)
        boundary = (resource,) + last_key if last_key is not None else None
        out: list[dict] = []
        scanned = 0
        next_token = ""
        last_included: Key | None = None
        empty = selector.empty
        for key, obj in pairs:
            if boundary is not None and key <= boundary:
                continue
            scanned += 1
            if not empty:
                labels = (obj.get("metadata") or {}).get("labels") or {}
                if not selector.matches(labels):
                    continue
            if limit > 0 and len(out) >= limit:
                next_token = encode_continue(rv_pin, last_included[1:])
                break
            out.append(obj)
            last_included = key
        self._list_metrics(scanned, len(out))
        self._page_metrics()
        return out, rv_pin, next_token

    def list_encoded_page(
        self,
        resource: str,
        cluster: str = WILDCARD,
        namespace: str | None = None,
        limit: int = 0,
        continue_token: str | None = None,
    ) -> tuple[list[bytes], int, str]:
        """Encode-once chunked list for *unselected* scopes:
        ``(spans, rv, next_token)``. The current-rv page walks the
        sorted buckets and splices whole cached :meth:`_bucket_span`
        entries for every fully-included bucket, encoding only the
        boundary slices — a page over unchanged buckets costs list
        appends, not encodes. Pinned-in-the-past pages rewind through
        the watch window like :meth:`list_page`; the rewound snapshots
        still hit the per-object byte cache, so pages stay
        byte-identical to the one-shot body at the pinned rv."""
        _inject("store.list")
        if limit <= 0 and not continue_token:
            spans, rv = self.list_encoded(resource, cluster, namespace)
            return spans, rv, ""
        last_key: tuple | None = None
        if continue_token:
            try:
                rv_pin, last_key = decode_continue(continue_token)
            except ValueError:
                REGISTRY.counter("list_continue_410_total",
                                 "continue tokens answered with 410").inc()
                raise GoneError("malformed continue token; re-list") \
                    from None
            self._check_continue_window(rv_pin)
        else:
            self._flush_events()
            rv_pin = self._rv
        if rv_pin == self._rv:
            return self._encoded_page_current(
                resource, cluster, namespace, limit, last_key, rv_pin)
        pairs = self._pairs_at_pin(resource, cluster, namespace, rv_pin)
        if last_key is not None:
            boundary = (resource,) + last_key
            pairs = [p for p in pairs if p[0] > boundary]
        page = pairs[:limit] if limit > 0 else pairs
        # per-item spans, never a page-wide join: the envelope's parts
        # join (one allocation, at send) is the only materialization
        spans = self.encode_many([o for _, o in page]) if page else []
        next_token = ""
        if limit > 0 and len(pairs) > limit:
            k = page[-1][0]
            next_token = encode_continue(rv_pin, k[1:])
        self._list_metrics(len(page), len(page))
        self._page_metrics()
        return spans, rv_pin, next_token

    def _encoded_page_current(
        self,
        resource: str,
        cluster: str,
        namespace: str | None,
        limit: int,
        last_key: tuple | None,
        rv_pin: int,
    ) -> tuple[list[bytes], int, str]:
        spans: list[bytes] = []
        scanned = 0
        returned = 0
        next_token = ""
        last_included: tuple | None = None
        remaining = limit if limit > 0 else None
        res_b = self._buckets.get(resource)
        buckets: list[tuple[str, str, dict]] = []
        if res_b:
            if cluster != WILDCARD:
                cl_keys = [cluster] if cluster in res_b else []
            else:
                cl_keys = sorted(res_b)
            for c in cl_keys:
                cl_b = res_b[c]
                if namespace is not None:
                    ns_keys = [namespace] if namespace in cl_b else []
                else:
                    ns_keys = sorted(cl_b)
                for n in ns_keys:
                    buckets.append((c, n, cl_b[n]))
        for c, n, ns_b in buckets:
            if not ns_b:
                continue
            if last_key is not None and (c, n) < tuple(last_key[:2]):
                continue  # bucket wholly before the cursor
            items = sorted(ns_b.items())
            whole_bucket = True
            if last_key is not None and (c, n) == tuple(last_key[:2]):
                items = [kv for kv in items if kv[0][3] > last_key[2]]
                whole_bucket = False
                if not items:
                    continue
            if remaining is not None and remaining == 0:
                # page is full and at least one more item exists
                next_token = encode_continue(rv_pin, last_included)
                break
            scanned += len(ns_b)
            if remaining is None or len(items) <= remaining:
                if whole_bucket:
                    # fully-included untouched bucket: splice its cached
                    # span — the same bytes the unpaged path serves
                    spans.append(self._bucket_span((resource, c, n), ns_b))
                else:
                    # boundary slice: per-item cached spans, no join —
                    # the envelope assembles them at send time
                    spans.extend(self.encode_many([o for _, o in items]))
                returned += len(items)
                if remaining is not None:
                    remaining -= len(items)
                last_included = (c, n, items[-1][0][3])
            else:
                take = items[:remaining]
                spans.extend(self.encode_many([o for _, o in take]))
                returned += len(take)
                remaining = 0
                last_included = (c, n, take[-1][0][3])
                # this bucket has more: certainly another page
                next_token = encode_continue(rv_pin, last_included)
                break
        self._list_metrics(scanned, returned)
        self._page_metrics()
        return spans, rv_pin, next_token

    def encode_event(self, ev: Event) -> bytes:
        """The encoded watch wire line ``{"type": ..., "object": ...}\\n``
        for an event, computed once and cached on the event itself — the
        store's batched fan-out pushes the *same* Event instance to every
        matched watch, so 64 relays splice one encoding. Byte-identical
        to ``json.dumps({"type": ev.type, "object": ev.object})``."""
        if self._encode_cache:
            line = ev.__dict__.get("_enc_line")
            if line is not None:
                if should_drop("encode.cache"):
                    object.__setattr__(ev, "_enc_line", None)
                else:
                    if self._sanitize:
                        _sanitize.verify_bytes(
                            line,
                            json.dumps({"type": ev.type,
                                        "object": ev.object}).encode()
                            + b"\n",
                            "watch event line")
                    self._enc_hits.inc()
                    self._enc_shared.inc(len(line))
                    return line
        # DELETED events (and events outlived by later writes) carry a
        # snapshot that is no longer the stored one — encode it without
        # touching the per-record cache, or dead snapshots would pin
        # entries forever. The line cache above still shares the work.
        if self._encode_cache and self._objects.get(ev.key) is ev.object:
            body = self.encode_obj(ev.object)
        else:
            body = json.dumps(ev.object).encode()
            if self._encode_cache:
                self._enc_misses.inc()
        line = (b'{"type": ' + json.dumps(ev.type).encode()
                + b', "object": ' + body + b'}\n')
        if self._encode_cache:
            object.__setattr__(ev, "_enc_line", line)
        return line

    def encode_events(self, evs: list[Event]) -> list[bytes]:
        """:meth:`encode_event` over a relay batch with the per-line
        bookkeeping hoisted out of the loop (the 64-watcher fan-out runs
        this once per watcher per burst — the hit path must cost a dict
        probe, not a metrics transaction)."""
        from .. import faults as _faults

        if (not self._encode_cache or _faults._ACTIVE is not None
                or not _faults._ENV_CHECKED or self._sanitize):
            return [self.encode_event(ev) for ev in evs]
        out: list[bytes] = []
        hits = shared = 0
        for ev in evs:
            line = ev.__dict__.get("_enc_line")
            if line is None:
                line = self.encode_event(ev)  # miss path counts itself
            else:
                hits += 1
                shared += len(line)
            out.append(line)
        if hits:
            self._enc_hits.inc(hits)
            self._enc_shared.inc(shared)
        return out

    # -------------------------------------------------------------- watch

    def watch(
        self,
        resource: str,
        cluster: str = WILDCARD,
        namespace: str | None = None,
        selector: LabelSelector | None = None,
        since_rv: int | None = None,
    ) -> Watch:
        """Subscribe. With ``since_rv``, replays retained history > since_rv."""
        # flush before subscribing: pending events predate this watch and
        # must not be delivered live (the since_rv replay below covers
        # them from history when asked to)
        self._flush_events()
        if (self.reject_future_rv and since_rv is not None
                and since_rv > self._rv):
            # RV-honest replica serving: the caller resumes from a point
            # this store has not applied yet (it read a fresher primary).
            # Never fabricate freshness — typed 410, the client re-lists
            # (or the router retries against the primary).
            raise GoneError(
                f"requested rv {since_rv} is ahead of this replica's "
                f"applied rv {self._rv}; re-list (or read the primary)")
        if since_rv is not None and cluster != WILDCARD:
            floor = self._migration_floors.get(cluster)
            if floor is not None and since_rv < floor:
                # the cluster migrated ONTO this shard at `floor`: any
                # smaller rv was minted by the old owner's independent
                # counter — resuming from it here would be a silent
                # partial resume against an unrelated history. Typed
                # 410: the client re-lists and resumes from local RVs.
                raise GoneError(
                    f"cluster {cluster} migrated onto this shard at rv "
                    f"{floor}; rv {since_rv} predates the move — re-list")
        w = Watch(self, resource, cluster, namespace, selector or everything())
        if self._indexed and not w.selector.empty:
            self._subscribe_selector(w)
        if since_rv is not None and since_rv < self._rv:
            # the retained history must cover (since_rv, now]; otherwise the
            # caller missed events it can never recover (e.g. resuming a
            # pre-restart RV against a WAL-restored store) and must re-list
            oldest = self._history[0].rv if self._history else None
            if oldest is None or oldest > since_rv + 1:
                # typed 410 (GoneError subclasses ConflictError, so the
                # pre-typed except clauses keep working): consumers
                # re-list immediately instead of backoff-retrying
                raise GoneError(
                    f"watch window expired: requested rv {since_rv}, oldest retained {oldest}"
                )
            # shared window resume: one bisect over the window's rv index
            # (shared by every resuming watcher — a 10k-watcher reconnect
            # storm costs 10k binary searches over ONE index, not 10k
            # history scans), replaying the suffix through the watch's
            # own selector transform. The replayed Event objects are the
            # window's own instances, so the encode-once wire bytes are
            # shared across every resumer too.
            for ev in self._resume_slice(since_rv):
                out = w._transform(ev)
                if out is not None:
                    w._push(out)
        if not w._closed:
            # an injected drop/evict during replay already closed (and
            # unregistered) the watch — registering it would leak a dead
            # entry in the hub index
            self._watches.append(w)
            self._watches_by_res.setdefault(resource, []).append(w)
            self._watch_ver[resource] = self._watch_ver.get(resource, 0) + 1
        return w

    def _resume_slice(self, since_rv: int) -> list[Event]:
        """The window events with rv > since_rv, from the shared mirror
        index (rebuilt only when direct history surgery desynced it)."""
        from bisect import bisect_right

        h = self._history
        es, rs, start = self._hist_events, self._hist_rvs, self._hist_start
        live = len(es) - start
        if (live == len(h) and live > 0
                and es[start] is h[0] and es[-1] is h[-1]):
            self._resume_shared.inc()
        else:
            # out of sync (tests swap/shrink the deque; resyncs clear it):
            # rebuild the mirror from the deque once, then bisect
            es = self._hist_events = list(h)
            rs = self._hist_rvs = [e.rv for e in es]
            start = self._hist_start = 0
        return es[bisect_right(rs, since_rv, start):]

    def _note_history(self, ev: Event) -> None:
        """Mirror one appended history event into the shared resume
        index; trims to the deque's live length and compacts lazily."""
        es, rs = self._hist_events, self._hist_rvs
        es.append(ev)
        rs.append(ev.rv)
        excess = (len(es) - self._hist_start) - len(self._history)
        if excess > 0:
            self._hist_start += excess
            if self._hist_start > 65536:
                del es[:self._hist_start]
                del rs[:self._hist_start]
                self._hist_start = 0

    def _emit(self, etype: str, key: Key, obj: dict, rv: int, old: dict | None = None,
              tc=None) -> None:
        if not self._indexed:
            ev = Event(
                etype, key[0], key[1], key[2], key[3], copy.deepcopy(obj), rv,
                copy.deepcopy(old) if old is not None else None,
            )
            if tc is not None:
                # the committing write's trace context rides the shared
                # Event (one stamp for every watcher — the encode-once
                # discipline applied to causality); out-of-band like
                # _enc_line, never on the wire
                object.__setattr__(ev, "_tc", tc)
            self._history.append(ev)
            self._note_history(ev)
            # snapshot: an injected watch drop closes (and unsubscribes)
            # the watch from inside _push, mid-iteration
            for w in list(self._watches):
                out = w._transform(ev)
                if out is not None:
                    w._push(out)
            return
        # CoW: stored snapshots are never mutated in place (every write
        # replaces the whole dict), so the event shares them — the
        # per-event double deepcopy of the legacy path is gone
        ev = Event(etype, key[0], key[1], key[2], key[3], obj, rv, old)
        if tc is not None:
            object.__setattr__(ev, "_tc", tc)
        self._history.append(ev)
        self._note_history(ev)
        self._pending.append(ev)
        if len(self._pending) >= self._emit_batch:
            self._flush_events()
        elif not self._flush_scheduled:
            if self._gc_sink():
                # group commit: this mutation's _log_wal joins (or
                # opens) a commit window, whose flush delivers the
                # fan-out once for the whole window — no per-mutation
                # scheduling (watch()/drain() still flush lazily, and
                # sync-context callers never scheduled here anyway)
                return
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                return  # sync context: consumers flush lazily on access
            self._flush_scheduled = True
            loop.call_soon(self._flush_events)

    # ------------------------------------------------- batched fan-out

    def _flush_events(self) -> None:
        """Deliver pending events to all watches in one vectorized pass.

        Reentrancy-safe: an injected watch drop closes a watch from
        inside delivery, and close() itself flushes first.
        """
        self._flush_scheduled = False
        if self._flushing or not self._pending:
            return
        batch, self._pending = self._pending, []
        self._flushing = True
        t0 = time.perf_counter()
        try:
            self._fanout(batch)
        finally:
            self._flushing = False
            dt = time.perf_counter() - t0
            REGISTRY.histogram("watch_fanout_batch_size",
                               "events coalesced per watch fan-out pass",
                               buckets=SIZE_BUCKETS).observe(len(batch))
            REGISTRY.histogram("store_emit_seconds",
                               "time delivering one fan-out batch").observe(dt)
            if obs.TRACER.enabled:
                # attribute the flush to the first sampled event's trace
                # (the batch shares one delivery pass; one span suffices)
                for ev in batch:
                    tc = ev.__dict__.get("_tc")
                    if tc is not None:
                        now = time.time()
                        obs.record_span(
                            "store.fanout", obs.TRACER.child(tc),
                            tc.span_id, now - dt, dt,
                            {"events": len(batch)})
                        break

    def _fanout(self, batch: list[Event]) -> None:
        if not self._watches:
            return
        by_res: dict[str, list[Event]] = {}
        for ev in batch:
            by_res.setdefault(ev.resource, []).append(ev)
        for res, evs in by_res.items():
            if self._watches_by_res.get(res):
                self._fanout_resource(res, evs)

    def _cid(self, cluster: str) -> int:
        i = self._intern_cl.get(cluster)
        if i is None:
            i = self._intern_cl[cluster] = len(self._intern_cl)
        return i

    def _nid(self, namespace: str) -> int:
        i = self._intern_ns.get(namespace)
        if i is None:
            i = self._intern_ns[namespace] = len(self._intern_ns)
        return i

    def _fanout_plan(self, res: str):
        """The per-resource fan-out plan — the watch partition plus the
        per-watch scope/selector arrays — cached per watch-set version.
        Rebuilding this per flush was O(watches) python per mutation
        batch; at 10k live watchers the cache makes a flush O(events +
        deliveries) with the [N, C] algebra in numpy."""
        ver = self._watch_ver.get(res, 0)
        plan = self._fanout_cache.get(res)
        if plan is not None and plan[0] == ver:
            return plan
        ws = [w for w in self._watches_by_res.get(res, ()) if not w._closed]
        fb_ws = [w for w in ws if not w.selector.empty
                 and w._eq_pid is None and w._compiled is None]
        mx_ws = [w for w in ws if w.selector.empty
                 or w._eq_pid is not None or w._compiled is not None]
        w_cl = np.array([-2 if w.cluster == WILDCARD
                         else self._cid(w.cluster) for w in mx_ws], np.int32)
        w_ns = np.array([-2 if w.namespace is None
                         else self._nid(w.namespace) for w in mx_ws], np.int32)
        eq_cols = [ci for ci, w in enumerate(mx_ws) if w._eq_pid is not None]
        gen_cols = [ci for ci, w in enumerate(mx_ws) if w._compiled is not None]
        empty_cols = [ci for ci, w in enumerate(mx_ws) if w.selector.empty]
        sels = (np.array([mx_ws[ci]._eq_pid for ci in eq_cols], np.uint32)
                if eq_cols else None)
        plan = (ver, mx_ws, fb_ws, w_cl, w_ns, eq_cols, gen_cols,
                empty_cols, sels)
        self._fanout_cache[res] = plan
        return plan

    def _fanout_resource(self, res: str, evs: list[Event]) -> None:
        """One resource's events x that resource's watches, as matrices.

        Selector matching is one vectorized pass over interned label ids:
        single-equality selectors (the syncer shape) via fanout_match_np,
        kernel-shaped ones via match_batch_np, oversized ones via the
        exact per-event python path. Scope and the old-match/new-match
        ADDED/MODIFIED/DELETED rewrite of :meth:`Watch._transform` are
        then [N, C] boolean algebra; python touches only the (sparse)
        deliveries. Per-watch arrays come from the cached fan-out plan.
        """
        n = len(evs)
        (_ver, mx_ws, fb_ws, w_cl, w_ns, eq_cols, gen_cols, empty_cols,
         sels) = self._fanout_plan(res)
        if mx_ws:
            c = len(mx_ws)
            # scope[N, C]: cluster/namespace ids from the store-global
            # intern tables (stable across batches, so the w_cl/w_ns
            # arrays are cached in the plan); wildcards are -2
            cl_ids = np.fromiter((self._cid(ev.cluster) for ev in evs),
                                 np.int32, n)
            ns_ids = np.fromiter((self._nid(ev.namespace) for ev in evs),
                                 np.int32, n)
            scope = ((w_cl[None, :] == -2) | (cl_ids[:, None] == w_cl[None, :])) \
                & ((w_ns[None, :] == -2) | (ns_ids[:, None] == w_ns[None, :]))

            is_add = np.fromiter((ev.type == ADDED for ev in evs), bool, n)
            is_del = np.fromiter((ev.type == DELETED for ev in evs), bool, n)
            is_mod = ~(is_add | is_del)

            nm = np.zeros((n, c), bool)
            om = np.zeros((n, c), bool)
            if eq_cols or gen_cols:
                from ..ops import labelmatch as lm

                pair_new, key_new = self._encode_labels(evs, old=False)
                pair_old, key_old = self._encode_labels(evs, old=True)
                if eq_cols:
                    nm[:, eq_cols] = lm.fanout_match_np(pair_new, sels)
                    om[:, eq_cols] = lm.fanout_match_np(pair_old, sels)
                for ci in gen_cols:
                    cs = mx_ws[ci]._compiled
                    nm[:, ci] = lm.match_batch_np(pair_new, key_new, cs)
                    om[:, ci] = lm.match_batch_np(pair_old, key_old, cs)
            if empty_cols:
                nm[:, empty_cols] = om[:, empty_cols] = True
            nm &= ~is_del[:, None]  # _transform: new_match is False on DELETED

            as_is = scope & ((is_add[:, None] & nm)
                             | (is_del[:, None] & (om | nm))
                             | (is_mod[:, None] & nm & om))
            to_add = scope & is_mod[:, None] & nm & ~om
            to_del = scope & is_mod[:, None] & ~nm & om
            # argwhere is row-major: per-watch delivery stays in rv order.
            # Rewritten (label-transition) events are built once per
            # source event and shared across every matched watch, so the
            # encode-once wire cache on the Event pays off for them too.
            rw_add: dict[int, Event] = {}
            rw_del: dict[int, Event] = {}
            for ni, ci in np.argwhere(as_is | to_add | to_del):
                w = mx_ws[ci]
                if w._closed:
                    continue
                ev = evs[ni]
                if as_is[ni, ci]:
                    w._push(ev)
                elif to_add[ni, ci]:
                    out = rw_add.get(ni)
                    if out is None:
                        out = rw_add[ni] = Event(
                            ADDED, ev.resource, ev.cluster, ev.namespace,
                            ev.name, ev.object, ev.rv, ev.old_object)
                    w._push(out)
                else:
                    out = rw_del.get(ni)
                    if out is None:
                        out = rw_del[ni] = Event(
                            DELETED, ev.resource, ev.cluster, ev.namespace,
                            ev.name, ev.object, ev.rv, ev.old_object)
                    w._push(out)
        for w in fb_ws:
            # oversized selector: exact per-event fallback
            for ev in evs:
                if w._closed:
                    break
                out = w._transform(ev)
                if out is not None:
                    w._push(out)

    def _encode_labels(self, evs: list[Event], old: bool) -> tuple[np.ndarray, np.ndarray]:
        """Interned (pair ids, key ids), 0-padded to the batch's widest
        label set — the host-twin encoding of ops/encode.encode_label_batch."""
        labels_list = []
        width = 1
        for ev in evs:
            obj = ev.old_object if old else ev.object
            labels = ((obj or {}).get("metadata") or {}).get("labels") or {}
            labels_list.append(labels)
            width = max(width, len(labels))
        pair = np.zeros((len(evs), width), np.uint32)
        keyh = np.zeros((len(evs), width), np.uint32)
        for i, labels in enumerate(labels_list):
            for j, (k, v) in enumerate(labels.items()):
                pair[i, j] = self._pid(k, v)
                keyh[i, j] = self._kid(k)
        return pair, keyh

    @staticmethod
    def _pair_token(k: str, v: Any):
        """Intern-table key for a label pair. Strings (the k8s case) key
        directly; non-string values get a type tag so e.g. 5 and "5"
        (unequal to the python matcher) can never intern to one id, and
        unhashable values fall back to their canonical JSON."""
        if isinstance(v, str):
            return (k, v)
        try:
            hash(v)
        except TypeError:
            return (k, "\x00json", json.dumps(v, sort_keys=True, default=str))
        return (k, "\x00" + type(v).__name__, v)

    def _pid(self, k: str, v: Any) -> int:
        tok = self._pair_token(k, v)
        i = self._intern_pairs.get(tok)
        if i is None:
            i = self._intern_pairs[tok] = len(self._intern_pairs) + 1
        return i

    def _kid(self, k: str) -> int:
        i = self._intern_keys.get(k)
        if i is None:
            i = self._intern_keys[k] = len(self._intern_keys) + 1
        return i

    def _subscribe_selector(self, w: Watch) -> None:
        """Compile a watch's selector for the vectorized fan-out."""
        eq = w.selector.single_equality
        if eq is not None:
            w._eq_pid = self._pid(*eq)
            return
        if self._labelmatch is None:
            from ..ops import labelmatch

            self._labelmatch = labelmatch
        # oversized selectors return None => exact per-event fallback
        # (counted in labelmatch_fallback_total)
        w._compiled = self._labelmatch.try_compile_selector(
            w.selector, pair_hash=self._pid, key_hash=self._kid)

    def _unsubscribe(self, w: Watch) -> None:
        try:
            self._watches.remove(w)
        except ValueError:
            pass
        ws = self._watches_by_res.get(w.resource)
        if ws is not None:
            try:
                ws.remove(w)
            except ValueError:
                return  # never registered (closed during resume replay)
            if not ws:
                del self._watches_by_res[w.resource]
            self._watch_ver[w.resource] = \
                self._watch_ver.get(w.resource, 0) + 1

    # ---------------------------------------------------------- durability

    def set_repl_hook(self, hook, batch=None) -> None:
        """Install the per-commit replication callback ``hook(rec)``
        (rec is the WAL record dict: op/key/rv and obj for puts). Fires
        for every committed mutation regardless of durability backend —
        the ReplicationHub ships exactly what the WAL records. ``batch``
        (``batch(recs)``) is the group-commit form: a flushed window
        ships once through it instead of once per record."""
        self._repl_hook = hook
        self._repl_batch = batch

    # ------------------------------------------------------- group commit

    def commit_durable(self, rv: int | None = None):
        """Awaitable durability barrier for the write-serving path: the
        open commit window's future, or None when every committed
        mutation is already synced (group commit off, sync-context
        writes, or the window already flushed — a failed flush raised at
        its triggering writer). The future resolves with the window's
        HIGH RV after the shared WAL append + sync, so every writer of a
        window can park its semi-sync standby wait on the same RV (one
        ack releases the whole window); a failed sync resolves it with
        the typed error instead — fail every writer, commit none.

        Callers reach this in the same event-loop step as their mutation
        (the store is loop-owned), so the open window is always the one
        their record joined.

        Idle fast path: when the loop has no other ready work, nothing
        can join this window before its scheduled flush — flush
        synchronously NOW and skip the loop round trip, so a lone writer
        pays exactly the serial path's latency (the linger-must-not-tax-
        the-idle-case guarantee). Busy loops keep the deferred flush and
        the batching it buys."""
        w = self._gc_window
        if w is None or not w.recs:
            return None
        if w.handle is None:  # call_soon mode (no timed linger)
            try:
                ready = len(asyncio.get_running_loop()._ready)
            except (RuntimeError, AttributeError):
                ready = 2  # non-CPython loop: keep the deferred flush
            if ready <= 1:
                # the only pending callback is this window's own flush
                self._gc_flush(w)
                if w.fut.cancelled() or w.fut.exception() is not None:
                    return w.fut  # the awaiter surfaces the typed failure
                return None  # already durable: no wait needed
        return w.fut

    def _gc_sink(self) -> bool:
        """True when mutations commit through group-commit windows (the
        feature is on and there is a sink — WAL or replication hook —
        to batch for)."""
        return self._gc_enabled and (
            self._engine is not None or self._wal is not None
            or self._repl_hook is not None)

    def _gc_open(self, loop) -> _CommitWindow:
        w = _CommitWindow(loop.create_future())
        # reconcilers and other in-process writers never await the
        # window: retrieve the exception eagerly so a failed sync with no
        # HTTP writer parked on it cannot log "never retrieved"
        w.fut.add_done_callback(lambda f: f.cancelled() or f.exception())
        self._gc_window = w
        if self._gc_linger_s > 0:
            w.handle = loop.call_later(self._gc_linger_s,
                                       self._gc_flush, w)
        else:
            # no timed linger: the window closes at the next loop pass —
            # everything already runnable this pass joins it, and a lone
            # writer pays one loop iteration, not a timer tick
            loop.call_soon(self._gc_flush, w)
        return w

    def _gc_barrier(self) -> None:
        """Flush any open commit window NOW — out-of-band WAL records
        (epoch stamps, snapshot compaction, close) must not overtake
        buffered mutations in the log."""
        w = self._gc_window
        if w is not None:
            self._gc_flush(w)

    def _gc_flush(self, w: _CommitWindow) -> None:
        """Close one commit window: ONE buffered WAL append + ONE sync
        for every record in it, then ship the replication batch, resolve
        the writers, and deliver the coalesced watch fan-out. A sync
        failure fails every writer with a typed 503 and commits NONE of
        the window's records (the serial path's failure contract, window
        wide)."""
        if w.flushed:
            return  # a size-bound split already flushed it under the timer
        w.flushed = True
        if self._gc_window is w:
            self._gc_window = None
        if w.handle is not None:
            w.handle.cancel()
        recs = w.recs
        if not recs:
            if not w.fut.done():
                w.fut.set_result(0)
            return
        try:
            _inject("store.commit_window")
            if self._engine is not None:
                self._append_engine_batch(recs)
            elif self._wal is not None and self._wal.fh is not None:
                t0 = time.perf_counter()
                self._wal.fh.write("".join(
                    json.dumps(rec, separators=(",", ":")) + "\n"
                    for rec in recs))
                self._wal_fh_sync(t0)
                self._wal.mutations_since_snapshot += len(recs)
        except BaseException as e:  # noqa: BLE001 — becomes every writer's 5xx
            err = e if isinstance(e, UnavailableError) else UnavailableError(
                f"commit window sync failed ({len(recs)} writes "
                f"uncommitted): {e}")
            err.__cause__ = None if e is err else e
            log.error("commit window FAILED: %s", err.message)
            if not w.fut.done():
                w.fut.set_exception(err)
            # deliver what was emitted (in-memory state advanced exactly
            # as a serial post-emit failure leaves it); nothing ships
            self._flush_events()
            return
        self._gc_windows_total.inc()
        self._gc_window_size.observe(len(recs))
        # replication ships AFTER the local sync: a window that dies
        # pre-sync was never acked anywhere — one batch, one queue push
        # per subscriber
        if self._repl_batch is not None:
            self._repl_batch(recs)
        elif self._repl_hook is not None:
            for rec in recs:
                self._repl_hook(rec)
        if not w.fut.done():
            w.fut.set_result(w.high_rv)
        # one fan-out flush per window (not per mutation)
        self._flush_events()
        if self._engine is not None:
            if self._engine_mutations >= self._engine_snapshot_every:
                self.snapshot()
        elif (self._wal is not None and self._wal.fh is not None
                and self._wal.mutations_since_snapshot
                >= self._wal.snapshot_every):
            self.snapshot()

    def _wal_fh_sync(self, t0: float) -> None:
        """Apply the KCP_WAL_SYNC policy to the JSON-lines WAL after an
        append (metered): ``flush`` pushes python's buffer to the OS,
        ``fsync`` additionally forces the platters, ``off`` leaves both
        to chance."""
        if self._wal_sync == "off":
            return
        fh = self._wal.fh
        fh.flush()
        if self._wal_sync == "fsync":
            os.fsync(fh.fileno())
        self._wal_sync_total.inc()
        self._wal_sync_seconds.observe(time.perf_counter() - t0)

    def _append_engine_batch(self, recs: list[dict]) -> None:
        """One native multi-record append (ws_batch_begin/commit): the
        whole window's records buffer into one write() and at most one
        fsync, per the KCP_WAL_SYNC policy."""
        t0 = time.perf_counter()
        ops = []
        for rec in recs:
            key = _wal_key(tuple(rec["key"]))
            if rec["op"] == "put":
                ops.append((key, json.dumps(
                    rec["obj"], separators=(",", ":")).encode("utf-8"),
                    rec["rv"]))
            else:
                ops.append((key, None, rec["rv"]))
        self._engine.append_batch(ops, fsync=self._wal_sync == "fsync")
        if self._wal_sync != "off":
            self._wal_sync_total.inc()
            self._wal_sync_seconds.observe(time.perf_counter() - t0)
        self._engine_mutations += len(recs)

    def _log_wal(self, rec: dict) -> None:
        if self._gc_sink():
            # group commit: join (or open) the commit window — the
            # record's durable append, replication ship, and fan-out
            # flush all happen at the window flush. Only under a running
            # loop: sync-context callers have nothing to drive the flush.
            w = self._gc_window
            if w is None:
                try:
                    loop = asyncio.get_running_loop()
                except RuntimeError:
                    loop = None
                if loop is not None:
                    w = self._gc_open(loop)
            if w is not None:
                w.recs.append(rec)
                rv = int(rec.get("rv", 0) or 0)
                if rv > w.high_rv:
                    w.high_rv = rv
                if (len(w.recs) >= self._gc_max
                        or should_drop("store.commit_window")):
                    # row bound reached (or an injected split drill):
                    # flush now — the failure, if any, surfaces on the
                    # shared future, which this writer is about to await
                    self._gc_flush(w)
                return
        # serial path: group commit off, or no loop to drive a window
        # (replication rides the WAL record stream: the hook sees every
        # committed record — in-memory stores included)
        if self._repl_hook is not None:
            self._repl_hook(rec)
        if self._engine is not None:
            key = _wal_key(tuple(rec["key"]))
            t0 = time.perf_counter()
            if rec["op"] == "put":
                self._engine.put(
                    key,
                    json.dumps(rec["obj"], separators=(",", ":")).encode("utf-8"),
                    rec["rv"],
                )
            else:
                self._engine.delete(key, rec["rv"])
            if self._wal_sync == "fsync":
                # per-record durability: the serial A/B reference whose
                # cost the commit window exists to amortize
                self._engine.flush()
                self._wal_sync_total.inc()
                self._wal_sync_seconds.observe(time.perf_counter() - t0)
            self._engine_mutations += 1
            if self._engine_mutations >= self._engine_snapshot_every:
                self.snapshot()
            return
        if self._wal is None or self._wal.fh is None:
            return
        t0 = time.perf_counter()
        self._wal.fh.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._wal_fh_sync(t0)
        self._wal.mutations_since_snapshot += 1
        if self._wal.mutations_since_snapshot >= self._wal.snapshot_every:
            self.snapshot()

    def _load_engine(self) -> None:
        assert self._engine is not None
        for key, val in self._engine.scan():
            parts = tuple(key.decode("utf-8").split("\x00"))
            self._put_obj(parts, json.loads(val))
        self._rv = self._engine.rv
        self.epoch = max(self.epoch, getattr(self._engine, "epoch", 0))
        # journal-only mode: this store holds the authoritative objects,
        # so the engine's duplicate value map would only double memory
        self._engine.release_index()

    # --------------------------------------------------------- replication

    def set_epoch(self, epoch: int) -> None:
        """Adopt a replication epoch (>= the current one; epochs never
        rewind) and persist it with the WAL so a restart cannot undo a
        fence or a promotion."""
        epoch = int(epoch)
        if epoch < self.epoch:
            raise InvalidError(
                f"epoch {epoch} < current {self.epoch}: epochs never rewind")
        self.epoch = epoch
        self._gc_barrier()  # the epoch record must not overtake a window
        if self._engine is not None:
            self._engine.set_epoch(epoch)
        elif self._wal is not None and self._wal.fh is not None:
            self._wal.fh.write(
                json.dumps({"op": "epoch", "epoch": epoch},
                           separators=(",", ":")) + "\n")
            self._wal.fh.flush()

    def fence(self, epoch: int) -> None:
        """A newer epoch superseded this store (a standby promoted over
        it): adopt the epoch and refuse all further writes. The zombie-
        primary kill switch — after this, the old primary can neither
        commit client writes nor ship records anywhere."""
        self.set_epoch(epoch)
        self.fenced = True
        self.read_only = f"fenced: epoch {epoch} superseded this primary"
        log.warning("store fenced at epoch %d: refusing writes", epoch)

    def apply_replicated(self, rec: dict, epoch: int | None = None) -> bool:
        """Apply one shipped WAL record exactly as the primary committed
        it: the record's RV becomes this store's RV (no local allocation,
        no admission, no validation — the primary already did all that),
        watch events fan out so replica informers stay live, and the
        record lands in the local WAL for replica durability.

        Records carrying an epoch older than this store's are rejected
        with a typed 410 (fencing: a zombie primary's late records must
        not land after a promotion). Records at or below the applied RV
        are no-ops (reconnect overlap), returning False.
        """
        self._race_guard.check()
        if epoch is not None and epoch < self.epoch:
            REGISTRY.counter(
                "repl_fenced_writes_total",
                "writes refused because this store was fenced by a "
                "newer replication epoch").inc()
            raise GoneError(
                f"replication record from epoch {epoch} rejected: this "
                f"store is at epoch {self.epoch}")
        op = rec.get("op")
        if op == "epoch":
            e = int(rec["epoch"])
            if e > self.epoch:
                self.set_epoch(e)
            return True
        rv = int(rec["rv"])
        if rv <= self._rv:
            return False
        key: Key = tuple(rec["key"])  # type: ignore[assignment]
        # the primary's sampled-write trace context rides the shipped
        # record: replica-side events carry the same causality, and the
        # re-logged record keeps it for chained followers
        tctx = obs.ctx_from_wal(rec.get("tc"))
        if op == "put":
            old = self._objects.get(key)
            # ownership transfer: the record dict was parsed off the
            # feed and is not shared — stored as the snapshot directly
            obj = self._put_obj(key, rec["obj"])
            self._rv = rv
            self._emit(MODIFIED if old is not None else ADDED,
                       key, obj, rv, old=old, tc=tctx)
            out_rec = {"op": "put", "key": list(key), "obj": obj,
                       "rv": rv}
            if tctx is not None:
                out_rec["tc"] = rec["tc"]
                obs.link_obj(obj, tctx)
            self._log_wal(out_rec)
        elif op == "del":
            existing = self._objects.get(key)
            self._del_obj(key)
            self._rv = rv
            if rec.get("mig"):
                # a migration purge on the primary: the object MOVED to
                # another shard, it was not deleted — no DELETED event
                # (a phantom delete would evict live informer caches);
                # cluster-scoped watchers on this replica are evicted to
                # a typed 410 so they relist against the new owner.
                for w in list(self._watches):
                    if w.cluster == key[1]:
                        w._evict()
            elif existing is not None:
                self._emit(DELETED, key, existing, rv, old=existing,
                           tc=tctx)
            out_rec = {"op": "del", "key": list(key), "rv": rv}
            if rec.get("mig"):
                out_rec["mig"] = 1
            if tctx is not None:
                out_rec["tc"] = rec["tc"]
            self._log_wal(out_rec)
        else:
            raise InvalidError(f"unknown replication record op {op!r}")
        return True

    # ----------------------------------------------------------- migration
    #
    # Live per-cluster migration (sharding/migrate.py): the source shard
    # fences one cluster at a cutover RV, streams its objects to the new
    # owner, the ring flips that one cluster, then the source purges it.
    # Source and target mint RVs independently, so migrated objects get
    # FRESH local RVs on the target and the source's RV history for the
    # cluster becomes unreachable — the floor bookkeeping makes stale
    # resumes answer a typed 410 instead of a silent partial resume.

    def fence_cluster(self, cluster: str) -> int:
        """Refuse further writes to one logical cluster and return the
        cutover RV: every write this store ever acked for the cluster
        has rv <= the returned value (the group-commit barrier flushes
        in-flight windows first, so the replication window and the WAL
        both already hold them). Idempotent."""
        self._race_guard.check()
        cut = self._cluster_fences.get(cluster)
        if cut is not None:
            return cut
        self._gc_barrier()
        self._flush_events()
        self._cluster_fences[cluster] = self._rv
        log.info("cluster %s fenced for migration at rv %d", cluster,
                 self._rv)
        return self._rv

    def unfence_cluster(self, cluster: str) -> None:
        """Roll back a cluster fence (an aborted migration)."""
        self._race_guard.check()
        self._cluster_fences.pop(cluster, None)

    def apply_migrated(self, rec: dict) -> int | None:
        """Apply one migrated record from a cluster moving ONTO this
        shard. Unlike :meth:`apply_replicated`, the source's RVs mean
        nothing here (independent counters): the object gets a fresh
        local RV and only ``metadata.resourceVersion`` is re-stamped —
        uid, creationTimestamp and every other byte survive the move.
        Watch events fan out (ADDED for the common post-fence snapshot
        case) so wildcard informers converge without a relist, and the
        record lands in the local WAL. Returns the local rv, or None
        for a no-op."""
        self._race_guard.check()
        self._check_writable()
        op = rec.get("op")
        if op == "epoch":
            return None
        key: Key = tuple(rec["key"])  # type: ignore[assignment]
        REGISTRY.counter(
            "migration_records_total",
            "migrated WAL records applied on a cluster's new owning "
            "shard").inc()
        if op == "put":
            obj = copy.deepcopy(rec["obj"])
            old = self._objects.get(key)
            rv = self._next_rv()
            obj.setdefault("metadata", {})["resourceVersion"] = str(rv)
            obj = self._put_obj(key, obj)
            self._emit(MODIFIED if old is not None else ADDED, key, obj,
                       rv, old=old)
            self._log_wal({"op": "put", "key": list(key), "obj": obj,
                           "rv": rv})
            return rv
        if op == "del":
            existing = self._objects.get(key)
            if existing is None:
                return None
            rv = self._next_rv()
            self._del_obj(key)
            self._emit(DELETED, key, existing, rv, old=existing)
            self._log_wal({"op": "del", "key": list(key), "rv": rv})
            return rv
        raise InvalidError(f"unknown migration record op {op!r}")

    def advance_rv(self, min_rv: int) -> None:
        """Jump the RV counter to at least ``min_rv`` (never rewinds).
        Used at migration finish so every RV this shard mints afterwards
        sorts AFTER every RV the source ever minted for the cluster."""
        self._race_guard.check()
        min_rv = int(min_rv)
        if min_rv > self._rv:
            self._rv = min_rv
            if self._engine is not None:
                self._engine.set_rv(self._rv)

    def finish_migration(self, cluster: str, source_rv: int) -> int:
        """Target-side cutover bookkeeping: advance past everything the
        source ever minted and record the cluster's RV floor — resumes
        below it carry source-minted RVs and answer a typed 410 (see
        :meth:`watch`). Returns the floor."""
        self._race_guard.check()
        self.advance_rv(int(source_rv) + 1)
        self._migration_floors[cluster] = self._rv
        return self._rv

    def purge_cluster(self, cluster: str) -> int:
        """Source-side teardown after the cluster's ownership flipped:
        deliver everything already emitted, end the cluster's watch
        streams through the eviction path (terminal typed 410 after
        their buffers drain — nothing committed pre-cutover is lost),
        then drop the cluster's objects WITHOUT watch events: the move
        is not a delete, observers re-attach to the new owner. The WAL
        del records (tagged ``mig``) keep restarts and WAL-fed replicas
        consistent and wildcard scatter-lists duplicate-free. Returns
        the number of objects purged."""
        self._race_guard.check()
        self._gc_barrier()
        self._flush_events()
        for w in list(self._watches):
            if w.cluster == cluster:
                w._evict()
        keys = [k for k in self._objects if k[1] == cluster]
        for key in keys:
            rv = self._next_rv()
            self._del_obj(key)
            self._log_wal({"op": "del", "key": list(key), "rv": rv,
                           "mig": 1})
        self._cluster_fences.pop(cluster, None)
        log.info("cluster %s purged after migration: %d objects", cluster,
                 len(keys))
        return len(keys)

    def reset_for_resync(self) -> None:
        """Drop all local state ahead of a full snapshot resync (the
        primary's retained ship window no longer covers our applied RV).
        Open watches close — their consumers re-list, exactly as after a
        410 — and the caller streams snapshot objects in via
        :meth:`load_snapshot_object` + :meth:`finish_resync`."""
        self._gc_barrier()
        self._flush_events()
        for w in list(self._watches):
            w.close()
        self._objects.clear()
        self._buckets.clear()
        self._history.clear()
        self._hist_events.clear()
        self._hist_rvs.clear()
        self._hist_start = 0
        self._pending.clear()
        self._enc_bytes.clear()
        self._span_cache.clear()
        self._bucket_ver.clear()
        self._rv = 0

    def load_snapshot_object(self, key, obj: dict) -> None:
        """Insert one snapshot object during a resync (no events, no RV
        bookkeeping — :meth:`finish_resync` sets the RV watermark)."""
        self._put_obj(tuple(key), obj)

    def finish_resync(self, rv: int) -> None:
        """Stamp the snapshot's RV watermark and compact local
        durability so a replica restart resumes from this point."""
        self._rv = max(self._rv, int(rv))
        if self._engine is not None:
            self._engine.set_rv(self._rv)
        if self._engine is not None or self._wal is not None:
            self.snapshot()

    def _apply_wal_record(self, rec: dict) -> None:
        """Replay one JSON WAL record into the in-memory state."""
        op = rec.get("op")
        if op == "epoch":
            self.epoch = max(self.epoch, int(rec["epoch"]))
            return
        key = tuple(rec["key"])
        if op == "put":
            self._put_obj(key, rec["obj"])
        elif op == "del":
            self._del_obj(key)
        else:
            raise ValueError(f"unknown WAL op {op!r}")
        self._rv = max(self._rv, int(rec.get("rv", 0)))

    def _load_wal(self) -> None:
        assert self._wal is not None
        snap = self._wal.path + ".snap"
        if os.path.exists(snap):
            with open(snap, encoding="utf-8") as f:
                data = json.load(f)
            self._rv = data["rv"]
            self.epoch = max(self.epoch, int(data.get("epoch", 0)))
            for rec in data["objects"]:
                self._put_obj(tuple(rec["key"]), rec["obj"])
        if not os.path.exists(self._wal.path):
            return
        with open(self._wal.path, "rb") as f:
            raw = f.read()
        # torn-tail recovery (the JSON twin of the native engine's CRC
        # replay): a crash mid-append leaves a partial (or garbled) final
        # record — replay stops at the first record that fails to parse
        # and the file is truncated to the last good one, instead of
        # failing the whole restore and wedging the server on boot.
        pos = 0
        end_good = 0
        while pos < len(raw):
            nl = raw.find(b"\n", pos)
            terminated = nl >= 0
            chunk = raw[pos:nl] if terminated else raw[pos:]
            nxt = nl + 1 if terminated else len(raw)
            if chunk.strip():
                try:
                    self._apply_wal_record(json.loads(chunk))
                except (ValueError, KeyError, TypeError) as e:
                    log.warning(
                        "WAL %s: torn/corrupt record at byte %d (%s); "
                        "truncating to last good record (%d bytes dropped)",
                        self._wal.path, pos, e, len(raw) - end_good)
                    REGISTRY.counter(
                        "wal_torn_tail_total",
                        "WAL restores that dropped a torn/corrupt tail"
                    ).inc()
                    os.truncate(self._wal.path, end_good)
                    return
            end_good = nxt
            pos = nxt

    def snapshot(self) -> None:
        """Write a snapshot and truncate the WAL (etcd compaction analog)."""
        self._gc_barrier()  # compaction must not strand buffered records
        if self._engine is not None:
            self._engine.snapshot_stream(
                (_wal_key(k), json.dumps(v, separators=(",", ":")).encode("utf-8"))
                for k, v in self._objects.items()
            )
            self._engine_mutations = 0
            return
        if self._wal is None:
            return
        snap = self._wal.path + ".snap"
        tmp = snap + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(
                {
                    "rv": self._rv,
                    "epoch": self.epoch,
                    "objects": [
                        {"key": list(k), "obj": v} for k, v in self._objects.items()
                    ],
                },
                f,
            )
        os.replace(tmp, snap)
        if self._wal.fh is not None:
            self._wal.fh.close()
        self._wal.fh = open(self._wal.path, "w", encoding="utf-8")
        self._wal.mutations_since_snapshot = 0

    def close(self) -> None:
        self._gc_barrier()  # an open window's records reach the WAL first
        self._flush_events()
        for w in list(self._watches):
            w.close()
        if self._engine is not None:
            self._engine.close()
            self._engine = None
        if self._wal is not None and self._wal.fh is not None:
            self._wal.fh.close()
            self._wal.fh = None

    # ----------------------------------------------------------- internal

    @staticmethod
    def _non_status_changed(a: Mapping, b: Mapping) -> bool:
        """True when anything outside .status and volatile metadata differs.

        The host-side twin of the device diff kernel's spec lane
        (reference behavior: pkg/syncer/specsyncer.go:17-41
        deepEqualApartFromStatus ignores status + mutable metadata).
        """

        def strip(o: Mapping) -> dict:
            o = {k: v for k, v in o.items() if k != "status"}
            meta = dict(o.get("metadata") or {})
            for f in ("resourceVersion", "generation", "managedFields", "creationTimestamp", "uid"):
                meta.pop(f, None)
            o["metadata"] = meta
            return o

        return strip(a) != strip(b)


def iter_keys(store: LogicalStore) -> Iterator[Key]:
    return iter(store._objects.keys())
