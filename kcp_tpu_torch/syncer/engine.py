"""BatchSyncEngine — the vectorized spec<->status sync loop (the port of
``kcp_tpu.syncer.engine``; its fused backend serves through the port's
:class:`~kcp_tpu_torch.syncer.core.FusedCore` on PyTorch tensors).

The reference runs two controllers per (cluster, resource-set): a spec
syncer (kcp -> physical, pkg/syncer/specsyncer.go) and a status syncer
(physical -> kcp, pkg/syncer/statussyncer.go), each deep-diffing objects
one goroutine at a time. Here both directions are lanes of ONE batched
device program per (cluster, GVR):

  informer deltas (both sides)
        -> host encode (hash tensors)            ops/encode.py
        -> device scatter into resident mirrors  ops/diff.apply_deltas
        -> device 3-way diff over ALL rows       ops/diff.sync_decisions
        -> non-NOOP rows home to host
        -> host verifies + applies patches with optimistic concurrency

The mirrors are *device-resident* in the fused backend: host numpy
copies are the staging/rebuild area, but steady-state ticks ship only the
padded delta batch to the device and scatter there (re-uploading a
100k-row mirror per tick would cost far more transfer than the kernel
takes).

Running the diff over the full resident mirror every tick makes the loop
level-triggered: a tick converges *everything* currently out of sync, not
just the keys that woke it. Two safety nets bound hash-collision damage:
every device decision is re-verified against the real objects before a
write (the host escape hatch), and a periodic informer resync replays the
caches (reference: resyncPeriod, pkg/syncer/syncer.go:27).

Decision application parity with the reference:
- CREATE/UPDATE downstream: strip volatile metadata + ownerReferences +
  status, ensure namespace, create-then-update-on-conflict
  (specsyncer.go:86-132)
- DELETE downstream on upstream deletion (specsyncer.go:79-84)
- status upsync upstream via the status subresource, stale-RV conflicts
  requeue (statussyncer.go:41-63)
"""

from __future__ import annotations

import asyncio
import copy
import logging
import os
import time
from typing import Sequence

import numpy as np

from .. import obs
from ..apis.scheme import GVR
from ..client import Client, Informer
from ..ops.diff import (
    DECISION_CREATE,
    DECISION_DELETE,
    DECISION_UPDATE,
)
from ..ops.encode import BucketEncoder, BucketOverflow, pad_pow2
from ..reconciler.controller import BatchController
from ..store.selectors import LabelSelector, parse_selector
from ..utils import errors

log = logging.getLogger(__name__)

CLUSTER_LABEL = "kcp.dev/cluster"
OWNED_BY_LABEL = "kcp.dev/owned-by"

DEFAULT_RESYNC_PERIOD = 600.0  # the collision/missed-event safety net

# metadata fields that must not cross the cluster boundary
# (reference: specsyncer.go:97-108 strips UID + ResourceVersion and drops
# owner references pointing at the kcp-side owner)
_STRIP_META = ("uid", "resourceVersion", "creationTimestamp", "generation",
               "managedFields", "clusterName", "ownerReferences", "deletionTimestamp")


def transform_for_downstream(obj: dict) -> dict:
    out = copy.deepcopy(obj)
    out.pop("status", None)
    meta = out.get("metadata") or {}
    for f in _STRIP_META:
        meta.pop(f, None)
    return out


def _sync_view(obj: dict) -> dict:
    """The canonical comparable view of an object on either side.

    Both mirrors encode this view, so side-local fields (uid, RV, owner
    refs) can never make the lanes dirty.
    """
    view = transform_for_downstream(obj)
    if "status" in obj:
        view["status"] = copy.deepcopy(obj["status"])
    return view


def _sync_view_ro(obj: dict) -> dict:
    """:func:`_sync_view` without the deepcopy tax, for read-only
    consumers (the encoders hash it, `_spec_differs` compares it). The
    nested values stay shared with the informer caches — which the CoW
    store shares with storage — so callers must not mutate the result;
    write paths keep using the deep-copying :func:`_sync_view` /
    :func:`transform_for_downstream`."""
    out = {k: v for k, v in obj.items() if k != "status"}
    meta = out.get("metadata") or {}
    out["metadata"] = {k: v for k, v in meta.items() if k not in _STRIP_META}
    if "status" in obj:
        out["status"] = obj["status"]
    return out


class BatchSyncEngine:
    """One batched sync program for one GVR between two clusters.

    ``backend="fused"`` (the reference's ``"tpu"``) registers a row
    section in the process-wide :class:`~kcp_tpu_torch.syncer.core.FusedCore`:
    every engine's rows live in a shared schema bucket and each reconcile
    tick runs ONE fused step over the whole fleet — the same program
    ``kcp_tpu_torch.bench`` measures. ``backend="host"`` computes
    identical decisions in pure Python per engine — the differential-
    testing reference (SURVEY.md §7.1). ``device=None`` puts the core the
    engine creates on the CUDA card; ``mesh=None`` means the process
    serving mesh (:func:`kcp_tpu_torch.parallel.mesh.set_serving_mesh`).

    Applies are pipelined: the tick never waits on a store write. Patches
    go to an applier pool that verifies against the live caches, applies
    with optimistic concurrency, and retries with per-key backoff
    (5 retries then drop, RetryableError forever — reference parity with
    pkg/syncer/syncer.go:272-291).
    """

    def __init__(
        self,
        upstream: Client,
        downstream: Client,
        gvr: GVR | str,
        cluster_id: str,
        backend: str = "fused",
        namespace_gvr: GVR | str = "namespaces",
        batch_window: float = 0.002,
        resync_period: float | None = DEFAULT_RESYNC_PERIOD,
        core=None,
        mesh=None,
        apply_workers: int = 4,
        max_apply_retries: int = 5,
        pipeline: str | None = None,
        device=None,
    ):
        self.upstream = upstream
        self.downstream = downstream
        self.gvr = gvr
        self.cluster_id = cluster_id
        self.backend = backend
        if backend not in ("fused", "host"):
            raise ValueError(f"backend must be 'fused' or 'host', got {backend!r}")
        self.fused = backend == "fused"
        self.core = core
        self.mesh = mesh  # sharding for the fused core (None = serving default)
        # tick pipelining for the fused core (None = KCP_PIPELINE env /
        # "double"); only consulted when this engine creates the core
        self.pipeline = pipeline
        self.device = device  # the core's device when this engine creates it
        self.namespace_gvr = namespace_gvr
        self.selector: LabelSelector = parse_selector(f"{CLUSTER_LABEL}={cluster_id}")

        self.up_informer = Informer(
            upstream, gvr, selector=self.selector, resync_period=resync_period
        )
        self.down_informer = Informer(
            downstream, gvr, selector=self.selector, resync_period=resync_period
        )

        self.enc = BucketEncoder(capacity=64)
        # encode-once memo for the _sync_view_ro encode path: the CoW
        # store (and the informer caches fed from it) never mutates a
        # snapshot in place, so the uint32 row for a snapshot is a pure
        # function of the dict — keyed by id with a strong ref (presence
        # implies identity), cleared whenever self.enc is replaced
        # (slot assignments are append-only below that, so cached rows
        # stay valid as the vocabulary grows). Periodic resyncs and
        # level-triggered re-touches of unchanged keys hit this instead
        # of re-flattening the object.
        self._enc_memo_on = os.environ.get(
            "KCP_ENCODE_CACHE", "1").lower() not in ("0", "false", "off")
        self._enc_memo: dict[int, tuple[dict, np.ndarray]] = {}
        self._enc_memo_max = 65536
        self.rows: dict[tuple[str, str], int] = {}  # (ns, name) -> row
        self.row_keys: list[tuple[str, str]] = []
        self.capacity = 0
        # host staging mirrors (host-backend state; fused mode stages into
        # the shared bucket instead)
        self.up_vals = self.up_exists = self.down_vals = self.down_exists = None

        self.controller = None
        self._section = None
        if not self.fused:
            self.controller = BatchController(
                f"sync-{cluster_id}-{gvr}", self._process_batch,
                batch_window=batch_window,
            )
        self.up_informer.add_handler(self._on_up_event)
        self.down_informer.add_handler(self._on_down_event)

        # pipelined applier pool
        self.apply_workers = apply_workers
        self.max_apply_retries = max_apply_retries
        self._apply_q: asyncio.Queue | None = None
        self._apply_pending: set = set()
        self._apply_failures: dict = {}  # key -> consecutive failure count
        self._apply_tasks: list[asyncio.Task] = []
        self._retry_tasks: set[asyncio.Task] = set()

        # convergence bookkeeping for the p99 metric: key -> first-dirty
        # time; samples are bounded (a long-running server must not grow
        # them forever — the histogram in utils/trace keeps the totals)
        from collections import deque

        self.dirty_since: dict[tuple[str, str], float] = {}
        self.convergence_samples: "deque[float]" = deque(maxlen=10_000)
        self.stats = {"ticks": 0, "decisions_applied": 0, "rows": 0, "full_uploads": 0}
        # convergence trace attribution (kcp_tpu/obs): key -> the traced
        # spec write's context + the phase-boundary timestamps gathered
        # as the row moves stage → tick → patch → downstream → upstatus.
        # Entries exist only for sampled writes (identity-linked
        # snapshots, or engine-minted fragments under always-on
        # sampling), bounded FIFO — the steady-state cost when tracing
        # is on but nothing is sampled is one dict-emptiness check.
        self._conv: dict[tuple[str, str], dict] = {}
        self._conv_max = 1024
        self._tick_bounds: tuple[float, float] | None = None

    def tick_count(self) -> int:
        """Reconcile ticks that covered this engine's rows (fused mode
        reports the shared bucket's tick counter)."""
        if self.fused and self._section is not None:
            return self._section.bucket.stats["ticks"]
        return self.stats["ticks"]

    # ------------------------------------------------------------ events

    @staticmethod
    def _obj_key(obj: dict) -> tuple[str, str]:
        m = obj["metadata"]
        return (m.get("namespace", ""), m["name"])

    def _on_up_event(self, etype: str, old: dict | None, new: dict | None) -> None:
        key = self._obj_key(new or old)
        self.dirty_since.setdefault(key, time.monotonic())
        self._apply_failures.pop(key, None)  # new data resets the budget
        if new is not None and obs.TRACER.enabled and key not in self._conv:
            ctx = obs.conv_begin(new)
            if ctx is not None:
                while len(self._conv) >= self._conv_max:
                    self._conv.pop(next(iter(self._conv)))
                meta = new.get("metadata") or {}
                self._conv[key] = {
                    "ctx": ctx, "state": "staged", "t0": time.time(),
                    "rv": str(meta.get("resourceVersion", "")),
                    "name": meta.get("name", "")}
        if self.fused:
            if self._section is not None:
                self.core.enqueue(self._section, False, key)
        else:
            self.controller.enqueue(("up", key))

    def _on_down_event(self, etype: str, old: dict | None, new: dict | None) -> None:
        key = self._obj_key(new or old)
        self._apply_failures.pop(key, None)
        if self._conv:
            # downstream churn (our own create echo, then the status
            # write) re-stages the row: remember the LAST arrival as the
            # downstream→upsync boundary (phases recorded at upsync)
            ent = self._conv.get(key)
            if ent is not None and ent["state"] in ("patched", "downstaged"):
                ent["t_down"] = time.time()
                ent["state"] = "downstaged"
        if self.fused:
            if self._section is not None:
                self.core.enqueue(self._section, True, key)
        else:
            self.controller.enqueue(("down", key))

    # ----------------------------------------------- fused-core interface

    def fused_status_mask(self) -> np.ndarray:
        return self.enc.status_mask()

    def fused_ledger_key(self) -> tuple[str, str]:
        """(cluster, resource) key for the fleet batch's device-side
        per-segment counters: the quota ledger's interning key
        (admission/quota.py ``ingest_device_counts``), so this engine's
        live synced rows are counted on-device every tick."""
        return (self._up_cluster(), str(self.gvr))

    def _encode_view(self, obj: dict) -> np.ndarray:
        """Encode-once ``enc.encode(_sync_view_ro(obj))``: memoized per
        snapshot identity. The returned row is shared — callers copy it
        into staging buffers, never mutate it."""
        if not self._enc_memo_on:
            return self.enc.encode(_sync_view_ro(obj))
        ent = self._enc_memo.get(id(obj))
        if ent is not None and ent[0] is obj:
            return ent[1]
        vec = self.enc.encode(_sync_view_ro(obj))
        if len(self._enc_memo) >= self._enc_memo_max:
            # blunt but bounded: informer caches churn snapshots, so a
            # periodic full reset beats per-entry tracking on this path
            self._enc_memo.clear()
        self._enc_memo[id(obj)] = (obj, vec)
        return vec

    def fused_encode(self, key: tuple[str, str]):
        """Re-encode one touched key from the informer caches for the
        shared bucket's scatter. Raises BucketOverflow if the vocabulary
        outgrew the bucket (the core then calls :meth:`fused_overflow`)."""
        ns, name = key
        up_obj = self.up_informer.get(self._up_cluster(), name, ns)
        down_obj = self.down_informer.get(self._down_cluster(), name, ns)
        s = self.enc.capacity
        up_v = (self._encode_view(up_obj) if up_obj is not None
                else np.zeros(s, np.uint32))
        down_v = (self._encode_view(down_obj) if down_obj is not None
                  else np.zeros(s, np.uint32))
        # converged-by-observation: both sides present and identical means
        # this key's churn has landed — close its convergence sample here
        # (actioned keys close theirs in the applier)
        if (up_obj is None) == (down_obj is None) and bool((up_v == down_v).all()):
            self._sample_convergence(key)
        return up_v, up_obj is not None, down_v, down_obj is not None

    def fused_apply(self, patches: list[tuple[tuple[str, str], int, bool]]) -> None:
        """Patch rows from a collected tick: feed the applier pool
        (dedup per key; the pool re-verifies against live caches)."""
        if self._conv and patches:
            # stamp which fused dispatch carried each traced row: the
            # core's wall-clock tick anchor + this collect time bound
            # the "tick" phase, and the bucket tick counter names it
            t1 = time.time()
            t0 = getattr(self.core, "last_tick_start", None) or t1
            tick_n = (self._section.bucket.stats.get("ticks")
                      if self._section is not None else None)
            for key, _code, _upsync in patches:
                ent = self._conv.get(key)
                if ent is not None and "tb" not in ent:
                    ent["tb"] = (t0, t1)
                    ent["tick"] = tick_n
        for key, code, upsync in patches:
            if key in self._apply_pending:
                continue
            if self._apply_failures.get(key, 0) > self.max_apply_retries:
                continue  # dropped until a new event resets the budget
            self._apply_pending.add(key)
            self._apply_q.put_nowait((key, code, upsync))

    def fused_overflow(self) -> None:
        """Vocabulary outgrew the bucket: grow the encoder (vocab is a
        prefix, so existing slot assignments stay valid), move to the
        larger bucket, and replay every cached key."""
        self.enc = self.enc.grown()
        self._enc_memo.clear()  # rows are sized to the replaced encoder
        log.info("sync-%s-%s: bucket overflow, re-registering at %d slots",
                 self.cluster_id, self.gvr, self.enc.capacity)
        old = self._section
        self._section = self.core.register(self, self.enc.capacity)
        if old is not None:
            old.release()
        self.core.enqueue_many(self._section, False, self._all_keys())

    def _all_keys(self) -> set:
        keys = {(k[1], k[2]) for k in self.up_informer.cache}
        keys |= {(k[1], k[2]) for k in self.down_informer.cache}
        return keys

    def _sample_convergence(self, key) -> None:
        started = self.dirty_since.pop(key, None)
        if started is not None:
            from ..utils.trace import REGISTRY

            dt = time.monotonic() - started
            self.convergence_samples.append(dt)
            REGISTRY.histogram("kcp_sync_convergence_seconds",
                               "spec churn to observed convergence").observe(dt)

    # ----------------------------------------------------- applier pool

    async def _apply_worker(self) -> None:
        while True:
            key, code, upsync = await self._apply_q.get()
            try:
                applied = await self._apply_async(key, code, upsync)
            except Exception as err:  # noqa: BLE001 — reconcile errors are data
                self._apply_failed(key, code, upsync, err)
            else:
                self._apply_failures.pop(key, None)
                if applied:
                    self.stats["decisions_applied"] += 1
            finally:
                # pending holds until the apply FINISHES: a slow apply
                # must suppress the level-triggered re-patches every tick
                # emits for its still-divergent row, or duplicates of one
                # slow key eat the whole worker pool. Anything that
                # changed mid-apply is recovered by the next tick — the
                # row is still divergent, pending is clear, it re-patches
                self._apply_pending.discard(key)
                self._apply_q.task_done()

    async def _apply_async(self, key, code: int, upsync: bool) -> bool:
        """Apply one verified decision. Override (or monkeypatch) to make
        applies genuinely asynchronous (e.g. thread-pooled REST calls) —
        the tick loop never waits on this. ``syncer.apply`` is a
        KCP_FAULTS injection point (error -> the worker's normal
        failure/backoff path; latency -> an awaited delay, so a slow
        apply exercises the pending-dedup discipline, never the tick)."""
        from .. import faults

        delay = faults.maybe_fail("syncer.apply")
        if delay:
            await asyncio.sleep(delay)
        return self._apply_decision(key, code, upsync)

    def _apply_failed(self, key, code: int, upsync: bool, err: Exception) -> None:
        n = self._apply_failures.get(key, 0) + 1
        self._apply_failures[key] = n  # backoff escalates for every failure
        retryable = errors.is_retryable(err)
        if not retryable and n > self.max_apply_retries:
            log.warning("sync-%s-%s: dropping %r after %d apply retries: %s",
                        self.cluster_id, self.gvr, key, n - 1, err)
            return
        delay = min(0.005 * (2 ** min(n, 10)), 5.0)
        hint = errors.retry_after_hint(err)
        if hint is not None:
            # 429 from an overloaded frontend: honor the server's pacing
            # hint (jittered so the applier pool doesn't re-arrive in
            # lockstep, capped so a bogus hint can't stall the row)
            import random

            delay = max(delay, min(hint, 30.0) * (1.0 + 0.25 * random.random()))
        log.info("sync-%s-%s: apply %r failed (attempt %d): %s",
                 self.cluster_id, self.gvr, key, n, err)
        t = asyncio.get_event_loop().create_task(
            self._retry_apply(key, code, upsync, delay))
        self._retry_tasks.add(t)
        t.add_done_callback(self._retry_tasks.discard)

    async def _retry_apply(self, key, code: int, upsync: bool, delay: float) -> None:
        await asyncio.sleep(delay)
        if key not in self._apply_pending:
            self._apply_pending.add(key)
            self._apply_q.put_nowait((key, code, upsync))

    # ------------------------------------------------------------- rows

    def _ensure_capacity(self, needed: int) -> None:
        if self.capacity >= needed and self.up_vals is not None:
            return
        new_cap = pad_pow2(max(needed, 8))
        s = self.enc.capacity

        def grow(a, shape, dtype):
            out = np.zeros(shape, dtype=dtype)
            if a is not None:
                src = np.asarray(a)
                out[: src.shape[0], ...] = src
            return out

        self.up_vals = grow(self.up_vals, (new_cap, s), np.uint32)
        self.down_vals = grow(self.down_vals, (new_cap, s), np.uint32)
        self.up_exists = grow(self.up_exists, (new_cap,), bool)
        self.down_exists = grow(self.down_exists, (new_cap,), bool)
        self.capacity = new_cap

    def _row_for(self, key: tuple[str, str]) -> int:
        row = self.rows.get(key)
        if row is None:
            row = len(self.row_keys)
            self.rows[key] = row
            self.row_keys.append(key)
            self._ensure_capacity(row + 1)
        return row

    def _rebuild_after_overflow(self) -> None:
        """Encoder outgrew its slots: grow until everything fits, then
        re-encode both caches (the host escape hatch for odd objects)."""
        while True:
            self.enc = self.enc.grown()
            self._enc_memo.clear()  # rows are sized to the replaced encoder
            log.info("%s: bucket overflow, re-encoding at %d slots",
                     self.controller.name, self.enc.capacity)
            cap = self.capacity
            s = self.enc.capacity
            self.up_vals = np.zeros((cap, s), np.uint32)
            self.down_vals = np.zeros((cap, s), np.uint32)
            self.up_exists = np.zeros(cap, bool)
            self.down_exists = np.zeros(cap, bool)
            try:
                for (_cl, ns, name), obj in self.up_informer.cache.items():
                    r = self._row_for((ns, name))
                    self.enc.encode(_sync_view_ro(obj), out=self.up_vals[r])
                    self.up_exists[r] = True
                for (_cl, ns, name), obj in self.down_informer.cache.items():
                    r = self._row_for((ns, name))
                    self.enc.encode(_sync_view_ro(obj), out=self.down_vals[r])
                    self.down_exists[r] = True
                break
            except BucketOverflow:
                continue

    # -------------------------------------------------------------- tick

    async def _process_batch(self, items: Sequence) -> list[tuple[object, Exception]]:
        from ..utils.trace import span

        with span("kcp_sync_tick"):
            return await self._process_batch_timed(items)

    async def _process_batch_timed(self, items: Sequence) -> list[tuple[object, Exception]]:
        from ..utils.trace import REGISTRY

        self.stats["ticks"] += 1
        t_tick0 = time.time()
        REGISTRY.counter("kcp_sync_ticks_total",
                         "reconcile ticks across all sync sessions").inc()
        REGISTRY.counter("kcp_sync_events_total",
                         "informer events drained into tick batches").inc(len(items))
        # 1. dedup keys touched this tick (last event wins — we re-read
        #    caches), remembering which queue items map to each key so
        #    failures are charged to the right items' retry budgets
        key_items: dict[tuple[str, str], list] = {}
        for item in items:
            key_items.setdefault(item[1], []).append(item)

        # 2. re-encode touched keys from the informer caches
        try:
            deltas = self._apply_touched(key_items.keys())
        except BucketOverflow:
            self._rebuild_after_overflow()
            deltas = None

        # 3. full-mirror diff (pure-host reference backend; the fused
        #    backend runs through the FusedCore, not this path)
        del deltas
        n = len(self.row_keys)
        if n == 0:
            return []
        decision, upsync = self._host_decisions()
        # wall-clock tick bounds for convergence attribution (the host
        # backend's analog of the fused core's last_tick_start)
        self._tick_bounds = (t_tick0, time.time())

        # 4. apply non-NOOP rows with host verification
        failed_keys: dict[tuple[str, str], Exception] = {}
        act_rows = np.nonzero((decision != 0) | upsync)[0]
        for r in act_rows:
            if r >= n:
                continue
            key = self.row_keys[r]
            try:
                applied = self._apply_decision(key, int(decision[r]), bool(upsync[r]))
                if applied:
                    self.stats["decisions_applied"] += 1
            except Exception as err:  # noqa: BLE001 — reconcile errors are data
                failed_keys[key] = err

        # touched keys that needed no action converged by observation
        act_set = {self.row_keys[r] for r in act_rows if r < n}
        now = time.monotonic()
        conv_h = REGISTRY.histogram("kcp_sync_convergence_seconds",
                                    "spec churn to observed convergence")
        for key in key_items:
            if key not in act_set:
                started = self.dirty_since.pop(key, None)
                if started is not None:
                    self.convergence_samples.append(now - started)
                    conv_h.observe(now - started)
        self.stats["rows"] = n

        # failures on rows whose items are in this batch charge those
        # items; failed rows woken by *earlier* batches already have a
        # backing-off item in the queue and will be retried by it
        failed: list[tuple[object, Exception]] = []
        for key, err in failed_keys.items():
            for item in key_items.get(key, ()):
                failed.append((item, err))
        return failed

    def _apply_touched(self, keys):
        """Refresh host mirrors for the touched keys; return the delta batch
        (idx, up_rows, up_ex, down_rows, down_ex) for the device scatter."""
        idxs, up_rows, up_ex, down_rows, down_ex = [], [], [], [], []
        for key in keys:
            r = self._row_for(key)
            ns, name = key
            up_obj = self.up_informer.get(self._up_cluster(), name, ns)
            down_obj = self.down_informer.get(self._down_cluster(), name, ns)
            idxs.append(r)
            up_rows.append(
                self._encode_view(up_obj) if up_obj is not None
                else np.zeros(self.enc.capacity, np.uint32)
            )
            up_ex.append(up_obj is not None)
            down_rows.append(
                self._encode_view(down_obj) if down_obj is not None
                else np.zeros(self.enc.capacity, np.uint32)
            )
            down_ex.append(down_obj is not None)
        if not idxs:
            return None
        for i, r in enumerate(idxs):
            self.up_vals[r] = up_rows[i]
            self.up_exists[r] = up_ex[i]
            self.down_vals[r] = down_rows[i]
            self.down_exists[r] = down_ex[i]
        return (
            np.array(idxs, np.int32),
            np.stack(up_rows),
            np.array(up_ex, bool),
            np.stack(down_rows),
            np.array(down_ex, bool),
        )

    # ---------------------------------------------------------- backends

    def _host_decisions(self) -> tuple[np.ndarray, np.ndarray]:
        """Pure-python decision oracle (Backend=host)."""
        n = self.capacity
        decision = np.zeros(n, np.uint8)
        upsync = np.zeros(n, bool)
        status_mask = self.enc.status_mask()
        for r in range(len(self.row_keys)):
            ue, de = self.up_exists[r], self.down_exists[r]
            neq = self.up_vals[r] != self.down_vals[r]
            spec_dirty = bool((neq & ~status_mask).any())
            status_dirty = bool((neq & status_mask).any())
            if ue and not de:
                decision[r] = DECISION_CREATE
            elif de and not ue:
                decision[r] = DECISION_DELETE
            elif ue and de and spec_dirty:
                decision[r] = DECISION_UPDATE
            upsync[r] = ue and de and status_dirty
        return decision, upsync

    def _up_cluster(self) -> str:
        return self.up_informer.client.cluster

    def _down_cluster(self) -> str:
        return self.down_informer.client.cluster

    # ------------------------------------------------------------- apply

    def _conv_phases_pre(self, ent: dict) -> None:
        """Record the stage + tick phases of a traced row the first time
        an actionable decision reaches the applier: staged→tick-start is
        queue wait, tick-start→tick-end is the dispatch that carried the
        row (fused: the core's wall anchor; host: the batch bounds)."""
        tb = ent.get("tb") or self._tick_bounds or (ent["t0"], ent["t0"])
        t0 = max(ent["t0"], min(tb[0], tb[1]))
        ctx = ent["ctx"]
        obs.phase("stage", ctx, ent["t0"], t0, rv=ent["rv"],
                  obj=ent["name"])
        obs.phase("tick", ctx, t0, max(t0, tb[1]), rv=ent["rv"],
                  tick=ent.get("tick"))
        ent["state"] = "ticked"
        ent["t_tick1"] = max(t0, tb[1])

    def _apply_decision(self, key: tuple[str, str], decision: int, upsync: bool) -> bool:
        ns, name = key
        up_obj = self.up_informer.get(self._up_cluster(), name, ns)
        down_obj = self.down_informer.get(self._down_cluster(), name, ns)
        applied = False
        ent = self._conv.get(key) if self._conv else None
        if ent is not None and ent["state"] == "staged" and decision:
            self._conv_phases_pre(ent)

        if decision == DECISION_CREATE and up_obj is not None:
            self._ensure_namespace(ns)
            desired = transform_for_downstream(up_obj)
            try:
                self.downstream.create(self.gvr, desired, namespace=ns)
                applied = True
            except errors.AlreadyExistsError:
                # informer lag: fall through to update semantics
                current = self.downstream.get(self.gvr, name, ns)
                if self._spec_differs(desired, current):
                    merged = self._merged_downstream(desired, current)
                    self.downstream.update(self.gvr, merged, namespace=ns)
                    applied = True
        elif decision == DECISION_UPDATE and up_obj is not None and down_obj is not None:
            desired = transform_for_downstream(up_obj)
            # host verification: never trust a hash alone before writing
            if self._spec_differs(desired, down_obj):
                current = self.downstream.get(self.gvr, name, ns)
                merged = self._merged_downstream(desired, current)
                self.downstream.update(self.gvr, merged, namespace=ns)
                applied = True
        elif decision == DECISION_DELETE and down_obj is not None and up_obj is None:
            # the up_obj re-check re-derives the action at apply time: a
            # pipelined DELETE must not fire if the object reappeared
            # upstream while the patch was in flight
            try:
                self.downstream.delete(self.gvr, name, ns)
                applied = True
            except errors.NotFoundError:
                pass

        if ent is not None and ent["state"] == "ticked":
            # the downstream write (or delete) for this traced row just
            # applied: tick-end → now is the patch phase
            now = time.time()
            obs.phase("patch", ent["ctx"], ent["t_tick1"], now,
                      rv=ent["rv"], applied=applied)
            ent["state"] = "patched"
            ent["t_patch"] = now

        if upsync and up_obj is not None and down_obj is not None:
            new_status = down_obj.get("status")
            if new_status != up_obj.get("status"):
                fresh = self.upstream.get(self.gvr, name, ns)
                fresh["status"] = copy.deepcopy(new_status)
                with obs.use(ent["ctx"] if ent is not None else None):
                    # upstream status write runs under the row's trace
                    # context: an in-process upstream records its
                    # store.commit as a child; a REST upstream carries
                    # the traceparent to the owning shard
                    self.upstream.update_status(self.gvr, fresh,
                                                namespace=ns)
                applied = True
                if ent is not None and ent["state"] in ("patched",
                                                        "downstaged"):
                    now = time.time()
                    t_patch = ent.get("t_patch", ent["t0"])
                    t_down = ent.get("t_down", t_patch)
                    obs.phase("downstream", ent["ctx"], t_patch, t_down,
                              rv=ent["rv"])
                    obs.phase("upstatus", ent["ctx"], t_down, now,
                              rv=ent["rv"], obj=ent["name"])
                    self._conv.pop(key, None)

        if applied or decision or upsync:
            started = self.dirty_since.pop(key, None)
            if started is not None:
                self.convergence_samples.append(time.monotonic() - started)
        return applied

    def _ensure_namespace(self, ns: str) -> None:
        if not ns:
            return
        try:
            self.downstream.get(self.namespace_gvr, ns)
        except errors.NotFoundError:
            try:
                self.downstream.create(
                    self.namespace_gvr,
                    {"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": ns}},
                )
            except errors.AlreadyExistsError:
                pass

    @staticmethod
    def _spec_differs(desired: dict, current: dict) -> bool:
        # pure comparison: the copy-free views suffice (and with informer
        # caches sharing CoW store snapshots, skipping the deepcopy here
        # keeps host verification off the per-patch allocation budget)
        return _sync_view_ro(desired) != {
            k: v for k, v in _sync_view_ro(current).items() if k != "status"
        }

    @staticmethod
    def _merged_downstream(desired: dict, current: dict) -> dict:
        merged = copy.deepcopy(desired)
        merged.setdefault("metadata", {})["resourceVersion"] = current["metadata"][
            "resourceVersion"
        ]
        return merged

    # ---------------------------------------------------------- lifecycle

    async def start(self) -> None:
        self._apply_q = asyncio.Queue()
        for _ in range(self.apply_workers):
            self._apply_tasks.append(asyncio.create_task(self._apply_worker()))
        if self.fused:
            if self.core is None:
                from .core import FusedCore

                self.core = FusedCore.for_current_loop(
                    mesh=self.mesh, pipeline=self.pipeline, device=self.device)
            self._section = self.core.register(self, self.enc.capacity)
            await self.core.start()
        # informers after the section exists: their initial list replays
        # the cache through the handlers, which enqueue into the core
        await self.up_informer.start()
        await self.down_informer.start()
        if self.controller is not None:
            await self.controller.start()

    async def stop(self) -> None:
        if self.controller is not None:
            await self.controller.stop()
        if self.fused and self.core is not None:
            await self.core.stop()
            if self._section is not None:
                self._section.release()
                self._section = None
        # the core's shutdown drain may have enqueued final patches —
        # let the workers finish them before cancelling
        if self._apply_q is not None:
            try:
                await asyncio.wait_for(self._apply_q.join(), timeout=5.0)
            except asyncio.TimeoutError:
                log.warning("sync-%s-%s: applier queue not drained at stop",
                            self.cluster_id, self.gvr)
        for t in [*self._apply_tasks, *self._retry_tasks]:
            t.cancel()
        for t in [*self._apply_tasks, *self._retry_tasks]:
            try:
                await t
            except asyncio.CancelledError:
                pass
        self._apply_tasks.clear()
        self._retry_tasks.clear()
        await self.up_informer.stop()
        await self.down_informer.stop()
