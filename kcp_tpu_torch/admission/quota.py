"""Vectorized quota ledgers: per-(cluster, resource) object-count budgets.

The reference carves per-workspace policy/quota out as its own subsystem
(docs/investigations/self-service-policy.md); Kubernetes enforces it with
the ResourceQuota admission plugin — reserve against the quota *before*
the storage write, commit after, so concurrent writers can never
oversubscribe a hard limit. This module is that protocol built the way
this repo builds everything: usage, in-flight reservations and hard
limits are **numpy arrays over interned (cluster, resource) ids** (the
same interning trick as the store's vectorized watch fan-out), so the
recount/repair pass and the exported gauges are single vector ops over
10k tenants instead of a python dict walk.

Three cooperating pieces:

- :class:`QuotaLedger` — the arrays plus the reserve → commit/rollback
  protocol. *Usage* is advanced by a store mutation hook
  (``LogicalStore.set_usage_hook``): the store's object map is the source
  of truth, so writes that bypass the REST surface (in-process
  controllers, WAL restore) are counted too. *Reservations* only live
  across one admission→write window and guarantee
  ``usage + reserved <= hard`` at reserve time.
- :class:`QuotaPlugin` — the admission-chain plugin: reserves one object
  on every create; denial is a Kubernetes-style 403
  (:class:`~kcp_tpu_torch.utils.errors.ForbiddenError`). ``admission.quota``
  is a KCP_FAULTS injection point fired *after* the reservation is
  booked, so injected failures exercise the rollback discipline.
- :class:`UsageRecountController` — registered like the existing
  reconcilers: watches ``resourcequotas`` to apply limit changes and
  periodically recounts usage from the store's secondary index (cheap:
  bucket lengths, no object walk) to repair any drift from deletes,
  crashes or out-of-band mutation.

Limits come from ``ResourceQuota``-style objects living in the store::

    {"apiVersion": "v1", "kind": "ResourceQuota",
     "metadata": {"name": "budget", "namespace": "default"},
     "spec": {"hard": {"count/configmaps": 100, "secrets": 10}}}

``spec.hard`` keys are ``count/<resource>`` (bare resource names are
normalized to that form by the defaulting plugin); several quota objects
in one cluster combine by minimum. Scope here is the logical cluster,
not the namespace — the ledger is keyed (cluster, resource).
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time

import numpy as np

from ..analysis.sanitize import make_lock
from ..faults import maybe_fail
from ..utils.errors import ForbiddenError
from ..utils.trace import REGISTRY

log = logging.getLogger(__name__)

QUOTA_RESOURCE = "resourcequotas"
UNLIMITED = -1


def normalize_hard(hard: dict) -> dict[str, int]:
    """Canonical ``{resource: count}`` form of a ``spec.hard`` mapping:
    ``count/<resource>`` prefixes stripped, values coerced to int.
    Raises ValueError on non-integer or negative values."""
    out: dict[str, int] = {}
    for key, val in (hard or {}).items():
        res = key[len("count/"):] if key.startswith("count/") else key
        n = int(val)
        if n < 0:
            raise ValueError(f"quota for {key!r} is negative ({n})")
        # several keys can normalize to one resource; minimum wins
        out[res] = min(out.get(res, n), n)
    return out


class Reservation:
    """One in-flight admission reservation; commit or rollback exactly
    once (idempotent — the second call is a no-op)."""

    __slots__ = ("_ledger", "_idx", "_delta", "_done")

    def __init__(self, ledger: "QuotaLedger", idx: int, delta: int):
        self._ledger = ledger
        self._idx = idx
        self._delta = delta
        self._done = False

    def commit(self) -> None:
        """The write landed: usage was advanced by the store hook, so the
        reservation simply retires."""
        self._settle(rollback=False)

    def rollback(self) -> None:
        """The write failed (or admission aborted after reserving): free
        the reserved headroom."""
        self._settle(rollback=True)

    def _settle(self, rollback: bool) -> None:
        if self._done:
            return
        self._done = True
        self._ledger._release(self._idx, self._delta, rollback)


def settle_batch(reservations, rollback: bool = False) -> None:
    """Settle one commit window's reservations with ONE ledger lock
    acquisition per ledger — the group-commit form of
    :meth:`Reservation.commit` / :meth:`Reservation.rollback`. Already-
    settled (or None) entries are skipped, matching the per-reservation
    idempotence."""
    by_ledger: dict[int, tuple["QuotaLedger", list[tuple[int, int]]]] = {}
    for r in reservations:
        if r is None or r._done:
            continue
        r._done = True
        ent = by_ledger.get(id(r._ledger))
        if ent is None:
            ent = by_ledger[id(r._ledger)] = (r._ledger, [])
        ent[1].append((r._idx, r._delta))
    for ledger, items in by_ledger.values():
        ledger._release_batch(items, rollback)


class QuotaLedger:
    """Vectorized (cluster, resource) usage/limit ledger.

    Thread-safe: admission can reserve from executor threads while the
    recount controller repairs on the serving loop. All hot-path work is
    O(1) — one lock, one interned id, a few scalar array ops."""

    def __init__(self, cap: int = 64):
        self._lock = make_lock("quota.ledger")
        self._idx: dict[tuple[str, str], int] = {}  # (cluster, resource)->i
        self._keys: list[tuple[str, str]] = []
        # usage + hard limits: the vectorized state (recount and gauge
        # export are single vector ops). Reservations are transient
        # near-always-zero scalars, so they stay a plain list — python
        # int ops beat numpy scalar dispatch ~5x on the admit hot path.
        self._usage = np.zeros(cap, np.int64)
        self._reserved: list[int] = [0] * cap
        self._hard = np.full(cap, UNLIMITED, np.int64)
        # clusters currently holding any hard limit — the set the limit
        # resync has to revisit when quota objects disappear
        self._limited_clusters: set[str] = set()
        self._store = None
        # device-side usage lane: per-key live-row counts computed by
        # the fused fleet batch's per-segment counters (FusedCore
        # forwards them on every collect) — admission accounting riding
        # the device batch instead of a host-side pass
        self._device_counts: dict[int, int] = {}
        self._device_stamp = float("-inf")

    # ---------------------------------------------------------- interning

    def _slot(self, cluster: str, resource: str) -> int:
        """Interned id for (cluster, resource); caller holds the lock."""
        i = self._idx.get((cluster, resource))
        if i is None:
            i = len(self._keys)
            if i >= self._usage.size:
                grow = self._usage.size * 2
                self._usage = np.resize(self._usage, grow)
                self._reserved.extend([0] * (grow - len(self._reserved)))
                hard = np.full(grow, UNLIMITED, np.int64)
                hard[:i] = self._hard[:i]
                self._hard = hard
                self._usage[i:] = 0
            self._usage[i] = 0
            self._reserved[i] = 0
            self._hard[i] = UNLIMITED
            self._idx[(cluster, resource)] = i
            self._keys.append((cluster, resource))
        return i

    # ---------------------------------------------------------- protocol

    def reserve(self, cluster: str, resource: str,
                delta: int = 1) -> Reservation | None:
        """Book headroom for ``delta`` objects or raise 403 Forbidden.

        The oversubscription guard: ``usage + reserved + delta`` must fit
        under the hard limit *including every other writer's in-flight
        reservation*, so N concurrent creates against the last free slot
        admit exactly one.

        Unlimited keys return None — there is nothing to oversubscribe,
        the usage hook still counts, and the admit hot path skips the
        Reservation allocation and the commit round-trip entirely (a
        limit set mid-flight binds from the next reserve, the same
        eventual consistency its source ResourceQuota object has)."""
        with self._lock:
            i = self._slot(cluster, resource)
            # .item(): ~4x cheaper than `arr[i] += d` ufunc dispatch —
            # this runs on every admitted create
            hard = self._hard.item(i)
            if hard == UNLIMITED:
                return None
            if delta > 0:
                used = self._usage.item(i) + self._reserved[i]
                if used + delta > hard:
                    REGISTRY.counter(
                        "quota_denied_total",
                        "writes denied by the quota admission plugin").inc()
                    raise ForbiddenError(
                        f'exceeded quota in cluster "{cluster}": requested '
                        f"{delta} {resource}, used {used}, limited {hard}")
            self._reserved[i] += delta
        return Reservation(self, i, delta)

    def _release(self, i: int, delta: int, rollback: bool) -> None:
        with self._lock:
            self._reserved[i] -= delta
        if rollback:
            REGISTRY.counter(
                "quota_rollback_total",
                "quota reservations rolled back (failed writes)").inc()

    def _release_batch(self, items: list[tuple[int, int]],
                       rollback: bool) -> None:
        """One commit window's reservation releases under one lock
        acquisition (:func:`settle_batch`)."""
        with self._lock:
            for i, delta in items:
                self._reserved[i] -= delta
        if rollback and items:
            REGISTRY.counter(
                "quota_rollback_total",
                "quota reservations rolled back (failed writes)").inc(
                len(items))
        REGISTRY.counter(
            "quota_window_settled_total",
            "quota reservations settled by a batched per-commit-window "
            "ledger pass instead of one lock round trip per write").inc(
            len(items))

    # -------------------------------------------------------- usage hook

    def record(self, resource: str, cluster: str, delta: int) -> None:
        """Store mutation hook: the object map changed by ``delta``
        (+1 insert, -1 remove). Signature matches
        ``LogicalStore.set_usage_hook``."""
        with self._lock:
            i = self._slot(cluster, resource)
            used = self._usage.item(i) + delta
            self._usage[i] = used
            if used < 0:
                # must be impossible (the store only removes what exists);
                # counted rather than clamped so tests can assert on it
                REGISTRY.counter(
                    "quota_ledger_negative_total",
                    "ledger usage observed below zero (accounting bug)").inc()

    # ------------------------------------------------------------ limits

    def set_hard(self, cluster: str, resource: str, limit: int) -> None:
        with self._lock:
            self._hard[self._slot(cluster, resource)] = limit
        if limit != UNLIMITED:
            self._limited_clusters.add(cluster)

    def resync_limits(self, store, cluster: str) -> None:
        """Re-derive ``cluster``'s hard limits from its live ResourceQuota
        objects (minimum across objects; resources no longer mentioned go
        unlimited). Runs on the store's loop thread."""
        desired: dict[str, int] = {}
        bucket = store._buckets.get(QUOTA_RESOURCE, {}).get(cluster, {})
        for ns_objs in bucket.values():
            for obj in ns_objs.values():
                try:
                    hard = normalize_hard((obj.get("spec") or {}).get("hard"))
                except (ValueError, TypeError, AttributeError):
                    continue  # validation rejects these on the REST path
                for res, n in hard.items():
                    desired[res] = min(desired.get(res, n), n)
        with self._lock:
            for (c, res), i in self._idx.items():
                if c == cluster:
                    self._hard[i] = desired.pop(res, UNLIMITED)
            for res, n in desired.items():
                self._hard[self._slot(cluster, res)] = n
            limited = any(self._hard[i] != UNLIMITED
                          for (c, _r), i in self._idx.items() if c == cluster)
        if limited:
            self._limited_clusters.add(cluster)
        else:
            self._limited_clusters.discard(cluster)
        self._export_gauges()

    def resync_all_limits(self, store) -> None:
        clusters = set(store._buckets.get(QUOTA_RESOURCE, {}))
        for cluster in clusters | set(self._limited_clusters):
            self.resync_limits(store, cluster)

    # ----------------------------------------------- device-count lane

    def ingest_device_counts(self, counts: dict[tuple[str, str], int]) -> None:
        """Fold the fleet batch's device-side per-segment counters into
        the ledger's device-usage lane.

        ``counts`` maps (cluster, resource) to the number of live synced
        rows the fused step counted for that key THIS tick — computed on
        device as a segment-sum riding the same batch as the reconcile
        decisions, so it costs the serving path nothing. The lane feeds
        (1) the ``quota_usage_device`` gauge, (2) drift detection
        (``quota_device_drift_total`` counts keys where the device lane
        and the ledger disagree — a synced-but-miscounted tenant), and
        (3) the recount controller's fast path: when every limited key
        has a fresh, agreeing device count, the periodic host-side
        recount walk is skipped. The store-derived host recount remains
        the repair authority — a section's device count equals the store
        count exactly when every object of the resource is labeled for
        sync, and any disagreement falls back to the host pass."""
        now = time.monotonic()
        drift = 0
        with self._lock:
            for key, n in counts.items():
                i = self._slot(*key)
                self._device_counts[i] = int(n)
                if self._usage.item(i) != n:
                    drift += 1
            self._device_stamp = now
        REGISTRY.gauge(
            "quota_usage_device",
            "live synced rows counted on-device by the fleet batch's "
            "per-segment counters").set(sum(counts.values()))
        if drift:
            REGISTRY.counter(
                "quota_device_drift_total",
                "device-counted keys disagreeing with ledger usage").inc(
                drift)

    def device_usage_of(self, cluster: str, resource: str) -> int | None:
        """The device-lane count for a key (None = never reported)."""
        with self._lock:
            i = self._idx.get((cluster, resource))
            return self._device_counts.get(i) if i is not None else None

    def device_counts_agree(self, max_age: float) -> bool:
        """True when every limited key has a device-lane count no older
        than ``max_age`` seconds that equals ledger usage — the recount
        controller's evidence that accounting is riding the fleet batch
        and the host-side recount walk can be skipped this cycle."""
        with self._lock:
            if time.monotonic() - self._device_stamp > max_age:
                return False
            limited = [i for i in range(len(self._keys))
                       if self._hard[i] != UNLIMITED]
            if not limited:
                return False
            for i in limited:
                dc = self._device_counts.get(i)
                if dc is None or dc != self._usage.item(i):
                    return False
        return True

    # ----------------------------------------------------------- repair

    def recount(self, store) -> int:
        """Set usage to the store's true per-bucket counts; returns how
        many keys drifted (0 in a healthy system). One vector compare
        over the whole ledger. Runs on the store's loop thread."""
        desired = {(c, r): n for (r, c), n in store.counts().items()}
        with self._lock:
            n = len(self._keys)
            for key in desired:
                if key not in self._idx:
                    self._slot(*key)
            n = len(self._keys)
            want = np.fromiter(
                (desired.get(k, 0) for k in self._keys), np.int64, n)
            drift = int((self._usage[:n] != want).sum())
            if drift:
                REGISTRY.counter(
                    "quota_recount_repairs_total",
                    "ledger entries repaired by the usage recount").inc(drift)
                log.warning("quota recount repaired %d drifted entries", drift)
                self._usage[:n] = want
        self._export_gauges()
        return drift

    def attach(self, store) -> None:
        """Wire this ledger to a LogicalStore: usage hook on every
        mutation, then a recount + limit resync so a WAL-restored store
        starts with correct usage and live limits."""
        self._store = store
        store.set_usage_hook(self.record)
        self.recount(store)
        self.resync_all_limits(store)

    # ------------------------------------------------------ introspection

    def peek(self, cluster: str, resource: str) -> tuple[int, int, int]:
        """(usage, reserved, hard) — test/debug accessor."""
        with self._lock:
            i = self._idx.get((cluster, resource))
            if i is None:
                return (0, 0, UNLIMITED)
            return (int(self._usage[i]), int(self._reserved[i]),
                    int(self._hard[i]))

    def usage_of(self, cluster: str, resource: str) -> int:
        return self.peek(cluster, resource)[0]

    def snapshot(self) -> dict[tuple[str, str], tuple[int, int, int]]:
        with self._lock:
            n = len(self._keys)
            return {k: (int(self._usage[i]), int(self._reserved[i]),
                        int(self._hard[i]))
                    for i, k in enumerate(self._keys[:n])}

    def _export_gauges(self) -> None:
        """`quota_usage`: total usage across *limited* keys (per-key
        gauges stay bounded by the operator-created quota objects, not by
        tenant count)."""
        with self._lock:
            n = len(self._keys)
            limited = self._hard[:n] != UNLIMITED
            total = int(self._usage[:n][limited].sum())
        REGISTRY.gauge(
            "quota_usage",
            "objects counted against a hard quota limit").set(total)
        REGISTRY.gauge(
            "quota_limited_keys",
            "(cluster, resource) pairs holding a hard limit").set(
            int(limited.sum()))


class QuotaPlugin:
    """Admission plugin: reserve one object per create against the
    ledger. ``admission.quota`` faults fire after the reservation so
    injected errors exercise rollback."""

    name = "quota"
    verbs = frozenset({"create"})
    resources = None  # every resource is countable

    def __init__(self, ledger: QuotaLedger):
        self.ledger = ledger

    def admit(self, verb: str, resource: str, cluster: str,
              namespace: str, obj: dict | None) -> Reservation | None:
        res = self.ledger.reserve(cluster, resource, 1)
        try:
            maybe_fail("admission.quota")
        except BaseException:
            if res is not None:
                res.rollback()
            raise
        return res


class UsageRecountController:
    """The drift-repair reconciler, registered like the other in-process
    controllers (server.py post-start hook): a resourcequotas informer
    applies limit changes promptly (covering in-process writes that
    bypass the REST chain's synchronous resync), and a periodic recount
    repairs usage drift from crashes or out-of-band mutation."""

    def __init__(self, client, ledger: QuotaLedger, store,
                 period: float = 5.0):
        from ..client import Informer
        from ..reconciler.controller import Controller

        self.client = client
        self.ledger = ledger
        self.store = store
        self.period = period
        self.informer = Informer(client, QUOTA_RESOURCE)
        self.controller = Controller("quota-recount", self._process)
        self.informer.add_handler(self._on_event)
        self._task: asyncio.Task | None = None

    def _on_event(self, etype: str, old: dict | None, new: dict | None) -> None:
        m = (new or old)["metadata"]
        self.controller.enqueue((m.get("clusterName", ""),))

    async def _process(self, item) -> None:
        (cluster,) = item
        self.ledger.resync_limits(self.store, cluster)

    async def _recount_loop(self) -> None:
        while True:
            await asyncio.sleep(self.period)
            if self.ledger.device_counts_agree(2 * self.period):
                # admission accounting rode the fused fleet batch this
                # cycle: every limited key has a fresh device-side count
                # agreeing with the ledger, so the host-side recount
                # walk has nothing to repair — skip it (metered)
                REGISTRY.counter(
                    "quota_recount_skipped_total",
                    "periodic host recounts skipped because the fleet "
                    "batch's device counters already agree").inc()
            else:
                self.ledger.recount(self.store)
            self.ledger.resync_all_limits(self.store)

    async def start(self) -> None:
        await self.informer.start()
        await self.controller.start(1)
        self._task = asyncio.create_task(self._recount_loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        await self.controller.stop()
        await self.informer.stop()
