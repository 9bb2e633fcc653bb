"""ReplicationHub: the primary side of WAL shipping.

Attached to a :class:`~kcp_tpu_torch.store.store.LogicalStore` via its
replication hook, the hub sees every committed WAL record (both
durability backends journal the same record dicts; in-memory stores
still emit them) and

- retains a bounded window of encoded record lines keyed by RV, so a
  reconnecting follower resumes from its applied RV with a cheap tail
  replay (the watch-cache discipline applied to the log itself);
- fans live records out to subscriber queues that the HTTP feed
  (``GET /replication/wal``) drains into chunked ndjson streams — one
  ``json.dumps`` per record regardless of follower count;
- falls back to a full snapshot stream (materialized synchronously on
  the serving loop, so it is a consistent cut) when a follower's RV
  predates the retained window;
- tracks standby acks for semi-synchronous commits: the REST write path
  can wait until every attached standby has applied a write's RV before
  acknowledging it, which is what makes "zero acknowledged-write loss"
  a property rather than a race;
- enforces epoch fencing at the feed boundary: a subscriber announcing
  a NEWER epoch proves this primary was superseded — the store fences
  itself (writes refuse 503) instead of diverging.

Wire format (ndjson lines over one chunked response):

    {"type":"HEADER","epoch":E,"rv":R,"sub":ID,"snapshot":bool}
    {"type":"SNAP","key":[...],"obj":{...}}          (snapshot mode)
    {"type":"BARRIER","rv":R}                        (snapshot end)
    {"op":"put"|"del"|"epoch", "key":[...], "rv":R, "obj":{...}}
    {"type":"ERROR","object":{Status}}               (terminal refusal)

``repl.ship`` is a KCP_FAULTS injection point on the feed path (error =
the stream dies and the follower reconnects; latency = ship lag).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from collections import deque

from ..faults import link_fault, maybe_fail
from ..utils.trace import REGISTRY

log = logging.getLogger(__name__)


def _progress_notify_s() -> float:
    """Progress-notify cadence (etcd WatchProgressRequest analog) in
    seconds; 0 disables heartbeats entirely."""
    try:
        ms = float(os.environ.get("KCP_PROGRESS_NOTIFY_MS", "500") or 0)
    except ValueError:
        ms = 500.0
    return max(0.0, ms / 1000.0)


class _Sub:
    """One attached follower: a live-record queue + its declared role."""

    def __init__(self, sid: int, role: str):
        self.sid = sid
        self.role = role
        self.q: asyncio.Queue[bytes] = asyncio.Queue()


class ReplicationHub:
    """Primary-side WAL shipper for one LogicalStore."""

    def __init__(self, store, window: int = 200_000,
                 sync_timeout_s: float = 5.0):
        self.store = store
        # (rv, encoded line) of recent committed records — the resume
        # window. Encoded once at commit; every subscriber splices the
        # same bytes (the encode-once discipline applied to the log).
        self._records: deque[tuple[int, bytes]] = deque(maxlen=window)
        self._subs: dict[int, _Sub] = {}
        self._next_sid = 1
        self._acked: dict[int, int] = {}  # standby sid -> applied rv
        self._waiters: list[tuple[int, asyncio.Future]] = []
        # semi-sync waiters coalesce per RV: every writer of one commit
        # window parks on the window's HIGH RV, so N writers share ONE
        # future and one standby ack releases them all (one RTT/window)
        self._wait_futs: dict[int, asyncio.Future] = {}
        self.sync_timeout_s = sync_timeout_s
        self._shipped = REGISTRY.counter(
            "repl_ship_records_total",
            "WAL records shipped to replication subscribers")
        self._subs_gauge = REGISTRY.gauge(
            "repl_subscribers",
            "attached replication subscribers (replicas + standbys)")
        self._degraded = REGISTRY.counter(
            "repl_sync_degraded_total",
            "writes acknowledged without standby confirmation because "
            "the semi-sync wait timed out")
        self._ack_batched = REGISTRY.counter(
            "repl_ack_batched_total",
            "semi-sync waiters that parked on an already-waiting commit "
            "window RV — writes released by a shared standby ack instead "
            "of their own round trip")
        self._progress = REGISTRY.counter(
            "repl_progress_notify_total",
            "PROGRESS heartbeat frames shipped on idle replication feeds "
            "(no record body, just the primary's commit RV) so quiet "
            "followers know the frontier")
        store.set_repl_hook(self.commit, self.commit_batch)

    # ------------------------------------------------------------- commit

    def commit(self, rec: dict) -> None:
        """Store hook: one committed WAL record. Runs synchronously on
        the store's owning loop, so window append + fan-out are atomic
        with respect to feed registration."""
        rv = int(rec.get("rv", 0) or self.store.resource_version)
        line = json.dumps(rec, separators=(",", ":")).encode() + b"\n"
        self._records.append((rv, line))
        if self._subs:
            for sub in self._subs.values():
                sub.q.put_nowait(line)
            self._shipped.inc(len(self._subs))

    def commit_batch(self, recs: list[dict]) -> None:
        """Store batch hook: one flushed commit window. The resume
        window keeps per-RV lines (reconnect tails bisect by RV), but
        live subscribers get the whole window as ONE queue push — the
        feed writes it as one chunk, the follower applies it as one
        batch and answers ONE ack at the window's high RV."""
        lines = []
        for rec in recs:
            rv = int(rec.get("rv", 0) or self.store.resource_version)
            line = json.dumps(rec, separators=(",", ":")).encode() + b"\n"
            self._records.append((rv, line))
            lines.append(line)
        if self._subs and lines:
            blob = b"".join(lines)
            for sub in self._subs.values():
                sub.q.put_nowait(blob)
            self._shipped.inc(len(lines) * len(self._subs))

    # ------------------------------------------------------ subscriptions

    @property
    def has_sync_subscribers(self) -> bool:
        return any(s.role == "standby" for s in self._subs.values())

    def _register(self, role: str) -> _Sub:
        sub = _Sub(self._next_sid, role)
        self._next_sid += 1
        self._subs[sub.sid] = sub
        self._subs_gauge.set(len(self._subs))
        return sub

    def _unregister(self, sub: _Sub) -> None:
        self._subs.pop(sub.sid, None)
        self._acked.pop(sub.sid, None)
        self._subs_gauge.set(len(self._subs))
        self._check_waiters()

    # -------------------------------------------------------- semi-sync

    def ack(self, sid: int, rv: int) -> None:
        """A standby reports its applied RV (POST /replication/ack)."""
        sub = self._subs.get(sid)
        if sub is None or sub.role != "standby":
            return
        self._acked[sid] = max(self._acked.get(sid, 0), int(rv))
        self._check_waiters()

    def _sync_floor(self) -> int | None:
        """min applied RV over attached standbys; None when there are
        none (async mode — nothing to wait for)."""
        sids = [s.sid for s in self._subs.values() if s.role == "standby"]
        if not sids:
            return None
        return min(self._acked.get(sid, 0) for sid in sids)

    def _check_waiters(self) -> None:
        floor = self._sync_floor()
        still: list[tuple[int, asyncio.Future]] = []
        for rv, fut in self._waiters:
            if fut.done():
                self._wait_futs.pop(rv, None)
                continue
            if floor is None or floor >= rv:
                fut.set_result(True)
                self._wait_futs.pop(rv, None)
            else:
                still.append((rv, fut))
        self._waiters = still

    async def wait_committed(self, rv: int) -> bool:
        """Semi-sync commit: wait until every attached standby has
        applied ``rv``. Returns immediately when no standby is attached
        (async replication — the WAL is the durability story). Waiters
        at the same RV share one future (a commit window's writers all
        park at the window's high RV — one standby ack releases the
        whole window, counted ``repl_ack_batched_total``). On timeout
        the write is acknowledged anyway, degraded and counted: a
        lagging standby must not take primary availability hostage."""
        floor = self._sync_floor()
        if floor is None or floor >= rv:
            return True
        fut = self._wait_futs.get(rv)
        if fut is None or fut.done():
            fut = asyncio.get_running_loop().create_future()
            self._wait_futs[rv] = fut
            self._waiters.append((rv, fut))
        else:
            self._ack_batched.inc()
        try:
            # shield: the shared future must survive one waiter's timeout
            await asyncio.wait_for(asyncio.shield(fut),
                                   timeout=self.sync_timeout_s)
            return True
        except asyncio.TimeoutError:
            self._degraded.inc()
            log.warning("semi-sync wait for rv %d timed out after %.1fs; "
                        "acknowledging degraded", rv, self.sync_timeout_s)
            return False

    # ------------------------------------------------------------- feed

    async def serve_feed(self, stream, since_rv: int, sub_epoch: int,
                         role: str, cluster: str | None = None) -> None:
        """Produce one follower's feed onto a StreamResponse: header,
        tail-or-snapshot catchup, then live records until the connection
        dies or a ``repl.ship`` fault kills it.

        ``cluster`` selects the migration transport: a snapshot of that
        one cluster's objects, BARRIER, done — no live phase. The caller
        (sharding/migrate.py) fences the cluster on this store FIRST, so
        the filtered snapshot IS the cluster's final state and the
        BARRIER rv bounds every RV it ever minted for it."""
        delay = maybe_fail("repl.ship")
        # WAN-link realism: feed-side delay/partition scoped per
        # subscriber role ("repl.feed" -> "replica"/"standby"/...) — a
        # ConnectionError here kills this one follower's stream exactly
        # like the wire dying, without touching co-subscribers
        delay += link_fault("repl.feed", role or "replica")
        if delay:
            await asyncio.sleep(delay)
        if sub_epoch > self.store.epoch:
            # the subscriber has seen a newer epoch than ours: a standby
            # promoted over this primary while we were partitioned. We
            # are the zombie — fence NOW, refuse the feed.
            self.store.fence(sub_epoch)
            await stream.send_json({"type": "ERROR", "object": {
                "kind": "Status", "apiVersion": "v1", "status": "Failure",
                "reason": "Expired", "code": 410,
                "message": f"superseded by epoch {sub_epoch}; "
                           f"this primary is fenced"}})
            return
        sub = self._register(role)
        try:
            # everything up to the first await is atomic on the loop:
            # records committed after registration land in sub.q, the
            # header/tail/snapshot cover everything at or before it
            rv_now = self.store.resource_version
            oldest = self._records[0][0] if self._records else None
            need_snapshot = cluster is not None or (since_rv < rv_now and (
                oldest is None or oldest > since_rv + 1))
            header = json.dumps({
                "type": "HEADER", "epoch": self.store.epoch, "rv": rv_now,
                "sub": sub.sid, "snapshot": need_snapshot,
            }).encode() + b"\n"
            # keys only, never an (key, obj) pair list: a whole-store
            # snapshot must not pin every object dict for the life of
            # the stream (under churn that doubles resident state; on
            # the migration transport the cluster is large by
            # definition). Objects are fetched per batch at send time —
            # migration clusters are fenced first so the bytes are the
            # final state; a standby's snapshot converges through the
            # live queue it registered for above (idempotent puts, and
            # a key deleted mid-stream is skipped here because its
            # DELETE record follows).
            if cluster is not None:
                snap_keys = [k for k in self.store._objects
                             if k[1] == cluster]
            elif need_snapshot:
                snap_keys = list(self.store._objects)
            else:
                snap_keys = []
                tail = [line for rv, line in self._records
                        if since_rv < rv <= rv_now]
            await stream.send_spans([header])
            if need_snapshot:
                objects = self.store._objects
                shipped = 0
                batch: list[bytes] = []
                for key in snap_keys:
                    obj = objects.get(key)
                    if obj is None:
                        continue
                    batch.append(json.dumps(
                        {"type": "SNAP", "key": list(key), "obj": obj},
                        separators=(",", ":")).encode() + b"\n")
                    shipped += 1
                    if len(batch) >= 256:
                        await stream.send_spans(batch)
                        batch = []
                batch.append(json.dumps(
                    {"type": "BARRIER", "rv": rv_now}).encode() + b"\n")
                await stream.send_spans(batch)
                self._shipped.inc(shipped)
                if cluster is not None:
                    # migration transport ends at the barrier: the
                    # cluster is fenced, nothing more can follow
                    return
            elif tail:
                # the catchup tail is encode-once bytes (each record was
                # serialized exactly once at commit): the raw-spans send
                # hands them to the transport with no whole-batch join
                await stream.send_spans(tail)
                self._shipped.inc(len(tail))
            notify_s = _progress_notify_s()
            while True:
                if notify_s:
                    try:
                        line = await asyncio.wait_for(sub.q.get(), notify_s)
                    except asyncio.TimeoutError:
                        # feed idle past the progress cadence: ship a
                        # bodyless frontier heartbeat so the follower can
                        # answer RV-barrier reads without a fresh record.
                        # NOT appended to _records — heartbeats must never
                        # occupy the RV-resume window.
                        hb = json.dumps(
                            {"type": "PROGRESS",
                             "epoch": self.store.epoch,
                             "rv": self.store.resource_version},
                            separators=(",", ":")).encode() + b"\n"
                        delay = maybe_fail("repl.ship")
                        delay += link_fault("repl.feed", role or "replica")
                        if delay:
                            await asyncio.sleep(delay)
                        await stream.send_spans([hb])
                        self._progress.inc()
                        continue
                else:
                    line = await sub.q.get()
                batch = [line]
                while not sub.q.empty():
                    batch.append(sub.q.get_nowait())
                # graceful drain: the b"" sentinel (hub.drain) arrives
                # AFTER every shipped record in FIFO order — flush what
                # precedes it, answer a terminal Status, and end the feed
                # so the follower reconnects against whoever serves next
                draining = b"" in batch
                if draining:
                    batch = [ln for ln in batch if ln]
                delay = maybe_fail("repl.ship")
                # per-batch WAN delay: a slow link to THIS follower lags
                # its applied RV without slowing the other subscribers
                delay += link_fault("repl.feed", role or "replica")
                if delay:
                    await asyncio.sleep(delay)
                if batch:
                    await stream.send_spans(batch)
                if draining:
                    await stream.send_json({"type": "ERROR", "object": {
                        "kind": "Status", "apiVersion": "v1",
                        "status": "Failure",
                        "reason": "ServiceUnavailable", "code": 503,
                        "message": "primary is draining; re-resolve and "
                                   "resume from your applied RV"}})
                    return
        finally:
            self._unregister(sub)

    def drain(self) -> None:
        """Graceful drain: every subscriber feed flushes its queued
        records and then terminates with an in-stream Status. Runs on
        the store's owning loop AFTER the last write committed, so the
        sentinel is ordered behind every shipped record."""
        for sub in list(self._subs.values()):
            sub.q.put_nowait(b"")
