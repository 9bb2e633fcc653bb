"""Live per-cluster migration: move one logical cluster between shards
with zero lost acked writes and zero lost watch events.

The engine is a synchronous client-side routine (it runs wherever the
operator — or ``RouterFleet.scale_out`` — runs; no shard hosts it) that
composes surfaces the fleet already has:

1. **fence** — ``POST /migration/fence`` on the source pins the cluster
   read-only at a *cutover RV*: every write the source ever acked for
   the cluster has rv <= cutover (the store's group-commit barrier
   flushes in-flight windows first). Fenced writes refuse 503; clients
   retry and land on the new owner once the ring flips.
2. **stream** — ``GET /replication/wal?cluster=X&role=migration`` on the
   source serves the cluster's post-fence snapshot through the
   replication hub (SNAP records, then BARRIER — the fence makes the
   filtered snapshot the cluster's final state), and the records POST to
   the target's ``/migration/ingest`` as WAL-shaped ndjson — the same
   shape ``scripts/walreplay.py --cluster --emit-ndjson`` extracts
   offline, which is what makes walreplay the transport oracle in tests.
3. **finish** — ``POST /migration/finish`` on the target jumps its RV
   counter past the source's cutover and records the cluster's resume
   floor: a watch resume carrying a source-minted RV answers a typed
   410 (re-list), never a silent partial resume against an unrelated
   RV history.
4. **flip** — ``POST /ring {"complete": cluster}`` on the router drops
   the cluster's pending-migration pin: ownership flips atomically for
   this one cluster, the epoch bumps, and the ring (with overrides)
   fans out to every shard. Smart clients re-fetch on their next 410.
5. **purge** — ``POST /migration/purge`` on the source evicts the
   cluster's watch streams through the backpressure-eviction path
   (buffered events drain FIRST, then a terminal typed 410 → relist at
   the new owner) and drops the objects with no watch events — a move
   is not a delete.

Any failure before the flip rolls the fence back (``unfence``) so an
aborted migration never strands the cluster unwritable; the whole
sequence is idempotent and re-runnable. ``migrate.cutover`` is the
KCP_FAULTS drill point between finish and flip — the worst possible
instant to die (target loaded, ring not flipped) — proving the
rollback leaves the fleet serving from the source.

Metered: ``migration_seconds`` (per-cluster wall time),
``migration_records_total`` (applied on the target, store-side),
``migration_fenced_writes_total`` (refusals during the fence window,
store-side).
"""

from __future__ import annotations

import http.client
import json
import logging
import time
from urllib.parse import quote, urlsplit

from ..faults import maybe_fail
from ..utils.trace import REGISTRY
from .ring import owner_name

log = logging.getLogger(__name__)

_SECONDS = REGISTRY.histogram(
    "migration_seconds",
    "end-to-end wall time migrating one logical cluster between shards "
    "(fence -> stream -> finish -> ring flip -> purge)")


class MigrationError(RuntimeError):
    """A migration step refused or the transport broke; the fence has
    been rolled back (ownership never flips on a failed migration)."""


def _connect(base_url: str, timeout: float):
    p = urlsplit(base_url)
    cls = (http.client.HTTPSConnection if p.scheme == "https"
           else http.client.HTTPConnection)
    return cls(p.hostname, p.port, timeout=timeout)


def _req(base_url: str, method: str, target: str, body=None,
         token: str = "", timeout: float = 30.0) -> dict:
    """One JSON round trip; raises MigrationError on any >=400 answer
    (every step must succeed explicitly — a migration has no partial
    credit)."""
    headers: dict[str, str] = {}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    payload = None
    if body is not None:
        payload = (body if isinstance(body, (bytes, bytearray))
                   else json.dumps(body).encode())
        headers["Content-Type"] = "application/json"
    c = _connect(base_url, timeout)
    try:
        c.request(method, target, payload, headers)
        r = c.getresponse()
        data = r.read()
        if r.status >= 400:
            raise MigrationError(
                f"{method} {base_url}{target} answered {r.status}: "
                f"{data[:300].decode('utf-8', 'replace')}")
        return json.loads(data) if data else {}
    except (ConnectionError, OSError, TimeoutError,
            http.client.HTTPException) as e:
        raise MigrationError(
            f"{method} {base_url}{target} unreachable: {e}") from e
    finally:
        c.close()


def fetch_cluster_records(source_url: str, cluster: str, token: str = "",
                          timeout: float = 120.0
                          ) -> tuple[list[dict], int]:
    """Stream one cluster's post-fence snapshot off the source's
    filtered replication feed; returns (WAL-shaped put records, the
    BARRIER rv). The BARRIER bounds every RV the source ever minted for
    the cluster — it becomes the target's ``finish`` watermark."""
    headers: dict[str, str] = {"Accept": "application/x-ndjson"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    target = (f"/replication/wal?cluster={quote(cluster, safe='')}"
              f"&role=migration&sinceRV=0&epoch=0")
    recs: list[dict] = []
    barrier_rv = None
    c = _connect(source_url, timeout)
    try:
        c.request("GET", target, None, headers)
        r = c.getresponse()
        if r.status >= 400:
            raise MigrationError(
                f"migration feed {source_url}{target} answered {r.status}")
        while True:
            line = r.readline()
            if not line:
                break
            line = line.strip()
            if not line:
                continue
            msg = json.loads(line)
            t = msg.get("type")
            if t == "HEADER":
                continue
            if t == "SNAP":
                recs.append({"op": "put", "key": msg["key"],
                             "obj": msg["obj"]})
            elif t == "BARRIER":
                barrier_rv = int(msg["rv"])
                break
            elif t == "ERROR":
                raise MigrationError(
                    f"migration feed refused: {msg.get('object')}")
    except (ConnectionError, OSError, TimeoutError, ValueError,
            http.client.HTTPException) as e:
        raise MigrationError(
            f"migration feed {source_url} broke mid-stream: {e}") from e
    finally:
        c.close()
    if barrier_rv is None:
        raise MigrationError(
            "migration feed ended before its BARRIER — transport torn; "
            "nothing was applied, the fence is being rolled back")
    return recs, barrier_rv


def ingest_records(target_url: str, recs: list[dict], token: str = "",
                   batch: int = 256, timeout: float = 60.0) -> int:
    """POST WAL-shaped records to the target's ``/migration/ingest`` in
    ndjson batches; returns records applied. Also the offline path:
    ``walreplay.py --cluster X --emit-ndjson`` output pipes here."""
    applied = 0
    for i in range(0, len(recs), batch):
        payload = b"".join(
            json.dumps(rec, separators=(",", ":")).encode() + b"\n"
            for rec in recs[i:i + batch])
        out = _req(target_url, "POST", "/migration/ingest", payload,
                   token=token, timeout=timeout)
        applied += int(out.get("applied", 0))
    return applied


def migrate_cluster(router_url: str, cluster: str, *, token: str = "",
                    batch: int = 256, timeout: float = 120.0) -> dict:
    """Move one pinned cluster to its HRW owner under the grown ring.

    The cluster must already carry a pending-migration pin (the router's
    ``{"add": ...}`` installs them); source and target are derived from
    the ring document, so the caller names only the cluster."""
    t0 = time.monotonic()
    doc = _req(router_url, "GET", "/ring", token=token, timeout=timeout)
    shards = {s["name"]: s["url"] for s in doc.get("shards", ())}
    overrides = doc.get("overrides") or {}
    src_name = overrides.get(cluster)
    if src_name is None:
        raise MigrationError(
            f"cluster {cluster!r} has no pending migration "
            f"(overrides: {sorted(overrides)})")
    dst_name = owner_name(list(shards), cluster)
    if dst_name == src_name:
        # the pin points at the HRW owner already (a completed retry, or
        # the grow didn't move this cluster after all): just flip
        _req(router_url, "POST", "/ring", {"complete": cluster},
             token=token, timeout=timeout)
        return {"cluster": cluster, "source": src_name,
                "target": dst_name, "records": 0, "noop": True}
    src_url, dst_url = shards[src_name], shards[dst_name]
    cutover = int(_req(src_url, "POST", "/migration/fence",
                       {"cluster": cluster}, token=token,
                       timeout=timeout)["cutover_rv"])
    try:
        recs, barrier = fetch_cluster_records(src_url, cluster,
                                              token=token, timeout=timeout)
        applied = ingest_records(dst_url, recs, token=token, batch=batch,
                                 timeout=timeout)
        _req(dst_url, "POST", "/migration/finish",
             {"cluster": cluster, "source_rv": max(cutover, barrier)},
             token=token, timeout=timeout)
        # the cutover drill: dying HERE — target loaded, ring not yet
        # flipped — is the worst instant; the except below proves the
        # fleet keeps serving from the source (fence rolled back)
        delay = maybe_fail("migrate.cutover")
        if delay:
            time.sleep(delay)
        _req(router_url, "POST", "/ring", {"complete": cluster},
             token=token, timeout=timeout)
    except BaseException:
        try:
            _req(src_url, "POST", "/migration/unfence",
                 {"cluster": cluster}, token=token, timeout=timeout)
        except MigrationError as e:
            log.warning("fence rollback for %s failed (%s); the cluster "
                        "stays fenced until a retry or manual unfence",
                        cluster, e)
        raise
    # past the flip the migration is irrevocable: purge must not undo it
    _req(src_url, "POST", "/migration/purge", {"cluster": cluster},
         token=token, timeout=timeout)
    dur = time.monotonic() - t0
    _SECONDS.observe(dur)
    log.info("cluster %s migrated %s -> %s: %d records, cutover rv %d, "
             "%.3fs", cluster, src_name, dst_name, applied, cutover, dur)
    return {"cluster": cluster, "source": src_name, "target": dst_name,
            "records": applied, "cutover_rv": cutover,
            "seconds": round(dur, 3)}


def scale_out(router_url: str, entry: str, *, token: str = "",
              batch: int = 256, timeout: float = 120.0) -> dict:
    """Grow a live fleet by one shard: publish the grown ring (every
    moving cluster pinned to its current owner), then migrate the
    pinned clusters one at a time — each flips atomically when its own
    stream lands. ``entry`` is one KCP_SHARDS-shaped shard entry
    (``name=url[|replica-url...]``)."""
    doc = _req(router_url, "POST", "/ring", {"add": entry}, token=token,
               timeout=timeout)
    pending = list(doc.get("pending", ()))
    log.info("ring grown to %d shards (epoch %d): migrating %d clusters",
             len(doc.get("shards", ())), doc.get("epoch", 0), len(pending))
    migrated = [migrate_cluster(router_url, c, token=token, batch=batch,
                                timeout=timeout) for c in pending]
    return {"added": entry, "pending": pending, "migrated": migrated,
            "records": sum(m["records"] for m in migrated)}
