"""Scatter-gather router: the frontend of the sharded control plane.

``kcp start --role router --shards s0=http://...,s1=http://...`` serves
the SAME REST surface as a shard, but owns no storage: every request is
routed over the :class:`~kcp_tpu_torch.sharding.ring.ShardRing`.

- **Single-cluster requests** (the overwhelming majority: every tenant
  client, every informer bound to its own workspace) proxy straight
  through to the owning shard — the raw request target and body go over
  the wire verbatim and the shard's response bytes come back verbatim,
  so the shards' encode-once bytes are relayed without a single re-encode.
  Transport uses :class:`~kcp_tpu_torch.store.remote.ConnectionPool` (bounded
  kept-alive RestClients per shard, one shared per-peer
  :class:`~kcp_tpu_torch.utils.circuit.CircuitBreaker`): a dead shard trips
  once and fails fast 503 instead of stacking 30 s connect timeouts.
- **Wildcard lists** scatter to every shard and merge by byte-splicing
  the shards' ``items`` arrays into one envelope — per-object bytes are
  exactly what the owning shard serialized. The merged list's
  ``resourceVersion`` is a **vector RV** (:mod:`.rvmap`): the per-shard
  RVs packed into one opaque integer.
- **Wildcard watches** merge N per-shard streams. Event lines relay
  byte-verbatim; the router parses each line only to keep per-shard
  position (vector-RV bookkeeping). A resume (``?resourceVersion=``)
  decodes the vector and resumes each shard from ITS OWN honest
  ``since_rv``; a non-vector RV answers 410 Gone (re-list — never
  guess). Shard-local BOOKMARKs are absorbed into the position map;
  client-facing BOOKMARKs carry the vector. A shard stream dying ends
  the merged stream with a terminal in-stream 410 Status — the
  fault discipline: clients re-list and resume from a fresh vector.
- **Wildcard writes** route through the one copy of the wildcard rule
  (:func:`~kcp_tpu_torch.utils.routing.resolve_write_cluster`) and then the
  ring; a write without ``metadata.clusterName`` is a 400, exactly as
  on a shard.

``router.proxy`` is a KCP_FAULTS injection point (error/latency on the
relay path). Metrics: ``router_proxy_seconds``,
``router_scatter_fanout``, ``router_shard_unavailable_total``,
``router_watch_resumes_total``.
"""

from __future__ import annotations

import asyncio
import base64
import http.client
import json
import logging
import os
import re
import time
from concurrent.futures import ThreadPoolExecutor
from urllib.parse import quote, urlencode, urlsplit

from .. import obs
from ..analysis.sanitize import make_lock
from ..faults import maybe_fail
from ..server.handler import CLUSTER_HEADER, DEFAULT_CLUSTER, _error_response, _status_body
from ..server.httpd import Request, Response, StreamResponse
from ..server.rest import RestWatch
from ..store.remote import ConnectionPool
from ..store.store import WILDCARD, encode_continue
from ..utils import errors
from ..utils.routing import resolve_write_cluster
from ..utils.trace import REGISTRY
from .ring import ShardRing, owner_name
from .rvmap import decode_rvmap, encode_rvmap

log = logging.getLogger(__name__)

_ITEMS_MARKER = b'"items": ['
_RV_RE = re.compile(rb'"resourceVersion": "(\d+)"')
_CONT_RE = re.compile(rb'"continue": "([^"]*)"')


def _encode_router_continue(rvs: list[int], toks: list) -> str:
    """Pack every shard's pinned RV and per-shard store continue token
    into ONE opaque client token — the paged analogue of the vector RV."""
    raw = json.dumps({"v": 1, "n": len(rvs), "r": rvs, "t": toks},
                     separators=(",", ":")).encode()
    return base64.urlsafe_b64encode(raw).decode()


def _decode_router_continue(token: str, n: int):
    """``(rvs, toks)`` or None when the token is malformed or was minted
    against a different shard topology (callers answer typed 410)."""
    try:
        d = json.loads(base64.urlsafe_b64decode(token.encode()))
        if d.get("v") != 1 or d.get("n") != n:
            return None
        rvs, toks = d["r"], d["t"]
        if len(rvs) != n or len(toks) != n:
            return None
        if not all(t is None or isinstance(t, str) for t in toks):
            return None
        return [int(x) for x in rvs], list(toks)
    except (ValueError, KeyError, TypeError):
        return None


def _swap_continue(target: str, token: str) -> str:
    """The original request target with its ``continue`` query value
    replaced by a shard-local token (limit/labelSelector relay as-is)."""
    path, _sep, query = target.partition("?")
    parts = [p for p in query.split("&")
             if p and not p.startswith("continue=")]
    parts.append("continue=" + quote(token, safe=""))
    return path + "?" + "&".join(parts)
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([^}]*)\})?\s+(.*)$")


def _merge_expositions(parts: list[tuple[str, str]]) -> str:
    """Merge per-process Prometheus expositions into one page: every
    sample line gains a ``shard="<label>"`` label (appended after any
    existing labels), HELP/TYPE are emitted once per metric (first
    source wins), and metrics group together so the page stays valid
    exposition format (one TYPE per family)."""
    meta: dict[str, list[str]] = {}
    samples: dict[str, list[str]] = {}
    order: list[str] = []
    for label, text in parts:
        esc = label.replace("\\", "\\\\").replace('"', '\\"')
        for line in text.splitlines():
            if not line.strip():
                continue
            if line.startswith("# HELP ") or line.startswith("# TYPE "):
                name = line.split(None, 3)[2]
                if name not in meta:
                    meta[name] = []
                    order.append(name)
                if not any(ln.split(None, 3)[1] == line.split(None, 3)[1]
                           for ln in meta[name]):
                    meta[name].append(line)
                continue
            if line.startswith("#"):
                continue
            m = _SAMPLE_RE.match(line)
            if m is None:
                continue
            name, _braces, labels, value = m.groups()
            family = name
            for suffix in ("_bucket", "_sum", "_count"):
                if name.endswith(suffix) and name[:-len(suffix)] in meta:
                    family = name[:-len(suffix)]
                    break
            new_labels = (f'{labels},shard="{esc}"' if labels
                          else f'shard="{esc}"')
            if family not in samples and family not in meta:
                order.append(family)
            samples.setdefault(family, []).append(
                f"{name}{{{new_labels}}} {value}")
    out: list[str] = []
    for name in order:
        out.extend(meta.get(name, ()))
        out.extend(samples.get(name, ()))
    return "\n".join(out) + "\n"


class _TapWatch(RestWatch):
    """A per-shard watch stream that keeps each event line's RAW bytes.

    The router relays lines verbatim (zero re-encode — the whole point
    of riding the shards' encode-once serving) while parsing each line
    once for vector-RV bookkeeping. Queue items are ``(raw, msg)``
    pairs; the ``None`` sentinel still marks end-of-stream, and
    ``self.error`` still carries a non-2xx upstream response.
    """

    def _feed(self, chunk: bytes) -> None:
        lines = (self._buf + self._decoder.decode(chunk)).split("\n")
        self._buf = lines.pop()
        for line in lines:
            if line.strip():
                self._events.put_nowait(
                    (line.encode("utf-8") + b"\n", json.loads(line)))

    async def next(self) -> tuple[bytes, dict] | None:
        """Next ``(raw_line, parsed)`` pair, or None at end-of-stream."""
        self._ensure_started()
        if self._closed and self._events.empty():
            return None
        item = await self._events.get()
        if item is None:
            self._events.put_nowait(None)
            return None
        return item

    def drain_raw(self) -> list[tuple[bytes, dict]]:
        out: list[tuple[bytes, dict]] = []
        while not self._events.empty():
            item = self._events.get_nowait()
            if item is None:
                self._events.put_nowait(None)
                break
            out.append(item)
        return out


class RouterHandler:
    """Routes parsed HTTP requests onto a shard ring (no local store)."""

    def __init__(self, ring: ShardRing, version_info: dict | None = None,
                 token: str = "", ca_data: bytes | str | None = None,
                 ca_file: str | None = None, pool_cap: int | None = None,
                 bookmark_every: float | None = None):
        self.ring = ring
        self.version_info = version_info or {
            "major": "0", "minor": "1", "gitVersion": "kcp-tpu-v0.1.0",
            "role": "router", "shards": len(ring)}
        self.ready = False
        cap = pool_cap if pool_cap is not None else int(
            os.environ.get("KCP_ROUTER_POOL", "8"))
        self.bookmark_every = bookmark_every if bookmark_every is not None \
            else float(os.environ.get("KCP_ROUTER_BOOKMARK_S", "5"))
        # router → shard auth: the CLIENT's bearer token is forwarded
        # when present (shards terminate authz; the router stays a dumb
        # pipe), `token` is the fallback credential for routerless
        # callers (health scatters)
        self._pools = [ConnectionPool(s.url, token=token, ca_data=ca_data,
                                      ca_file=ca_file, cap=cap)
                       for s in ring]
        # read replicas per shard (Shard.replicas — WAL-fed followers):
        # plain single-cluster reads round-robin over them, writes and
        # RV-resumes stay on the primary (a replica's applied RV may
        # trail; it answers an honest 410 for resumes beyond it, and the
        # router never manufactures freshness on its behalf)
        self._rpools = [
            [ConnectionPool(url, token=token, ca_data=ca_data,
                            ca_file=ca_file, cap=cap) for url in s.replicas]
            for s in ring]
        self._rr = [0] * len(ring)
        # scatter concurrency: every shard must be reachable in parallel
        # or a wildcard fan-out serializes on the slowest round trip
        self._exec = ThreadPoolExecutor(
            max_workers=max(8, 2 * len(ring)),
            thread_name_prefix="router-io")
        self._proxy_seconds = REGISTRY.histogram(
            "router_proxy_seconds", "one router→shard relay round trip")
        self._fanout = REGISTRY.histogram(
            "router_scatter_fanout", "shards touched per scatter-gather")
        self._unavailable = REGISTRY.counter(
            "router_shard_unavailable_total",
            "relay attempts that found a shard unreachable (transport "
            "failure or open circuit breaker)")
        self._resumes = REGISTRY.counter(
            "router_watch_resumes_total",
            "merged wildcard watches resumed from a decoded vector RV")
        self._replica_reads = REGISTRY.counter(
            "router_replica_reads_total",
            "single-cluster reads served by a shard's read replica")
        self._replica_fallback = REGISTRY.counter(
            "router_replica_fallback_total",
            "replica reads that fell back to the primary (replica "
            "unreachable or refusing)")
        self._watch_spread = REGISTRY.counter(
            "router_watch_spread_total",
            "fresh single-cluster watch streams the router spread onto "
            "a shard's read replica (watch connection capacity scaling "
            "with replica count)")
        # promotion discovery: repeated 503/unreachable answers from a
        # shard's primary trigger a probe of the shard's replica list;
        # a replica answering /replication/status as role=primary is the
        # promoted standby — write routing swaps onto it in place, no
        # router restart. State is touched from executor threads, so the
        # counters/probe clock sit behind a lock (pool swaps themselves
        # are atomic whole-list/whole-slot assignments).
        self._rehomes = REGISTRY.counter(
            "router_rehome_total",
            "times the router swapped a shard's write routing onto a "
            "promoted replica after its primary died or was fenced")
        self._rehome_lock = make_lock("router.rehome")
        self._primary_fails = [0] * len(ring)
        self._last_probe = [0.0] * len(ring)
        self._retired: list[ConnectionPool] = []
        # ring epoch: bumped on every ring change (POST /ring republish,
        # promotion rehome) — smart clients stamp it on direct requests
        # and re-fetch GET /ring when anything disagrees
        self.ring_epoch = 1
        # pool construction knobs, kept for set_ring rebuilds
        self._pool_kw = dict(token=token, ca_data=ca_data, ca_file=ca_file,
                             cap=cap)
        self._raw_chunks = REGISTRY.counter(
            "router_raw_relay_chunks_total",
            "watch-stream chunks forwarded by the zero-parse single-"
            "cluster relay (length-delimited framing only — payload "
            "bytes never decoded, split, or parsed)")

    def close(self) -> None:
        self._exec.shutdown(wait=False, cancel_futures=True)
        for p in self._pools:
            p.close()
        for rp in self._rpools:
            for p in rp:
                p.close()
        for p in self._retired:
            p.close()

    # ------------------------------------------------------------ /ring

    def _ring_doc(self) -> dict:
        """The smart-client handshake document: the current ring and its
        epoch — everything a client needs to compute HRW owners locally
        and go direct."""
        return {
            "epoch": self.ring_epoch,
            "shards": [{"name": s.name, "url": s.url,
                        "replicas": list(s.replicas)}
                       for s in self.ring.shards],
            # pending-migration overlay: clusters pinned to their OLD
            # owner while their data streams to the new one — clients
            # and shards resolve owners override-first, so ownership
            # flips atomically per cluster when its pin drops
            "overrides": dict(self.ring.overrides),
        }

    def set_ring(self, ring: ShardRing) -> None:
        """Swap the serving ring in place (the ``POST /ring`` republish
        after a shard moves to a new address): pools for unchanged URLs
        carry over, pools for departed URLs retire (closed at
        handler.close — in-flight relays may still hold their clients),
        and the ring epoch bumps so smart clients re-fetch."""
        with self._rehome_lock:
            old_by_url = {p.base_url: p for p in self._pools}
            old_r_by_url = {p.base_url: p
                            for rp in self._rpools for p in rp}
            pools: list[ConnectionPool] = []
            rpools: list[list[ConnectionPool]] = []
            for s in ring:
                pools.append(old_by_url.pop(s.url, None)
                             or ConnectionPool(s.url, **self._pool_kw))
                rp = []
                for url in s.replicas:
                    rp.append(old_r_by_url.pop(url, None)
                              or ConnectionPool(url, **self._pool_kw))
                rpools.append(rp)
            self._retired.extend(old_by_url.values())
            self._retired.extend(
                p for p in old_r_by_url.values()
                if all(p not in rp for rp in rpools))
            # whole-slot assignments: concurrent relays hold consistent
            # snapshots of the old lists
            self.ring = ring
            self._pools = pools
            self._rpools = rpools
            self._rr = [0] * len(ring)
            self._primary_fails = [0] * len(ring)
            self._last_probe = [0.0] * len(ring)
            self.ring_epoch += 1
        log.warning("ring republished (epoch %d): %s overrides=%s",
                    self.ring_epoch,
                    [f"{s.name}={s.url}" for s in ring], ring.overrides)
        self._fanout_ring()

    def _fanout_ring(self) -> None:
        """Install the new ring identity (names, epoch, overrides) on
        every member shard, best-effort in the background: a shard that
        misses the fan-out answers spurious ring-mismatch 410s to direct
        clients, who fall back through the router — correctness never
        depends on delivery (shard-side epoch monotonicity discards any
        late, superseded install)."""
        with self._rehome_lock:
            doc = {"epoch": self.ring_epoch,
                   "names": [s.name for s in self.ring.shards],
                   "overrides": dict(self.ring.overrides)}
            pools = list(self._pools)
        payload = json.dumps(doc).encode()

        def _post(pool: ConnectionPool) -> None:
            try:
                with pool.client() as c:
                    c.request_raw("POST", "/ring", payload,
                                  {"content-type": "application/json"})
            except Exception:
                pass  # best-effort (see docstring)

        for p in pools:
            self._exec.submit(_post, p)

    # ----------------------------------------------------------- plumbing

    def _shard_call(self, idx: int, method: str, target: str,
                    payload: bytes | None, headers: dict[str, str],
                    pool: ConnectionPool | None = None, who: str = "",
                    _rehomed: bool = False,
                    ) -> tuple[int, dict[str, str], bytes]:
        """One raw relay round trip to shard ``idx`` (executor thread);
        ``pool`` overrides the primary pool for replica-routed reads.
        Primary relays that fail 503/unreachable feed the promotion-
        discovery counter; when discovery swaps routing onto a promoted
        replica the call retries ONCE against the new primary."""
        delay = maybe_fail("router.proxy")
        if delay:
            time.sleep(delay)
        primary_call = pool is None
        use = self._pools[idx] if primary_call else pool
        t0 = time.perf_counter()
        try:
            with use.client() as c:
                status, rheaders, body = c.request_raw(
                    method, target, payload, headers)
        except errors.UnavailableError:
            # breaker fail-fast: already the right type, just count it
            self._unavailable.inc()
            if primary_call and not _rehomed \
                    and self._note_primary_failure(idx):
                return self._shard_call(idx, method, target, payload,
                                        headers, None, who, _rehomed=True)
            raise
        except (ConnectionError, OSError, TimeoutError,
                http.client.HTTPException) as e:
            self._unavailable.inc()
            if primary_call and not _rehomed \
                    and self._note_primary_failure(idx):
                return self._shard_call(idx, method, target, payload,
                                        headers, None, who, _rehomed=True)
            raise errors.UnavailableError(
                f"shard {who or self.ring.shards[idx].name} "
                f"unreachable: {e}") from e
        finally:
            self._proxy_seconds.observe(time.perf_counter() - t0)
        if primary_call:
            if status == 503:
                # a fenced / mid-promotion ex-primary ANSWERS but refuses
                # (store read-only 503): that is a dead write endpoint
                # for discovery purposes, even though transport is up
                if not _rehomed and self._note_primary_failure(idx):
                    return self._shard_call(idx, method, target, payload,
                                            headers, None, who,
                                            _rehomed=True)
            else:
                with self._rehome_lock:
                    self._primary_fails[idx] = 0
        return status, rheaders, body

    def _note_primary_failure(self, idx: int) -> bool:
        """Count a consecutive primary-relay failure for shard ``idx``;
        at the threshold, probe the shard's replicas for a promoted
        primary (``/replication/status`` role=primary, unfenced) and
        swap write routing onto it in place. Returns True when routing
        changed — the caller retries once against the new primary."""
        now = time.monotonic()
        with self._rehome_lock:
            self._primary_fails[idx] += 1
            if self._primary_fails[idx] < 2 or not self._rpools[idx]:
                return False
            if now - self._last_probe[idx] < 0.25:
                return False  # probe at most ~4x/s per shard
            self._last_probe[idx] = now
            candidates = list(self._rpools[idx])
        promoted = None
        for p in candidates:
            info = self._probe_status(p)
            if (info is not None and not info.get("fenced")
                    and info.get("role") == "primary"):
                promoted = p
                break
        if promoted is None:
            return False
        with self._rehome_lock:
            if self._pools[idx] is promoted:
                return True  # another thread already swapped
            old = self._pools[idx]
            # whole-slot / whole-list assignments: concurrent readers
            # hold snapshots of the old list and stay consistent
            self._pools[idx] = promoted
            self._rpools[idx] = [p for p in self._rpools[idx]
                                 if p is not promoted]
            # the dead primary pool is retired, not closed: in-flight
            # calls may still hold its clients (closed at handler.close)
            self._retired.append(old)
            self._primary_fails[idx] = 0
            # the ring itself re-points at the promoted primary and the
            # epoch bumps: smart clients going direct to the dead URL
            # fall back once, re-fetch /ring, and follow the promotion
            s = self.ring.shards[idx]
            shards = list(self.ring.shards)
            shards[idx] = type(s)(
                s.name, promoted.base_url,
                tuple(u for u in s.replicas if u != promoted.base_url))
            self.ring = ShardRing(shards, dict(self.ring.overrides))
            self.ring_epoch += 1
        self._rehomes.inc()
        log.warning("shard %s: write routing re-homed %s -> %s "
                    "(promoted replica)", self.ring.shards[idx].name,
                    old.base_url, promoted.base_url)
        self._fanout_ring()
        return True

    @staticmethod
    def _probe_status(pool: ConnectionPool) -> dict | None:
        """GET /replication/status through ``pool``; None when the
        endpoint is unreachable or not a replication participant."""
        try:
            with pool.client() as c:
                status, _h, body = c.request_raw("GET",
                                                 "/replication/status")
            if status != 200:
                return None
            out = json.loads(body)
            return out if isinstance(out, dict) else None
        except Exception:  # noqa: BLE001 — a failed probe is "not promoted"
            return None

    async def _call(self, idx: int, method: str, target: str,
                    payload: bytes | None, headers: dict[str, str],
                    pool: ConnectionPool | None = None, who: str = ""):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._exec, self._shard_call, idx, method, target, payload,
            headers, pool, who)

    async def _read_via_replica(self, idx: int, target: str,
                                req: Request) -> Response:
        """A single-cluster read, round-robined over the owning shard's
        replicas; primary fallback when every replica is unreachable or
        refusing. RV-carrying reads (X-Kcp-Min-Rv, continue tokens,
        resourceVersion params) forward as-is — the replica's RV
        barrier parks them until its applied RV covers the pin, so
        they no longer burn the primary. Fallbacks are metered per
        reason: 503 is the replica's lag shed, 504 its RV-barrier
        timeout, transport/breaker failures mean it was unreachable."""
        pools = self._rpools[idx]
        n = len(pools)
        start = self._rr[idx] % n
        self._rr[idx] = (start + 1) % n
        headers = self._fwd_headers(req)
        reasons: set[str] = set()
        for k in range(n):
            j = (start + k) % n
            who = f"{self.ring.shards[idx].name}/replica{j}"
            try:
                status, h, body = await self._call(
                    idx, "GET", target, None, headers,
                    pool=pools[j], who=who)
            except errors.UnavailableError:
                reasons.add("breaker_open")
                continue
            if status == 503:
                reasons.add("lag_shed")
                continue
            if status == 504:
                # the replica is healthy but behind the read's required
                # RV and the bounded wait expired: the next replica may
                # be caught up; otherwise the primary answers
                reasons.add("consistent_timeout")
                continue
            self._replica_reads.inc()
            return self._relay(status, h, body)
        self._replica_fallback.inc()
        for r in ("consistent_timeout", "lag_shed", "breaker_open"):
            if r in reasons:
                REGISTRY.counter(
                    f"router_replica_fallback_{r}_total").inc()
                break
        status, h, body = await self._call(idx, "GET", target, None, headers)
        return self._relay(status, h, body)

    def _replica_watch_pool(self, idx: int,
                            req: Request) -> ConnectionPool | None:
        """Where a single-cluster watch stream lands: round-robin
        across the shard's primary AND its replicas, so live watch
        connection count scales with the replica count — a replica's
        stream is its own honest RV sequence. Resumes used to pin to
        the primary (a lagging replica answered 410 beyond its applied
        RV); with the consistent-read gate a replica parks the resume
        until its applied RV covers it, so RV-resumes spread too —
        reject_future_rv still answers the typed 410 if the bounded
        wait expires."""
        pools = self._rpools[idx]
        if not pools:
            return None
        j = self._rr[idx] % (len(pools) + 1)
        self._rr[idx] = (j + 1) % (len(pools) + 1)
        if j == len(pools):
            return None  # the primary's turn in the rotation
        self._watch_spread.inc()
        return pools[j]

    async def _scatter(self, method: str, target: str,
                       headers: dict[str, str]):
        """The same request against every shard, in parallel. Raises
        UnavailableError if ANY shard is unreachable — a partial scatter
        cannot honestly claim cross-shard answers."""
        self._fanout.observe(len(self.ring))
        return await asyncio.gather(
            *(self._call(i, method, target, None, headers)
              for i in range(len(self.ring))))

    @staticmethod
    def _fwd_headers(req: Request) -> dict[str, str]:
        h = {}
        for k, out in (("authorization", "Authorization"),
                       ("content-type", "Content-Type"),
                       ("accept", "Accept"),
                       # session read-your-writes floor: the replica's
                       # RV barrier needs the client's required RV
                       ("x-kcp-min-rv", "X-Kcp-Min-Rv")):
            v = req.headers.get(k)
            if v:
                h[out] = v
        # trace propagation: the shard's server span parents onto the
        # router's relay span (the current context installed by __call__)
        ctx = obs.current()
        if ctx is not None:
            h[obs.TRACEPARENT] = ctx.header()
        return h

    @staticmethod
    def _relay(status: int, rheaders: dict[str, str], body: bytes) -> Response:
        lower = {k.lower(): v for k, v in rheaders.items()}
        resp = Response(status=status, body=body,
                        content_type=lower.get("content-type",
                                               "application/json"))
        if "retry-after" in lower:
            resp.headers["Retry-After"] = lower["retry-after"]
        if "x-kcp-ring-epoch" in lower:
            # a shard's ring-mismatch stamp passes through untouched:
            # a routed-but-smart-aware client sees the same staleness
            # signal it would on the direct path
            resp.headers["X-Kcp-Ring-Epoch"] = lower["x-kcp-ring-epoch"]
        if "x-kcp-rv" in lower:
            # a write's committed RV: routed clients raise their session
            # read-your-writes floor from it exactly like direct ones
            resp.headers["X-Kcp-Rv"] = lower["x-kcp-rv"]
        return resp

    @staticmethod
    def _parse_resource(segs: list[str]):
        """Path-shape parse (no scheme resolution — shards resolve):
        ``(group, version, namespace, resource, name, subresource)`` or
        None for discovery / non-resource paths."""
        if segs[0] == "api":
            group, rest = "", segs[1:]
        elif segs[0] == "apis":
            if len(segs) < 3:
                return None
            group, rest = segs[1], segs[2:]
        else:
            return None
        if len(rest) < 2:
            return None  # /api/v1 and /apis/g/v are discovery
        _version, rest = rest[0], rest[1:]
        namespace = ""
        if rest[0] == "namespaces" and len(rest) >= 3:
            namespace, rest = rest[1], rest[2:]
        resource, rest = rest[0], rest[1:]
        name = rest[0] if rest else None
        sub = rest[1] if len(rest) > 1 else None
        if len(rest) > 2:
            return None
        return (group, _version, namespace, resource, name, sub)

    # ------------------------------------------------------------ routing

    async def __call__(self, req: Request) -> Response | StreamResponse:
        """Route one request under a trace context: the client's
        ``traceparent`` is honored (else a head-sampled root is minted),
        the relay span covers the whole routing decision + shard round
        trip(s), and ``_fwd_headers`` hands every shard hop the relay
        span as its parent. SLO-breaching relays force-record."""
        tracer = obs.TRACER
        if not tracer.enabled:
            return await self._route(req)
        ctx = tracer.from_headers(req.headers)
        if ctx is None and tracer.head_sampled():
            ctx = tracer.mint(sampled=True)
        if ctx is None or not ctx.sampled:
            # unsampled fast path (the shard makes no decision of its
            # own: no traceparent is forwarded, and its own coin stays
            # in its pocket for direct traffic); SLO upgrade after the
            # fact, mirroring the shard handler
            t0 = time.time()
            resp = await self._route(req)
            dur = time.time() - t0
            if dur >= tracer.slo_s:
                base = ctx or tracer.mint(sampled=False)
                if base is not None:
                    sub = tracer.child(base)
                    obs.record_span(
                        "router.relay", sub, base.span_id, t0, dur,
                        {"method": req.method, "path": req.path,
                         "status": getattr(resp, "status", 200),
                         "slo_breach": True}, force=True)
            return resp
        sub = tracer.child(ctx)
        token = obs.set_current(sub)
        t0 = time.time()
        status = 500
        try:
            resp = await self._route(req)
            status = getattr(resp, "status", 200)
            return resp
        finally:
            obs.reset_current(token)
            dur = time.time() - t0
            attrs = {"method": req.method, "path": req.path,
                     "status": status}
            if dur >= tracer.slo_s:
                attrs["slo_breach"] = True
            obs.record_span("router.relay", sub, ctx.span_id, t0, dur,
                            attrs)

    async def _route(self, req: Request) -> Response | StreamResponse:
        segs = [s for s in req.path.split("/") if s]
        cluster = req.headers.get(CLUSTER_HEADER, DEFAULT_CLUSTER)
        cluster_in_path = False
        if len(segs) >= 2 and segs[0] == "clusters":
            cluster = segs[1]
            segs = segs[2:]
            cluster_in_path = True
        if not segs:
            return Response.of_json(
                {"paths": ["/api", "/apis", "/healthz", "/version"]})
        head = segs[0]
        if head in ("healthz", "livez"):
            return Response(body=b"ok", content_type="text/plain")
        if head == "readyz":
            if self.ready:
                return Response(body=b"ok", content_type="text/plain")
            return Response(status=500, body=b"not ready",
                            content_type="text/plain")
        if head == "ring":
            # the smart-client handshake surface: GET serves the current
            # ring + epoch; POST republishes it — {"shards": ...} swaps
            # the whole ring (the operator's move after a shard
            # restarts on a new address), {"add"}/{"complete"}/{"remove"}
            # are the elastic scale-out lifecycle (sharding/migrate.py)
            if req.method == "GET":
                return Response.of_json(self._ring_doc())
            if req.method == "POST":
                try:
                    body = json.loads(req.body) if req.body else {}
                except ValueError as e:
                    return _error_response(errors.BadRequestError(
                        f"malformed JSON body: {e}"))
                if not isinstance(body, dict):
                    return _error_response(errors.BadRequestError(
                        "body must be a JSON object"))
                try:
                    if "add" in body:
                        return await self._ring_add(req, body["add"])
                    if "complete" in body:
                        ring = self.ring.without_override(
                            str(body["complete"]))
                        self.set_ring(ring)
                        return Response.of_json(self._ring_doc())
                    if "remove" in body:
                        ring = self.ring.with_shard_removed(
                            str(body["remove"]))
                        self.set_ring(ring)
                        return Response.of_json(self._ring_doc())
                    spec = body.get("shards", "")
                    if isinstance(spec, list):
                        spec = ",".join(
                            f"{s['name']}={s['url']}"
                            + "".join("|" + r
                                      for r in s.get("replicas", ()))
                            for s in spec)
                    parsed = ShardRing.from_spec(spec)
                    # a full republish keeps pending-migration pins whose
                    # shards survived: a shard moving addresses mid-
                    # migration must not silently flip pinned ownership
                    keep = {s.name for s in parsed.shards}
                    ring = ShardRing(
                        list(parsed.shards),
                        {c: n for c, n in self.ring.overrides.items()
                         if n in keep})
                except errors.ApiError as e:
                    return _error_response(e)
                except (ValueError, KeyError, TypeError) as e:
                    return _error_response(errors.BadRequestError(
                        f"malformed ring spec: {e}"))
                self.set_ring(ring)
                return Response.of_json(self._ring_doc())
            return _error_response(errors.BadRequestError(
                f"unsupported method {req.method} for /ring"))
        if head == "metrics":
            if req.param("fleet") in ("1", "true"):
                return await self._metrics_fleet(req)
            return Response(body=REGISTRY.expose().encode("utf-8"),
                            content_type="text/plain; version=0.0.4")
        if head == "debug" and segs[1:] == ["trace"] and (
                req.param("id") or req.param("slowest")):
            return await self._trace_scatter(req)
        try:
            if head == "version":
                return await self._version(req)
            if head == "clusters" and len(segs) == 1:
                return await self._clusters(req)
            # everything below is cluster-scoped: normalize the cluster
            # into the forwarded target so shards never see our header
            target = req.target if cluster_in_path else (
                "/clusters/" + quote(cluster, safe="*") + req.target)
            shape = self._parse_resource(segs)
            is_watch = (req.method == "GET" and shape is not None
                        and shape[4] is None
                        and req.param("watch") in ("true", "1"))
            if cluster != WILDCARD:
                idx = self.ring.owner_index(cluster)
                if is_watch:
                    return self._stream_proxy(
                        idx, target, req,
                        pool=self._replica_watch_pool(idx, req))
                if (req.method == "GET" and self._rpools[idx]
                        and shape is not None):
                    # RV-carrying reads (min-RV stamps, RV-pinned
                    # continue tokens, resourceVersion params) go to
                    # replicas too: the replica's RV barrier holds the
                    # read until its applied RV covers the pin
                    return await self._read_via_replica(idx, target, req)
                status, h, body = await self._call(
                    idx, req.method, target, req.body or None,
                    self._fwd_headers(req))
                return self._relay(status, h, body)
            return await self._wildcard(req, segs, shape, is_watch, target)
        except errors.ApiError as e:
            return _error_response(e)

    # ----------------------------------------------------------- wildcard

    async def _wildcard(self, req: Request, segs: list[str], shape,
                        is_watch: bool, target: str):
        if shape is None:
            # discovery / openapi: identical on every shard (same binary,
            # same scheme) — serve from the first reachable one
            return await self._any_shard(req, target)
        _g, _v, _ns, _res, name, _sub = shape
        headers = self._fwd_headers(req)
        if req.method == "GET" and name is None:
            if is_watch:
                return self._merged_watch(req, target)
            return await self._scatter_list(req, target)
        if req.method == "GET" and name is not None:
            _idx, (s, h, b) = await self._scatter_named(req, target)
            return self._relay(s, h, b)
        if req.method in ("POST", "PUT"):
            try:
                obj = json.loads(req.body) if req.body else None
            except ValueError as e:
                raise errors.BadRequestError(f"malformed JSON body: {e}") from e
            if not isinstance(obj, dict):
                raise errors.BadRequestError("body must be a JSON object")
            # the ONE copy of the wildcard write rule, then the ring; the
            # shard re-resolves the same rule to the same cluster
            wc = resolve_write_cluster(WILDCARD, obj, errors.BadRequestError)
            idx = self.ring.owner_index(wc)
            status, h, body = await self._call(
                idx, req.method, target, req.body, headers)
            return self._relay(status, h, body)
        if req.method == "DELETE" and name is not None:
            # resolve the unique owner with a read scatter FIRST: a
            # wildcard DELETE forwarded to every shard would delete any
            # same-named object that is unique *within* its shard even
            # when it is ambiguous across the fleet
            idx, (s, h, b) = await self._scatter_named(req, target)
            if idx < 0:
                return self._relay(s, h, b)
            status, h2, b2 = await self._call(idx, "DELETE", target, None,
                                              headers)
            return self._relay(status, h2, b2)
        raise errors.BadRequestError(
            f"unsupported method {req.method} for {req.path}")

    async def _any_shard(self, req: Request, target: str) -> Response:
        last: Exception | None = None
        for i in range(len(self.ring)):
            try:
                status, h, body = await self._call(
                    i, req.method, target, req.body or None,
                    self._fwd_headers(req))
                return self._relay(status, h, body)
            except errors.UnavailableError as e:
                last = e
        assert last is not None
        raise last

    async def _scatter_named(self, req: Request, target: str):
        """Resolve a wildcard single-object read across shards: returns
        ``(owner_index, (status, headers, body))`` with owner_index -1
        when there is no unique owner (the triple is then the honest
        error response to relay)."""
        results = await self._scatter("GET", target, self._fwd_headers(req))
        hits = [i for i, (s, _h, _b) in enumerate(results) if 200 <= s < 300]
        if len(hits) == 1:
            return hits[0], results[hits[0]]
        if len(hits) > 1:
            names = [self.ring.shards[i].name for i in hits]
            raise errors.BadRequestError(
                f"object is ambiguous across shards {names}")
        # no shard owns it: relay a shard-local ambiguity (400) over any
        # other error over the plain 404
        for s, h, b in results:
            if s == 400:
                return -1, (s, h, b)
        for s, h, b in results:
            if s != 404:
                return -1, (s, h, b)
        return -1, results[0]

    async def _scatter_list(self, req: Request, target: str) -> Response:
        if req.param("continue") or req.param("limit"):
            return await self._scatter_list_paged(req, target)
        results = await self._scatter("GET", target, self._fwd_headers(req))
        for s, h, b in results:
            if s >= 400:
                # one refusal (authz, unknown resource) refuses the merge
                return self._relay(s, h, b)
        bodies = [b for _s, _h, b in results]
        merged = self._merge_lists(bodies)
        if merged is None:
            merged = self._merge_lists_dict(bodies)
        return Response(body=merged)

    async def _scatter_list_paged(self, req: Request, target: str) -> Response:
        """KEP-365 chunking across the fleet: shards page one at a time,
        in shard order, each pinned at the RV its first-page scatter
        answered — the concatenated pages reproduce exactly what the
        unpaged byte-splice merge serves, because that merge IS the
        shards' sorted bodies in shard order. The client-facing continue
        token packs every shard's pinned RV and per-shard store token
        (:func:`_encode_router_continue`); the page envelope carries the
        vector RV, so the final page anchors watches exactly like the
        one-shot merge. A token minted against a different shard count
        answers typed 410 — re-list, never guess."""
        n = len(self.ring)
        cont = req.param("continue")
        headers = self._fwd_headers(req)
        if not cont:
            # first page: the scatter doubles as the RV-pin snapshot —
            # shard 0's page is served now, every other shard's is
            # discarded but its pinned RV seeds a from-start token
            results = await self._scatter("GET", target, headers)
            for s, h, b in results:
                if s >= 400:
                    return self._relay(s, h, b)
            rvs: list[int] = []
            parsed: list[tuple[bytes, int]] = []
            for _s, _h, body in results:
                i = body.find(_ITEMS_MARKER)
                m = _RV_RE.search(body[:i]) if i >= 0 else None
                if i < 0 or m is None or not body.endswith(b"]}"):
                    # non-standard shape (Table, legacy shard): the
                    # unpaged dict merge is the honest fallback
                    return Response(body=self._merge_lists_dict(
                        [b for _s2, _h2, b in results]))
                parsed.append((body, i))
                rvs.append(int(m.group(1)))
            toks: list[str | None] = []
            for j, (body, i) in enumerate(parsed):
                cm = _CONT_RE.search(body[:i])
                span = body[i + len(_ITEMS_MARKER):-2]
                if j == 0:
                    toks.append(cm.group(1).decode() if cm else None)
                elif cm is None and not span:
                    toks.append(None)  # provably empty at the pin
                else:
                    toks.append(encode_continue(rvs[j], None))
            return self._paged_response(parsed[0][0], rvs, toks)
        decoded = _decode_router_continue(cont, n)
        if decoded is None:
            REGISTRY.counter("list_continue_410_total",
                             "continue tokens answered with 410").inc()
            raise errors.GoneError(
                "continue token does not match this router's shard "
                "topology; re-list")
        rvs, toks = decoded
        idx = next((j for j, t in enumerate(toks) if t is not None), None)
        if idx is None:
            raise errors.GoneError("continue token is exhausted; re-list")
        status, h, body = await self._call(
            idx, "GET", _swap_continue(target, toks[idx]), None, headers)
        if status >= 400:
            # a shard's own 410 (window expired under the pin) relays:
            # the client restarts its chunked list from scratch
            return self._relay(status, h, body)
        i = body.find(_ITEMS_MARKER)
        if i < 0 or _RV_RE.search(body[:i]) is None \
                or not body.endswith(b"]}"):
            raise errors.GoneError(
                f"shard {self.ring.shards[idx].name} answered an "
                "unpageable list body; re-list")
        cm = _CONT_RE.search(body[:i])
        toks[idx] = cm.group(1).decode() if cm else None
        return self._paged_response(body, rvs, toks)

    def _paged_response(self, body: bytes, rvs: list[int],
                        toks: list) -> Response:
        """One shard's page body rewritten into the fleet envelope:
        resourceVersion becomes the vector RV; the shard's own continue
        (never meaningful to a client) is folded into — or replaced by —
        the packed router token."""
        i = body.find(_ITEMS_MARKER)
        head = body[:i + len(_ITEMS_MARKER)]
        tail = body[i + len(_ITEMS_MARKER):]
        router_tok = (_encode_router_continue(rvs, toks)
                      if any(t is not None for t in toks) else None)
        m = _RV_RE.search(head)
        assert m is not None  # caller verified
        head = (head[:m.start(1)] + str(encode_rvmap(rvs)).encode()
                + head[m.end(1):])
        m2 = _CONT_RE.search(head)
        if m2 is not None and router_tok is not None:
            head = (head[:m2.start(1)] + router_tok.encode()
                    + head[m2.end(1):])
        elif router_tok is not None:
            ins = _RV_RE.search(head).end()
            head = (head[:ins] + b', "continue": "' + router_tok.encode()
                    + b'"' + head[ins:])
        return Response(body=head + tail)

    def _merge_lists(self, bodies: list[bytes]) -> bytes | None:
        """Byte-splice shard list bodies into one: per-object bytes are
        exactly what each owning shard serialized (encode-once bytes
        relay untouched); only the envelope's resourceVersion is
        rewritten to the vector RV. None when a body isn't a standard
        list shape (Table renderings take the dict path)."""
        spans: list[bytes] = []
        rvs: list[int] = []
        head0 = None
        m0 = None
        for body in bodies:
            i = body.find(_ITEMS_MARKER)
            if i < 0 or not body.endswith(b"]}"):
                return None
            head = body[:i + len(_ITEMS_MARKER)]
            m = _RV_RE.search(head)
            if m is None:
                return None
            rvs.append(int(m.group(1)))
            if head0 is None:
                head0, m0 = head, m
            span = body[i + len(_ITEMS_MARKER):-2]
            if span:
                spans.append(span)
        assert head0 is not None and m0 is not None
        vec = str(encode_rvmap(rvs)).encode()
        head = head0[:m0.start(1)] + vec + head0[m0.end(1):]
        return head + b", ".join(spans) + b"]}"

    def _merge_lists_dict(self, bodies: list[bytes]) -> bytes:
        docs = [json.loads(b) for b in bodies]
        out = docs[0]
        key = "rows" if out.get("kind") == "Table" else "items"
        merged: list = []
        for d in docs:
            merged.extend(d.get(key) or [])
        out[key] = merged
        rvs = [int((d.get("metadata") or {}).get("resourceVersion", "0"))
               for d in docs]
        out.setdefault("metadata", {})["resourceVersion"] = str(
            encode_rvmap(rvs))
        return json.dumps(out).encode()

    # ------------------------------------------------------ server-global

    async def _version(self, req: Request) -> Response:
        body = dict(self.version_info)
        try:
            results = await self._scatter("GET", "/version",
                                          self._fwd_headers(req))
            rvs = []
            for s, _h, b in results:
                if s >= 400:
                    raise ValueError(f"shard /version answered {s}")
                rv = json.loads(b).get("resourceVersion")
                if rv is None:
                    raise ValueError("shard withheld resourceVersion")
                rvs.append(int(rv))
            body["resourceVersion"] = str(encode_rvmap(rvs))
        except (ValueError, errors.ApiError):
            # version fields stay public; the vector RV is simply omitted
            # when any shard withholds its RV or is unreachable
            pass
        return Response.of_json(body)

    async def _clusters(self, req: Request) -> Response:
        results = await self._scatter("GET", "/clusters",
                                      self._fwd_headers(req))
        for s, h, b in results:
            if s >= 400:
                return self._relay(s, h, b)
        names = sorted({c for _s, _h, b in results
                        for c in json.loads(b).get("clusters", [])})
        return Response.of_json({"clusters": names})

    async def _ring_add(self, req: Request, entry) -> Response:
        """Grow the ring by one shard (``POST /ring {"add": ...}``):
        parse the entry, enumerate the fleet's live clusters, pin every
        cluster whose HRW owner would change to its CURRENT owner (the
        pending-migration overlay), and publish the grown ring. Nothing
        moves yet: the response's ``pending`` list is the migration work
        list — sharding/migrate.py streams each cluster to the new shard
        and then posts ``{"complete": cluster}``, dropping that one pin
        (the atomic per-cluster ownership flip). New clusters created
        after the grow route straight to their HRW owners."""
        if isinstance(entry, dict):
            entry = (f"{entry['name']}={entry['url']}"
                     + "".join("|" + r for r in entry.get("replicas", ())))
        parsed = ShardRing.from_spec(str(entry))
        if len(parsed.shards) != 1:
            raise ValueError(
                f"add takes exactly one shard entry, got {len(parsed.shards)}")
        new = parsed.shards[0]
        # the cluster enumeration must cover every shard or a missed
        # cluster would flip owners without a migration (data loss):
        # _scatter already refuses on any unreachable shard
        results = await self._scatter("GET", "/clusters",
                                      self._fwd_headers(req))
        for s, h, b in results:
            if s >= 400:
                return self._relay(s, h, b)
        clusters = sorted({c for _s, _h, b in results
                           for c in json.loads(b).get("clusters", [])})
        grown_names = [s.name for s in self.ring.shards] + [new.name]
        movers = [
            c for c in clusters
            if c not in self.ring.overrides
            and owner_name(grown_names, c)
            != self.ring.shards[self.ring.owner_index(c)].name]
        ring = self.ring.with_shard_added(new, movers)
        self.set_ring(ring)
        doc = self._ring_doc()
        doc["pending"] = movers
        return Response.of_json(doc)

    # ----------------------------------------------- fleet observability

    def _obs_sources(self) -> list[tuple[str, int, ConnectionPool | None]]:
        """Every scrape/trace source behind this router: each shard's
        primary (pool None = the current primary slot) and its replicas,
        labeled ``s0`` / ``s0/replica0`` style."""
        out: list[tuple[str, int, ConnectionPool | None]] = []
        for i, shard in enumerate(self.ring.shards):
            out.append((shard.name, i, None))
            for j, pool in enumerate(self._rpools[i]):
                out.append((f"{shard.name}/replica{j}", i, pool))
        return out

    async def _fan_fetch(self, target: str, headers: dict[str, str]
                         ) -> list[tuple[str, bytes | None, str]]:
        """GET ``target`` from every source in parallel; returns
        ``(label, body-or-None, error)`` per source — failures are
        reported, never silently dropped."""
        sources = self._obs_sources()

        async def one(label: str, idx: int, pool):
            try:
                status, _h, body = await self._call(
                    idx, "GET", target, None, headers, pool=pool,
                    who=label)
            except (errors.ApiError, ConnectionError, OSError) as e:
                return (label, None, f"{type(e).__name__}: {e}")
            if status >= 400:
                return (label, None, f"HTTP {status}")
            return (label, body, "")

        return list(await asyncio.gather(
            *(one(label, idx, pool) for label, idx, pool in sources)))

    async def _metrics_fleet(self, req: Request) -> Response:
        """``GET /metrics?fleet=1``: scatter every shard's and replica's
        ``/metrics``, re-emit as one exposition with a ``shard=<label>``
        label on every sample (the router's own metrics ride as
        ``shard="router"``). A partial scatter is annotated with a
        comment per missing source and counted
        (``router_fleet_scrape_failed_total``) — the gauntlet scrapes
        one endpoint and still learns the truth."""
        results = await self._fan_fetch("/metrics", self._fwd_headers(req))
        parts: list[tuple[str, str]] = [("router", REGISTRY.expose())]
        notes: list[str] = []
        for label, body, err in results:
            if body is None:
                notes.append(f"# fleet: source {label} unreachable: {err}")
                REGISTRY.counter(
                    "router_fleet_scrape_failed_total",
                    "fleet metrics federation scrapes that could not "
                    "reach a shard or replica").inc()
            else:
                parts.append((label, body.decode("utf-8", "replace")))
        merged = _merge_expositions(parts)
        text = ("\n".join(notes) + "\n" if notes else "") + merged
        return Response(body=text.encode("utf-8"),
                        content_type="text/plain; version=0.0.4")

    async def _trace_scatter(self, req: Request) -> Response:
        """Assemble cross-process traces: scatter ``/debug/trace`` to
        every shard and replica, merge their span buffers with the
        router's own. ``?id=`` unions one trace's spans;
        ``?slowest=N`` re-ranks the union of everyone's slowest."""
        tracer = obs.TRACER
        tid = req.param("id")
        query = (f"/debug/trace?id={quote(tid)}" if tid
                 else f"/debug/trace?slowest={quote(req.param('slowest'))}")
        results = await self._fan_fetch(query, self._fwd_headers(req))
        partial = [f"{label}: {err}" for label, body, err in results
                   if body is None]
        docs = []
        for _label, body, _err in results:
            if body is None:
                continue
            try:
                docs.append(json.loads(body))
            except ValueError:
                continue
        if tid:
            spans = {(s["trace"], s["span"]): s for s in tracer.get(tid)}
            for d in docs:
                for s in d.get("spans", []):
                    spans.setdefault((s["trace"], s["span"]), s)
            out = sorted(spans.values(), key=lambda s: s["t0"])
            return Response.of_json({
                "id": tid, "proc": tracer.proc, "spans": out,
                "partial": partial})
        try:
            n = max(1, min(int(req.param("slowest") or "3"), 32))
        except ValueError:
            n = 3
        by_trace: dict[str, dict] = {}
        for t in tracer.slowest(n):
            by_trace[t["id"]] = {(s["trace"], s["span"]): s
                                 for s in t["spans"]}
        for d in docs:
            for t in d.get("traces", []):
                ent = by_trace.setdefault(t["id"], {})
                for s in t.get("spans", []):
                    ent.setdefault((s["trace"], s["span"]), s)
        ranked = []
        for t_id, spans in by_trace.items():
            vals = list(spans.values())
            t0 = min(s["t0"] for s in vals)
            t1 = max(s["t0"] + s["dur"] for s in vals)
            ranked.append({"id": t_id, "dur": round(t1 - t0, 6),
                           "spans": sorted(vals, key=lambda s: s["t0"])})
        ranked.sort(key=lambda t: -t["dur"])
        return Response.of_json({
            "proc": tracer.proc, "traces": ranked[:n], "partial": partial})

    # -------------------------------------------------------------- watch

    def _tap_watch(self, idx: int, target: str, req: Request,
                   pool: ConnectionPool | None = None) -> _TapWatch:
        if pool is None:
            pool = self._pools[idx]
        parts = urlsplit(pool.base_url)
        host = parts.hostname or "127.0.0.1"
        port = parts.port or (443 if parts.scheme == "https" else 80)
        auth = req.headers.get("authorization", "")
        token = auth[7:] if auth.lower().startswith("bearer ") else pool.token
        return _TapWatch(host, port, target, "", token=token,
                         ssl_context=pool.ssl_context)

    def _stream_proxy(self, idx: int, target: str, req: Request,
                      pool: ConnectionPool | None = None) -> StreamResponse:
        """Single-cluster watch: a ZERO-PARSE stream relay to the owning
        shard — upstream length-delimited chunks forward verbatim (size
        line + payload bytes untouched: no utf-8 decode, no line split,
        no per-event json parse — the ``_TapWatch`` parse survives only
        on merged wildcard watches, which genuinely need per-shard
        positions). Resume RVs stay shard-local and honest (the ring
        maps the cluster back to the same shard). ``pool`` targets a
        read replica for fresh watches."""
        shard = self.ring.shards[idx]
        use = pool if pool is not None else self._pools[idx]
        parts = urlsplit(use.base_url)
        host = parts.hostname or "127.0.0.1"
        port = parts.port or (443 if parts.scheme == "https" else 80)
        auth = req.headers.get("authorization", "")
        token = auth[7:] if auth.lower().startswith("bearer ") else use.token
        ssl_ctx = use.ssl_context
        tp = self._fwd_headers(req).get(obs.TRACEPARENT)

        async def produce(stream: StreamResponse) -> None:
            reader = writer = None
            try:
                try:
                    reader, writer = await asyncio.open_connection(
                        host, port, ssl=ssl_ctx,
                        server_hostname=host if ssl_ctx else None)
                except (ConnectionError, OSError) as e:
                    self._unavailable.inc()
                    await stream.send_json({
                        "type": "ERROR",
                        "object": _status_body(
                            503, "ServiceUnavailable",
                            f"shard {shard.name} unreachable: {e}")})
                    return
                lines = [f"GET {target} HTTP/1.1", f"Host: {host}"]
                if token:
                    lines.append(f"Authorization: Bearer {token}")
                if tp:
                    lines.append(f"{obs.TRACEPARENT}: {tp}")
                lines.append("Connection: close")
                writer.write(("\r\n".join(lines) + "\r\n\r\n").encode())
                await writer.drain()
                head = await reader.readuntil(b"\r\n\r\n")
                code = int(head.split(b"\r\n", 1)[0].split(b" ")[1])
                if code >= 400:
                    # the shard refused the watch: relay its Status
                    # in-stream like every other relay refusal
                    body = await reader.read(64 * 1024)
                    raw = body[body.find(b"{"):body.rfind(b"}") + 1]
                    try:
                        status = json.loads(raw)
                    except ValueError:
                        status = _status_body(
                            code, "",
                            f"shard {shard.name} refused the watch "
                            f"({code})")
                    await stream.send_json({"type": "ERROR",
                                            "object": status})
                    return
                while True:
                    size_line = await reader.readline()
                    if not size_line:
                        return  # upstream died: clean end, client resumes
                    size = int(size_line.strip() or b"0", 16)
                    if size == 0:
                        return  # upstream terminal chunk: clean end
                    payload = await reader.readexactly(size + 2)
                    self._raw_chunks.inc()
                    await stream.relay_chunk(size_line, payload)
            except (ConnectionError, asyncio.IncompleteReadError, OSError,
                    ValueError):
                return  # stream garbled or torn down mid-relay
            finally:
                if writer is not None:
                    writer.close()

        return StreamResponse(produce)

    def _watch_target(self, req: Request, target: str,
                      since_rv: int | None) -> str:
        """Rebuild a per-shard watch target: the shard's own resume RV
        replaces the client's, and shard-side bookmarks are always on —
        they feed the vector-RV position map even when the client asked
        for none."""
        path, _sep, _q = target.partition("?")
        params = {k: v[0] for k, v in req.query.items()}
        if since_rv is not None:
            params["resourceVersion"] = str(since_rv)
        else:
            params.pop("resourceVersion", None)
        params["allowWatchBookmarks"] = "true"
        return path + "?" + urlencode(params, quote_via=quote)

    def _merged_watch(self, req: Request, target: str) -> StreamResponse:
        n = len(self.ring)
        since = req.param("resourceVersion")
        want_bookmarks = req.param("allowWatchBookmarks") in ("true", "1")

        async def produce(stream: StreamResponse) -> None:
            rvs: list[int] | None = None
            if since:
                try:
                    value = int(since)
                except ValueError:
                    await stream.send_json({
                        "type": "ERROR",
                        "object": _status_body(
                            400, "BadRequest",
                            f"malformed resourceVersion {since!r}")})
                    return
                rvs = decode_rvmap(value, n)
                if rvs is None:
                    # a scalar (or foreign-ring) RV carries no per-shard
                    # positions — resuming from it would either replay or
                    # skip arbitrarily on every shard. Honest answer: 410,
                    # client re-lists and gets a vector RV.
                    await stream.send_json({
                        "type": "ERROR",
                        "object": _status_body(
                            410, "Expired",
                            f"resourceVersion {since} is not a vector RV "
                            f"for this {n}-shard ring; re-list")})
                    return
                self._resumes.inc()
            pos = list(rvs) if rvs else [0] * n
            known = [rvs is not None] * n
            q: asyncio.Queue = asyncio.Queue()
            watches: list[_TapWatch] = []
            pumps: list[asyncio.Task] = []
            try:
                for i in range(n):
                    t = self._watch_target(
                        req, target, rvs[i] if rvs else None)
                    watches.append(self._tap_watch(i, t, req))

                async def pump(i: int, w: _TapWatch) -> None:
                    while True:
                        item = await w.next()
                        await q.put((i, item))
                        if item is None:
                            return

                pumps = [asyncio.ensure_future(pump(i, w))
                         for i, w in enumerate(watches)]
                while True:
                    try:
                        i, item = await asyncio.wait_for(
                            q.get(), timeout=self.bookmark_every)
                    except asyncio.TimeoutError:
                        # idle: a vector bookmark, but only once every
                        # shard has reported an honest position — a
                        # guessed 0 would rewind a resuming client into
                        # a replay (or a 410) it never asked for
                        if want_bookmarks and all(known):
                            await stream.send_json({
                                "type": "BOOKMARK",
                                "object": {"kind": "Bookmark", "metadata": {
                                    "resourceVersion": str(encode_rvmap(pos))}},
                            })
                        continue
                    if item is None:
                        # shard stream died (process death, connection
                        # loss): merged coverage is gone — terminal 410 so
                        # the client re-lists and resumes from a fresh
                        # vector (the fault discipline: fail loudly in-stream,
                        # never silently serve a partial fleet)
                        err = watches[i].error
                        msg = f"shard {self.ring.shards[i].name} watch ended"
                        if err is not None:
                            msg += f": {getattr(err, 'message', err)}"
                        await stream.send_json({
                            "type": "ERROR",
                            "object": _status_body(410, "Expired",
                                                   msg + "; re-list required")})
                        return
                    raw, msg = item
                    mtype = msg.get("type")
                    meta = (msg.get("object") or {}).get("metadata") or {}
                    try:
                        rv = int(meta.get("resourceVersion", "0"))
                    except (TypeError, ValueError):
                        rv = 0
                    if mtype == "BOOKMARK":
                        # shard-local progress marker: absorbed into the
                        # position map, never relayed (its scalar RV
                        # would poison the client's resume)
                        if rv:
                            pos[i] = max(pos[i], rv)
                            known[i] = True
                        continue
                    if mtype == "ERROR":
                        # the shard refused or expired this stream:
                        # relay its typed Status verbatim and end — the
                        # merge cannot continue with partial coverage
                        await stream.send_raw_many([raw])
                        return
                    if rv:
                        pos[i] = max(pos[i], rv)
                        known[i] = True
                    await stream.send_raw_many([raw])
            finally:
                for p in pumps:
                    p.cancel()
                for w in watches:
                    w.close()

        return StreamResponse(produce)
