"""Smart clients: shard-aware direct routing over the rendezvous ring.

The shard ring is deliberately coordination-free — any client can compute
a cluster's owning shard from the shard list alone (the reference's
``clientutils.EnableMultiCluster`` write routing, SURVEY.md §2.3, done
client-side). ``KCP_SMART_CLIENT=1`` turns that into deleted hops: a
:class:`SmartRestClient` fetches the router's ``GET /ring`` once
(``{epoch, shards[]}``), computes the HRW owner locally
(:mod:`kcp_tpu_torch.sharding.ring`), holds per-shard pooled connections
(:class:`~kcp_tpu_torch.store.remote.ConnectionPool`), and sends
single-cluster verbs and watches **direct** to the owning shard —
wildcard and non-resource requests still go via the router.

Correctness never depends on ring freshness:

- every direct request carries ``X-Kcp-Ring-Epoch`` (the epoch the
  client's ring came from); a shard that knows the ring and does NOT
  own the target cluster answers a typed 410 carrying its own epoch;
- any 410 / 503 / connect-refused / breaker-open answer on the direct
  path triggers a (rate-limited) re-fetch of ``/ring`` **and a one-shot
  fallback through the router** — the router always routes over ITS
  current ring, so the request lands even mid-ring-change, and the next
  request goes direct over the refreshed ring;
- a base URL that serves no ``/ring`` (a monolith, a bare shard) parks
  smart mode: the client behaves exactly like a plain
  :class:`~kcp_tpu_torch.server.rest.RestClient`.

The ring document also carries the router's pending-migration
``overrides`` (cluster -> shard name): while a cluster's WAL is moving
to a new owner, the override pins it to its OLD shard, so smart clients
keep landing direct hits mid-migration and flip atomically with the
fleet the moment the router drops the pin. ``KCP_RING_REFRESH_S=N``
(default off) adds a background periodic re-fetch through the same
epoch-verified path — useful on fleets that scale out while a client
sits idle (no traffic means no 410 to trigger the reactive refresh).

Responses on the direct path are byte-identical to routed responses
(modulo hop-specific headers) — the differential fuzz in
tests/test_smartclient.py and the sha256 cross-check in
``bench.py --smartclient`` hold that line.
"""

from __future__ import annotations

import http.client
import os
import threading
import time
from urllib.parse import unquote, urlsplit

from ..analysis.sanitize import make_lock
from ..server.rest import MultiClusterRestClient, RestClient, RestWatch
from ..store.store import WILDCARD
from ..utils import errors
from ..utils.trace import REGISTRY

#: the ring-freshness handshake header: requests carry the client's ring
#: epoch; ring-mismatch 410s carry the shard's
RING_EPOCH_HEADER = "X-Kcp-Ring-Epoch"

_DIRECT = REGISTRY.counter(
    "smart_client_direct_total",
    "requests/watches a smart client served direct-to-shard (no router "
    "hop)")
_FALLBACK = REGISTRY.counter(
    "smart_client_fallback_total",
    "direct attempts that fell back through the router (connect "
    "refused, breaker open, 410 ring mismatch, 503) — each one also "
    "triggers a ring re-fetch")
_REFRESH = REGISTRY.counter(
    "smart_client_ring_refreshes_total",
    "successful GET /ring fetches (initial + staleness-triggered)")

#: direct-path triggers that mean "the ring may be stale / the shard is
#: not servable": refresh the ring and take the router hop this once.
#: 504 is a follower's RV-barrier timeout (FrontierWaitTimeout): the
#: router hop reaches the primary, which IS the frontier.
_FALLBACK_STATUSES = (410, 503, 504)


def smart_enabled() -> bool:
    """``KCP_SMART_CLIENT=1``: construction sites that honor the env
    gate (scenario workloads, benches) build smart clients."""
    return os.environ.get("KCP_SMART_CLIENT", "0").lower() in (
        "1", "true", "on")


def ring_refresh_interval() -> float:
    """``KCP_RING_REFRESH_S``: background periodic ring re-fetch cadence
    in seconds; 0 (the default) disables the refresher — the reactive
    410/503-triggered refresh is the only freshness mechanism then."""
    try:
        return max(0.0, float(os.environ.get("KCP_RING_REFRESH_S", "0")
                              or 0.0))
    except ValueError:
        return 0.0


class _RingState:
    """Ring + per-shard pools, SHARED across every ``scoped()`` clone
    of one smart client (like the discovery cache and breaker)."""

    def __init__(self, pool_cap: int | None):
        self.lock = make_lock("smart.ring")
        self.ring = None            # ShardRing | None
        self.epoch = 0
        self.pools: dict[str, object] = {}   # shard url -> ConnectionPool
        self.last_fetch = -1e9      # rate limit on /ring fetches
        self.parked_until = 0.0     # /ring unavailable: plain-client mode
        self.cap = pool_cap if pool_cap is not None else int(
            os.environ.get("KCP_ROUTER_POOL", "8"))
        self.stop = threading.Event()   # ends the background refresher


class SmartRestClient(RestClient):
    """A RestClient that goes direct to the owning shard when it can.

    Drop-in: same constructor and verb surface as RestClient against
    the ROUTER's base URL. ``scoped()`` clones share the ring state,
    the per-shard pools, and all the fallback bookkeeping.
    """

    def __init__(self, base_url: str, cluster: str = "admin",
                 scheme=None, token: str = "",
                 ca_data: bytes | str | None = None,
                 ca_file: str | None = None,
                 pool_cap: int | None = None):
        super().__init__(base_url, cluster, scheme, token=token,
                         ca_data=ca_data, ca_file=ca_file)
        self._ring_state = _RingState(pool_cap)
        interval = ring_refresh_interval()
        if interval > 0:
            # one refresher per client FAMILY (scoped() clones share the
            # ring state, so they share this thread too); it dies with
            # close() or the process (daemon)
            t = threading.Thread(
                target=self._refresh_loop, args=(interval,),
                name="smart-ring-refresh", daemon=True)
            t.start()

    def _refresh_loop(self, interval: float) -> None:
        st = self._ring_state
        while not st.stop.wait(interval):
            # forced: the cadence itself is the rate limit, and an idle
            # client never generates the 410 that would trigger the
            # reactive path; parked base URLs still short-circuit inside
            self._refresh_ring(force=True)

    # -------------------------------------------------------------- ring

    def _refresh_ring(self, force: bool = False) -> None:
        """Fetch ``GET /ring`` from the router and swap the shared ring
        state (rate-limited; concurrent refreshers coalesce). A base URL
        that refuses /ring parks smart mode for a few seconds."""
        from ..sharding.ring import Shard, ShardRing

        st = self._ring_state
        now = time.monotonic()
        with st.lock:
            # opportunistic refreshes coalesce behind a floor; a FORCED
            # refresh (a staleness signal in hand) always proceeds — its
            # caller is already paying a router hop, so one /ring GET per
            # fallback is proportional overhead, not a storm
            if not force and now < st.last_fetch + 0.25:
                return
            if now < st.parked_until:
                return
            st.last_fetch = now
        try:
            body = RestClient._request(self, "GET", "/ring") or {}
            shards = [Shard(s["name"], s["url"].rstrip("/"),
                            tuple(s.get("replicas", ())))
                      for s in body.get("shards", [])]
            # pending-migration pins ride the ring doc: owner_index()
            # keeps resolving a migrating cluster to its OLD shard until
            # the router drops the pin (the atomic per-cluster flip)
            overrides = {str(c): str(n) for c, n in
                         (body.get("overrides") or {}).items()}
            ring = ShardRing(shards, overrides) if shards else None
        except (errors.ApiError, ConnectionError, OSError, ValueError,
                KeyError, TypeError, http.client.HTTPException):
            ring = None
        if ring is None:
            # no ring here (monolith / bare shard / router mid-restart):
            # park and serve routed — plain-client behavior
            with st.lock:
                st.parked_until = now + 5.0
            return
        epoch = int(body.get("epoch", 0))
        stale: list[object] = []
        with st.lock:
            st.ring = ring
            st.epoch = epoch
            live = {s.url for s in ring.shards}
            for url in [u for u in st.pools if u not in live]:
                stale.append(st.pools.pop(url))
        for pool in stale:
            # closed pools finish in-flight borrows and close on return
            pool.close()
        _REFRESH.inc()

    def _ring_snapshot(self):
        """(ring, epoch) — fetching lazily on first use; (None, 0) when
        the base URL serves no ring."""
        st = self._ring_state
        with st.lock:
            ring, epoch = st.ring, st.epoch
        if ring is None:
            self._refresh_ring()
            with st.lock:
                ring, epoch = st.ring, st.epoch
        return ring, epoch

    def _shard_pool(self, url: str):
        from ..store.remote import ConnectionPool

        st = self._ring_state
        with st.lock:
            pool = st.pools.get(url)
            if pool is None:
                pool = st.pools[url] = ConnectionPool(
                    url, token=self.token, ca_data=self.ca_data,
                    ca_file=self.ca_file, cap=st.cap)
        return pool

    @staticmethod
    def _target_cluster(target: str) -> str | None:
        """The logical cluster a request target is scoped to, or None
        when the request is not direct-eligible (non-resource paths,
        the wildcard)."""
        path = target.partition("?")[0]
        if not path.startswith("/clusters/"):
            return None
        seg = unquote(path[len("/clusters/"):].partition("/")[0])
        if not seg or seg == WILDCARD:
            return None
        return seg

    # ---------------------------------------------------------- plumbing

    def _roundtrip(self, method: str, path: str, payload: bytes | None,
                   headers: dict[str, str]):
        """Route one round trip: direct to the HRW owner for
        single-cluster targets, via the router otherwise — with the
        one-shot router fallback on any ring-staleness signal. Every
        verb (and ``request_raw``) funnels through here, so the whole
        RestClient surface inherits smart routing."""
        cluster = self._target_cluster(path)
        if cluster is None:
            return super()._roundtrip(method, path, payload, headers)
        ring, epoch = self._ring_snapshot()
        if ring is None:
            return super()._roundtrip(method, path, payload, headers)
        shard = ring.shards[ring.owner_index(cluster)]
        pool = self._shard_pool(shard.url)
        h = dict(headers)
        h[RING_EPOCH_HEADER] = str(epoch)
        try:
            with pool.client() as c:
                status, resp, data = c._roundtrip(method, path, payload, h)
        except (errors.UnavailableError, ConnectionError, OSError,
                TimeoutError, http.client.HTTPException):
            # dead/unreachable shard (or its breaker already open): the
            # ring may have moved under us — refresh + one router hop.
            # The caller's own retry discipline is unchanged: a write
            # whose DIRECT send may have reached the shard surfaces as
            # AlreadyExists on the router retry, exactly like the
            # stale-keep-alive retry case (_roundtrip docstring).
            return self._fallback(method, path, payload, headers)
        if status in _FALLBACK_STATUSES:
            # the shard ANSWERED but refused in a way that means "not
            # me / not now": 410 = ring mismatch (the shard's epoch
            # rides the response headers), 503 = fenced/draining/
            # read-only — the router knows who serves this now
            return self._fallback(method, path, payload, headers)
        _DIRECT.inc()
        return status, resp, data

    def _fallback(self, method: str, path: str, payload: bytes | None,
                  headers: dict[str, str]):
        """The one-shot escape hatch: refresh the ring (forced,
        best-effort) and relay this request through the router."""
        self._refresh_ring(force=True)
        _FALLBACK.inc()
        return super()._roundtrip(method, path, payload, headers)

    # -------------------------------------------------------------- watch

    def watch(self, gvr, namespace: str | None = None, selector=None,
              since_rv: int | None = None,
              bookmarks: bool = True,
              initial_events: bool = False) -> RestWatch:
        """Open a watch stream DIRECT to the owning shard when the ring
        allows (carrying the epoch header); routed otherwise. A direct
        stream that dies or 410s lands in the informer's normal
        resume/relist loop — the relist runs through
        :meth:`_roundtrip`, which refreshes the ring and falls back, so
        a moved shard converges without special watch-side plumbing."""
        routed = super().watch(gvr, namespace, selector,
                               since_rv=since_rv, bookmarks=bookmarks,
                               initial_events=initial_events)
        if self.cluster == WILDCARD:
            return routed
        ring, epoch = self._ring_snapshot()
        if ring is None:
            return routed
        shard = ring.shards[ring.owner_index(self.cluster)]
        pool = self._shard_pool(shard.url)
        from ..utils.circuit import CLOSED

        if pool.breaker.state != CLOSED:
            # known-dead shard: don't burn a connect on a stream that
            # cannot establish — ride the router until the ring moves
            _FALLBACK.inc()
            return routed
        parts = urlsplit(shard.url)
        host = parts.hostname or "127.0.0.1"
        port = parts.port or (443 if parts.scheme == "https" else 80)
        _DIRECT.inc()
        return RestWatch(host, port, routed._path, routed.resource,
                         token=self.token, ssl_context=pool.ssl_context,
                         extra_headers={RING_EPOCH_HEADER: str(epoch)},
                         initial_events=initial_events,
                         session=self._session,
                         session_cluster=self.cluster)

    # ---------------------------------------------------------- lifecycle

    def close(self) -> None:
        super().close()
        st = self._ring_state
        st.stop.set()
        with st.lock:
            pools, st.pools = list(st.pools.values()), {}
            st.ring = None
        for pool in pools:
            pool.close()


class SmartMultiClusterRestClient(SmartRestClient):
    """Wildcard smart client: wildcard verbs ride the router (scatter-
    gather belongs there), ``cluster_client()`` scopes go direct."""

    def __init__(self, base_url: str, scheme=None, token: str = "",
                 ca_data: bytes | str | None = None,
                 ca_file: str | None = None,
                 pool_cap: int | None = None):
        super().__init__(base_url, WILDCARD, scheme, token=token,
                         ca_data=ca_data, ca_file=ca_file,
                         pool_cap=pool_cap)

    def cluster_client(self, cluster: str) -> "SmartRestClient":
        return self.scoped(cluster)


def rest_client(base_url: str, cluster: str = "admin", **kw) -> RestClient:
    """Factory honoring the ``KCP_SMART_CLIENT`` env gate: a smart
    client when it is set, a plain RestClient otherwise. The scenario
    workloads and benches construct through this so one env var flips a
    whole fleet of writers."""
    if smart_enabled():
        return SmartRestClient(base_url, cluster, **kw)
    return RestClient(base_url, cluster, **kw)


def multicluster_rest_client(base_url: str, **kw) -> MultiClusterRestClient:
    """Wildcard twin of :func:`rest_client`."""
    if smart_enabled():
        return SmartMultiClusterRestClient(base_url, **kw)
    return MultiClusterRestClient(base_url, **kw)
