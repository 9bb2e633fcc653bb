"""RemoteStore — serve this process against another server's storage.

The reference's ``kcp start --etcd-servers`` skips the embedded etcd and
points the apiserver at shared external storage (reference:
pkg/server/server.go:263-291), so several frontends can serve one
dataset. The analog here: a :class:`RemoteStore` implements the
:class:`~kcp_tpu_torch.store.store.LogicalStore` verb surface by delegating
every call to a *backend* kcp-tpu server over its REST API
(``kcp start --store-server https://backend:6443``). Storage semantics —
RV allocation, conflict detection, generation bumps, finalizers, watch
history windows — are enforced once, by the backend's real store; this
class is a transport, not a second implementation.

Division of labor when a frontend serves this way:
- reads/writes/watches pass through a bounded :class:`ConnectionPool`
  whose kept-alive connections are re-scoped per borrow (one socket
  serves every tenant; watches ride the ndjson stream);
- the frontend runs NO WAL and takes no snapshots (``snapshot`` is a
  no-op) — durability is the backend's;
- controllers: run them on exactly one process (usually the backend;
  start frontends with --no-install-controllers) or they will fight over
  the same objects, the same rule the reference has for running several
  kcp replicas against one etcd.

Caveat vs the in-process store: an expired watch window surfaces as a
``ConflictError`` on the first iteration of the returned watch rather
than synchronously from :meth:`watch` (the stream error arrives with the
backend's response) — informer relists handle both shapes.
"""

from __future__ import annotations

import contextlib
import os
import threading

from ..utils.errors import UnavailableError
from .selectors import LabelSelector
from .store import WILDCARD

DEFAULT_CLUSTER = "default"


class ConnectionPool:
    """Bounded pool of RestClients for ONE peer (a shard behind the
    router, a storage backend, a smart client's direct shard): each
    client owns one kept-alive connection and is not thread-safe, so
    concurrency = clients. All clients are ``scoped()`` clones of one
    prototype, which makes the per-peer circuit breaker and the
    discovery cache SHARED — a dead peer trips once and every borrowed
    client fails fast.

    ``client(cluster=...)`` is a context manager: borrow (blocking once
    every in-flight slot is taken — backpressure instead of unbounded
    sockets), use, return. Passing ``cluster`` re-scopes the borrowed
    client in place: the SAME kept-alive connection serves every
    logical-cluster scope over its lifetime (connection reuse across
    scoped clones — a frontend asked about 10k tenants holds ``cap``
    sockets, not 10k).

    ``depth`` (``KCP_ROUTER_POOL_DEPTH``, default 1) is the burst
    multiplexing knob: up to ``cap × depth`` borrows may be in flight at
    once. The first ``cap`` ride the kept-alive pooled connections;
    bursts beyond that get transient clients whose connections close on
    return — bounded socket growth under fan-out spikes instead of a
    30 s borrow stall. ``depth=1`` is exactly the legacy blocking pool."""

    def __init__(self, base_url: str, token: str = "",
                 ca_data: bytes | str | None = None,
                 ca_file: str | None = None, cap: int = 8,
                 cluster: str = WILDCARD, depth: int | None = None):
        # deferred import: store/ must not import server/ at module load
        from ..server.rest import RestClient

        self._proto = RestClient(base_url, cluster=cluster, token=token,
                                 ca_data=ca_data, ca_file=ca_file)
        self._cap = max(1, cap)
        if depth is None:
            depth = int(os.environ.get("KCP_ROUTER_POOL_DEPTH", "1") or "1")
        self._depth = max(1, depth)
        self._max_inflight = self._cap * self._depth
        self._cond = threading.Condition()
        self._free = [self._proto]
        self._total = 1          # pooled (kept-alive) clients created
        self._inflight = 0       # borrows currently outstanding
        self._closed = False
        self.base_url = base_url

    @property
    def breaker(self):
        """The peer's shared circuit breaker (one per pool)."""
        return self._proto._breaker

    @property
    def ssl_context(self):
        return self._proto._ssl

    @property
    def token(self) -> str:
        return self._proto.token

    @contextlib.contextmanager
    def client(self, cluster: str | None = None):
        transient = False
        with self._cond:
            if self._closed:
                # a retired/closed pool must not mint fresh sockets —
                # typed so the router's fail-fast path and the smart
                # client's fallback both handle it like a dead peer
                raise UnavailableError(
                    f"connection pool for {self.base_url} is closed")
            while (not self._free and self._total >= self._cap
                   and self._inflight >= self._max_inflight):
                if not self._cond.wait(timeout=30):
                    raise TimeoutError(
                        f"connection pool for {self.base_url} exhausted "
                        f"({self._max_inflight} borrows all in flight "
                        f"for 30s)")
            if self._free:
                c = self._free.pop()
            elif self._total < self._cap:
                c = self._proto.scoped(self._proto.cluster)
                self._total += 1
            else:
                # burst beyond the kept-alive core (depth > 1): a
                # transient clone — same breaker/discovery, its own
                # connection, closed on return
                c = self._proto.scoped(self._proto.cluster)
                transient = True
            self._inflight += 1
        if cluster is not None and c.cluster != cluster:
            # connection reuse across scoped clones: re-scope in place —
            # the borrow is exclusive, so mutating the clone is safe
            c.cluster = cluster
        try:
            yield c
        finally:
            with self._cond:
                self._inflight -= 1
                if self._closed or transient:
                    c.close()
                else:
                    self._free.append(c)
                self._cond.notify()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            free, self._free = self._free, []
            self._cond.notify_all()
        for c in free:
            c.close()


class RemoteStore:
    """LogicalStore-surface adapter over a backend server's REST API."""

    # handler capability flag: verbs are blocking network I/O (offload
    # from the serving loop) and the backend resolves wildcard reads
    # itself (skip the local tenant scan)
    is_remote = True

    def __init__(self, base_url: str, token: str = "",
                 ca_data: bytes | str | None = None,
                 ca_file: str | None = None):
        # Callers run verbs from a thread pool (the handler's store-I/O
        # executor), but each RestClient owns ONE kept-alive connection
        # and is not thread-safe — so verbs borrow from a bounded
        # ConnectionPool and re-scope the borrowed client to the target
        # cluster in place. One connection serves EVERY tenant scope
        # over its lifetime (the pre-PR 13 shape held a kept-alive
        # socket per tenant in a 256-entry LRU; a frontend asked about
        # 10k tenants now holds `cap` sockets, period). The discovery
        # cache and the per-peer circuit breaker are shared across the
        # pool's clones by RestClient.scoped's own contract.
        self._pool = ConnectionPool(
            base_url, token=token, ca_data=ca_data, ca_file=ca_file,
            cap=int(os.environ.get("KCP_ROUTER_POOL", "8") or "8"),
            cluster=WILDCARD)
        self.base_url = base_url
        # LogicalStore duck-type attributes the handler/client read
        self.openapi_doc: dict | None = None
        self.namespace_lifecycle = False  # backend stamps finalizers

    # ---------------------------------------------------------- plumbing

    def _call(self, cluster: str, verb: str, *args, **kwargs):
        with self._pool.client(cluster) as c:
            return getattr(c, verb)(*args, **kwargs)

    # ------------------------------------------------------------- verbs

    def create(self, resource: str, cluster: str, obj: dict,
               namespace: str = "") -> dict:
        return self._call(cluster, "create", resource, obj, namespace)

    def get(self, resource: str, cluster: str, name: str,
            namespace: str = "") -> dict:
        return self._call(cluster, "get", resource, name, namespace)

    def update(self, resource: str, cluster: str, obj: dict,
               namespace: str = "", subresource: str | None = None) -> dict:
        if subresource == "status":
            return self._call(cluster, "update_status", resource, obj, namespace)
        if subresource is not None:
            raise ValueError(f"unknown subresource {subresource!r}")
        return self._call(cluster, "update", resource, obj, namespace)

    def update_status(self, resource: str, cluster: str, obj: dict,
                      namespace: str = "") -> dict:
        return self.update(resource, cluster, obj, namespace,
                           subresource="status")

    def delete(self, resource: str, cluster: str, name: str,
               namespace: str = "") -> None:
        with self._pool.client(cluster) as client:
            if cluster == WILDCARD:
                # RestClient refuses wildcard deletes (an in-process
                # store needs an explicit tenant), but here the backend's
                # handler resolves '*' to the unique owner exactly as a
                # frontend would have — forward it
                client._request(
                    "DELETE",
                    client._path(resource, namespace, name, cluster=cluster))
                return
            client.delete(resource, name, namespace, cluster=cluster)

    def list(self, resource: str, cluster: str = WILDCARD,
             namespace: str | None = None,
             selector: LabelSelector | None = None) -> tuple[list[dict], int]:
        return self._call(cluster, "list", resource, namespace, selector)

    def watch(self, resource: str, cluster: str = WILDCARD,
              namespace: str | None = None,
              selector: LabelSelector | None = None,
              since_rv: int | None = None):
        # watch construction may refresh discovery (a blocking request)
        # before returning the lazily-connecting RestWatch, so it holds
        # the cluster lock like any other verb
        return self._call(cluster, "watch", resource, namespace, selector,
                          since_rv=since_rv)

    # --------------------------------------------------------- inventory

    @property
    def resource_version(self) -> int:
        with self._pool.client(WILDCARD) as client:
            body = client._request("GET", "/version")
        if "resourceVersion" not in body:
            # an authz'd backend withholds the RV from tokens lacking the
            # server-global read — returning 0 here would poison watch
            # bookmarks with a rewind-to-zero, so fail loudly instead
            raise RuntimeError(
                "storage backend withheld resourceVersion from /version — "
                "the --store-token needs the server-global (wildcard get "
                "debug) read that /clusters and /debug carry")
        return int(body["resourceVersion"])

    def resources(self) -> list[str]:
        return self._call(WILDCARD, "resources")

    def clusters(self) -> list[str]:
        with self._pool.client(WILDCARD) as client:
            body = client._request("GET", "/clusters")
        return list(body.get("clusters", []))

    def __len__(self) -> int:
        # only inventory surfaces (kcp snapshot) use this; a wildcard
        # list per resource is acceptable there and wrong to cache
        return sum(len(self.list(r)[0]) for r in self.resources())

    # ---------------------------------------------------------- lifecycle

    def snapshot(self) -> None:
        """No-op: durability belongs to the backend's store."""

    def close(self) -> None:
        self._pool.close()
