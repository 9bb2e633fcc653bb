"""REST request routing: Kubernetes-style paths over the LogicalStore.

Implements the HTTP surface of the reference's minimal apiserver
(reference: pkg/server/server.go:145 CreateServerChain serves the generic
control plane at :6443) with the fork's logical-cluster semantics:

- ``/clusters/<name>`` path prefix or ``X-Kubernetes-Cluster`` header
  selects the tenant; ``*`` reads across all tenants
  (reference: server.go:164; docs/investigations/logical-clusters.md:70-74)
- writes against the wildcard route to the logical cluster named in
  ``metadata.clusterName`` — the fork's multi-cluster write routing
  (reference call site: clientutils.EnableMultiCluster, server.go:230)
- discovery (``/api``, ``/apis``, per-group resource lists), CRUD,
  ``/status`` subresource, and ``?watch=true`` chunked event streams with
  ``labelSelector`` / ``resourceVersion`` parameters.
"""

from __future__ import annotations

import asyncio
import functools
import json
import os
import time

from .. import obs
from ..admission.chain import NOOP_TICKET
from ..apis.scheme import GVR, ResourceInfo, Scheme
from ..store.selectors import parse_selector
from ..store.store import INITIAL_EVENTS_END, WILDCARD, LogicalStore
from ..utils import errors
from ..utils.routing import resolve_write_cluster
from ..utils.trace import REGISTRY
from .httpd import FlushCoalescer, Request, Response, StreamResponse

DEFAULT_CLUSTER = "admin"
CLUSTER_HEADER = "x-kubernetes-cluster"


class _SlowWatcher(Exception):
    """A watch stream fell past KCP_WATCH_BUFFER_MAX on its socket: the
    coalescer refused further buffering and the producer must end the
    stream with a terminal typed 410 (the informer relists and resumes
    — bounded memory beats an unbounded goodbye)."""


def _status_body(code: int, reason: str, message: str) -> dict:
    return {
        "kind": "Status",
        "apiVersion": "v1",
        "status": "Failure" if code >= 400 else "Success",
        "reason": reason,
        "message": message,
        "code": code,
    }


def _error_response(err: errors.ApiError) -> Response:
    body = _status_body(err.code, err.reason, err.message)
    headers: dict[str, str] = {}
    retry_after = getattr(err, "retry_after", None)
    if retry_after is not None:
        # flow-control rejection (429): the pacing hint rides both the
        # HTTP header (for generic clients) and the Status details (for
        # RestClient, which only parses the body on watch streams)
        import math

        seconds = max(1, int(math.ceil(float(retry_after))))
        body["details"] = {"retryAfterSeconds": seconds}
        headers["Retry-After"] = str(seconds)
    resp = Response.of_json(body, err.code)
    resp.headers.update(headers)
    return resp


class RestHandler:
    """Routes parsed HTTP requests onto a LogicalStore + Scheme."""

    def __init__(self, store: LogicalStore, scheme: Scheme,
                 version_info: dict | None = None,
                 authenticator=None, authorizer=None,
                 admission="auto"):
        self.store = store
        self.scheme = scheme
        self.authenticator = authenticator
        self.authorizer = authorizer  # None = authz off (open prototype mode)
        # admission & flow control between authz and the store verbs
        # (admission/): "auto" builds the default chain (defaulting →
        # validation → quota, env-configured flow control) unless
        # KCP_ADMISSION=0; None disables; an AdmissionChain is used as-is
        if admission == "auto":
            from ..admission import build_chain

            admission = build_chain(store)
        self.admission = admission or None
        self.version_info = version_info or {"major": "0", "minor": "1",
                                             "gitVersion": "kcp-tpu-v0.1.0"}
        # /readyz gate: flipped by Server once post-start hooks complete
        # (reference: the apiserver's readiness reflects post-start hooks,
        # server.go:179-256)
        self.ready = False
        # external-storage frontends: every store verb is a blocking HTTP
        # round trip to the backend, so it must not run on the serving
        # loop (one slow backend call would freeze every request, watch
        # stream, and health probe). A small pool bounds concurrency;
        # in-process stores stay inline (in-memory, and the race guard
        # expects loop-thread affinity).
        self._remote = getattr(store, "is_remote", False)
        self._store_pool = None
        if self._remote:
            from concurrent.futures import ThreadPoolExecutor

            self._store_pool = ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="store-io")
        # encode-once serving (KCP_ENCODE_CACHE, in-process CoW stores
        # only): list responses splice cached item bytes, single GETs
        # splice the cached body, and the watch relay threads pre-encoded
        # event lines — remote-store frontends re-serialize what the
        # backend sent, so they keep the dict path.
        self._encode = (not self._remote
                        and bool(getattr(store, "encode_cache_enabled", False))
                        and callable(getattr(store, "encode_many", None))
                        and callable(getattr(store, "encode_events", None)))
        self._spans = callable(getattr(store, "list_encoded", None))
        self._enc_seconds = REGISTRY.histogram(
            "response_encode_seconds",
            "time serializing one list/get/watch-batch response body")
        # RV-keyed list-body cache: the store RV increments on every
        # mutation, so (query shape, rv) fully determines a list
        # response's bytes — informer relists and polling dashboards
        # repeat identical list queries against an unchanged store, and
        # those hits skip even the byte-splice. Small FIFO (bodies can
        # be tens of MB at 100k objects); bypassed while a KCP_FAULTS
        # schedule is active so encode.cache drops always reach the
        # per-record cache underneath.
        # entries are (rv, body spans, total bytes): the spans splice
        # straight into Response.spans so even a cache hit never pays a
        # whole-body join while the scatter wire path is on
        self._list_cache: dict[tuple, tuple[int, tuple[bytes, ...], int]] = {}
        self._list_cache_max = 8
        # HA replication (kcp_tpu_torch/replication/): the Server wires these.
        # repl_hub — primary-side WAL shipper (feed + acks + fencing);
        # repl_applier — follower-side applier (replica/standby roles);
        # repl_role — what /replication/status reports;
        # repl_lag_max — replicas refuse reads 503 past this lag
        # (KCP_REPL_LAG_MAX; 0 = serve any staleness, RV-honestly).
        self.repl_hub = None
        self.repl_applier = None
        self.repl_role = "primary"
        self.repl_lag_max = 0
        # KEP-2340 consistent reads: replica-side RV-barrier telemetry
        self._consistent_waits = REGISTRY.counter(
            "consistent_read_waits_total",
            "replica reads that parked on the RV barrier because "
            "applied_rv was behind the required RV")
        self._consistent_timeouts = REGISTRY.counter(
            "consistent_read_timeouts_total",
            "RV-barrier reads that hit KCP_CONSISTENT_READ_TIMEOUT_MS "
            "and answered the typed 504 (callers fall back to the "
            "primary)")
        self._consistent_wait_seconds = REGISTRY.histogram(
            "consistent_read_wait_seconds",
            "time an RV-barrier read waited for this follower to apply "
            "its required RV")
        # group-commit admission batching: commit-window future -> the
        # enrolled writes' (quota reservation, after-hook) pairs; settled
        # in ONE ledger pass when the window resolves (_settle_adm_window)
        self._adm_windows: dict = {}
        # graceful drain (Server.drain): once set, every live watch
        # producer flushes its buffered events, sends a terminal
        # in-stream Status, and returns — the half of "no watcher is
        # abandoned mid-stream" that the HTTP layer cannot do alone
        self.draining = asyncio.Event()
        # epoch fence (POST /replication/fence): a fenced store can never
        # deliver another watch event, so live watch producers end with
        # the SAME terminal Status as drain (resumable from last_rv) and
        # consumers re-resolve onto the promoted primary instead of
        # idling on a sealed store forever. Separate from ``draining``
        # because a fenced server keeps serving: /replication/status must
        # answer probes/audits and writes must reach the store's own
        # fenced refusal (repl_fenced_writes_total)
        self.watch_fence = asyncio.Event()
        # watcher-scale serving (KCP_WATCH_COALESCE, default on): one
        # shared flush coalescer gathers every watch stream's encode-once
        # lines and writes each socket once per coalescing tick —
        # O(sockets) buffered writes of shared bytes per tick instead of
        # a write+drain round trip per watcher per event batch. =0 keeps
        # the per-batch send_raw_many path for A/B (bench.py --watchers).
        self._coalescer = None
        if os.environ.get("KCP_WATCH_COALESCE", "1").lower() not in (
                "0", "false", "off"):
            self._coalescer = FlushCoalescer(
                tick_s=float(os.environ.get("KCP_WATCH_FLUSH_MS", "2"))
                / 1000.0,
                buffer_max=int(os.environ.get(
                    "KCP_WATCH_BUFFER_MAX", str(2 * 1024 * 1024))))
        # per-server bookmark cadence (KCP_WATCH_BOOKMARK_S): how often
        # an idle stream that asked for bookmarks gets a progress marker
        # at the store RV — what keeps a quiet informer's resume point
        # inside the watch window across stream drops
        self._bookmark_every = float(
            os.environ.get("KCP_WATCH_BOOKMARK_S", "5"))
        # smart-client ring identity (Server wires these from
        # --shard-name/--ring-names): when set, a direct request that
        # stamps X-Kcp-Ring-Epoch is verified against HRW ownership — a
        # client holding a stale ring gets a typed 410 (refresh /ring)
        # instead of a silently-wrong shard's answer. Routed traffic
        # (no stamp) is untouched.
        self.shard_name = ""
        self.ring_names: tuple[str, ...] = ()
        self.ring_epoch = 0
        # per-cluster pending-migration overlay (cluster -> owning shard
        # NAME): while a cluster migrates, the router pins it to its old
        # owner and fans the pinned map out here (POST /ring) so direct
        # verification agrees with routing mid-move.
        self.ring_overrides: dict[str, str] = {}

    async def _st(self, fn, *args, **kwargs):
        """Run a store call; offloaded to the I/O pool for remote stores."""
        if self._store_pool is None:
            return fn(*args, **kwargs)
        return await asyncio.get_running_loop().run_in_executor(
            self._store_pool, functools.partial(fn, *args, **kwargs))

    def _forbidden(self, req, action: str) -> Response:
        user = self.authenticator.user_for(req.headers)
        return Response.of_json(
            _status_body(403, "Forbidden", f'user "{user}" cannot {action}'),
            403)

    def close(self) -> None:
        """Release handler resources (the store-I/O pool's threads)."""
        if self._store_pool is not None:
            self._store_pool.shutdown(wait=False, cancel_futures=True)

    async def _server_scope_allowed(self, req) -> bool:
        """True when the caller may read server-global (cross-tenant)
        state — /debug, /clusters, the RV in /version share this one
        gate. Always true in open mode; the authz check itself goes
        through :meth:`_st` because on a remote-store frontend the
        Authorizer reads roles/bindings through the remote store."""
        if self.authorizer is None:
            return True
        user = self.authenticator.user_for(req.headers)
        return await self._st(
            self.authorizer.allowed, user, WILDCARD, "get", "", "debug")

    # ------------------------------------------------------------- routing

    async def __call__(self, req: Request) -> Response | StreamResponse:
        """Serve one request under a trace context (kcp_tpu_torch/obs/): the
        incoming ``traceparent`` is honored, otherwise a root is minted
        (head-sampled); the span records only when sampled — except
        SLO-breaching requests (> KCP_TRACE_SLO_MS), which force-record
        so a latency regression always comes with its own explanation.
        Under ``KCP_TRACE=0`` this wrapper is one attribute read."""
        tracer = obs.TRACER
        if not tracer.enabled:
            return await self._handle(req)
        tp = req.headers.get(obs.TRACEPARENT)
        if tp is None and not tracer.head_sampled():
            # the overwhelmingly common case — untraced arrival, coin
            # says no: one header probe, one coin draw, two clock reads;
            # the SLO check still upgrades a slow request afterwards
            t0 = time.time()
            resp = await self._handle(req)
            dur = time.time() - t0
            if dur >= tracer.slo_s:
                self._slo_span(None, req, resp, t0, dur)
            return resp
        ctx = tracer.from_headers(req.headers) if tp else \
            tracer.mint(sampled=True)
        if ctx is None or not ctx.sampled:
            # propagated-but-unsampled (or malformed) header: same
            # unsampled path, but an SLO breach keeps the caller's trace
            t0 = time.time()
            resp = await self._handle(req)
            dur = time.time() - t0
            if dur >= tracer.slo_s:
                self._slo_span(ctx, req, resp, t0, dur)
            return resp
        sub = tracer.child(ctx)
        token = obs.set_current(sub)
        t0 = time.time()
        status = 500
        try:
            resp = await self._handle(req)
            status = getattr(resp, "status", 200)
            return resp
        finally:
            obs.reset_current(token)
            dur = time.time() - t0
            attrs = {"method": req.method, "path": req.path,
                     "status": status}
            if dur >= tracer.slo_s:
                attrs["slo_breach"] = True
            obs.record_span("server.request", sub, ctx.span_id, t0,
                            dur, attrs)

    @staticmethod
    def _slo_span(ctx, req: Request, resp, t0: float, dur: float) -> None:
        """Force-record the serving span of an SLO-breaching request
        that head sampling skipped — a latency regression always ships
        with its own explanation."""
        tracer = obs.TRACER
        base = ctx or tracer.mint(sampled=False)
        if base is None:
            return
        obs.record_span(
            "server.request", tracer.child(base), base.span_id, t0, dur,
            {"method": req.method, "path": req.path,
             "status": getattr(resp, "status", 200), "slo_breach": True},
            force=True)

    async def _handle(self, req: Request) -> Response | StreamResponse:
        if self.draining.is_set():
            # graceful drain: in-flight requests were waited out BEFORE
            # the flag flipped; anything arriving now (a request that
            # raced the listener close on a kept-alive connection) must
            # not commit AFTER the watchers' final flush — refuse 503 so
            # the client retries against a live endpoint. Without this,
            # a write landing post-flush is a WAL record no stream ever
            # carried: the restarted server's history starts past it and
            # honest resumes answer 410 (a real lost-event window).
            return _error_response(errors.UnavailableError(
                "server is draining; retry against a live endpoint"))
        segs = [s for s in req.path.split("/") if s]
        cluster = req.headers.get(CLUSTER_HEADER, DEFAULT_CLUSTER)
        if len(segs) >= 2 and segs[0] == "clusters":
            cluster = segs[1]
            segs = segs[2:]
        if (self.shard_name and self.ring_names and cluster != WILDCARD
                and "x-kcp-ring-epoch" in req.headers):
            # a smart client came DIRECT with its ring stamp: verify HRW
            # ownership (names alone determine it — URLs never enter the
            # hash). A stale ring answers a typed 410 carrying OUR epoch;
            # the client re-fetches /ring and takes one router hop.
            from ..sharding.ring import owner_name

            owner = self.ring_overrides.get(cluster) or owner_name(
                self.ring_names, cluster)
            if owner != self.shard_name:
                resp = _error_response(errors.GoneError(
                    f"ring mismatch: cluster {cluster!r} is owned by "
                    f"shard {owner!r}, not {self.shard_name!r} — "
                    f"re-fetch /ring and retry"))
                resp.headers["X-Kcp-Ring-Epoch"] = str(self.ring_epoch)
                return resp
        if not segs:
            return Response.of_json({"paths": ["/api", "/apis", "/healthz", "/version"]})
        head = segs[0]
        if head == "healthz" or head == "livez":
            return Response(body=b"ok", content_type="text/plain")
        if head == "readyz":
            if self.ready:
                return Response(body=b"ok", content_type="text/plain")
            return Response(status=500, body=b"not ready", content_type="text/plain")
        if head == "version":
            # resourceVersion rides along so a storage-frontend peer
            # (store/remote.py) can probe the store's current RV with one
            # cheap GET instead of listing anything. The RV is global
            # (cross-tenant) state, so with authz on it is only included
            # for callers holding the same wildcard read /debug carries —
            # the version fields themselves stay public, as on the real
            # apiserver.
            body = dict(self.version_info)
            if await self._server_scope_allowed(req):
                try:
                    body["resourceVersion"] = str(
                        await self._st(lambda: self.store.resource_version))
                except RuntimeError:
                    # remote-store frontend whose backend withholds the RV
                    # (insufficient --store-token): the version fields
                    # stay public and the RV is simply omitted, exactly
                    # as the backend itself responds to that token. Peer
                    # RV probes still fail loudly (missing key).
                    pass
            return Response.of_json(body)
        if head == "clusters" and len(segs) == 1:
            # index of live logical clusters (the store's tenant set) —
            # used by wildcard single-object reads on storage frontends.
            # The tenant list is exactly what per-tenant RBAC is meant to
            # hide, so it is gated like /debug (server-global read).
            if not await self._server_scope_allowed(req):
                return self._forbidden(req, "list clusters")
            return Response.of_json(
                {"clusters": await self._st(self.store.clusters)})
        if head == "metrics":
            from ..utils.trace import REGISTRY

            return Response(body=REGISTRY.expose().encode("utf-8"),
                            content_type="text/plain; version=0.0.4")
        if head == "debug" and segs[1:] == ["profile"]:
            # the /debug/pprof analog (reference pkg/server/server.go:145
            # inherits it from the apiserver chain): sampling wall profile
            # + asyncio task dump + span histograms. Server-global, so
            # with authz on it is gated like cross-tenant reads (root
            # cluster-admin), matching pprof-on-the-secure-port semantics.
            if not await self._server_scope_allowed(req):
                return self._forbidden(req, "read /debug/profile")
            from ..utils.trace import sample_profile

            try:
                seconds = float(req.param("seconds", "2.0"))
            except (TypeError, ValueError):
                seconds = 2.0
            return Response.of_json(await sample_profile(seconds))
        if head == "debug" and segs[1:] == ["trace"]:
            # distributed-trace queries (?id= / ?slowest=N) serve this
            # process's span ring buffer; without either param, an
            # on-demand torch.profiler trace (a Chrome trace file).
            # Same server-global gate either way.
            if not await self._server_scope_allowed(req):
                return self._forbidden(req, "trace")
            if req.param("id") or req.param("slowest"):
                return self._trace_query(req)
            import tempfile

            from ..utils.trace import TRACE_FILE, device_trace

            try:
                seconds = min(float(req.param("seconds", "2.0")), 30.0)
            except (TypeError, ValueError):
                seconds = 2.0
            log_dir = req.param("dir") or tempfile.mkdtemp(
                prefix="kcp-device-trace-")
            # the profiler's start-up and the file's export run off the
            # loop; the session records the loop's own CPU ops
            timings: dict = {}
            async with device_trace(log_dir, timings) as started:
                await asyncio.sleep(seconds)
            trace = os.path.join(log_dir, TRACE_FILE)
            written = started and os.path.exists(trace)
            body = {"dir": log_dir, "seconds": seconds,
                    "started": bool(started), "timings_s": timings}
            if written:
                body["trace"] = trace
                body["hint"] = "open the Chrome trace in Perfetto or chrome://tracing"
            else:
                body["message"] = ("the profiler did not start (another "
                                   "profiler session may be active); see "
                                   "the server log" if not started else
                                   "the trace was not written; see the "
                                   "server log")
            return Response.of_json(body, status=200 if written else 503)
        if head == "replication":
            return await self._replication(req, segs[1:])
        if head == "migration":
            return await self._migration(req, segs[1:])
        if head == "ring" and req.method == "POST" and self.shard_name:
            return await self._ring_install(req)
        if head == "api":
            return await self._route_group(req, cluster, group="", segs=segs[1:])
        if head == "apis":
            return await self._route_apis(req, cluster, segs[1:])
        if head == "openapi" and segs[1:] == ["v2"]:
            # the document discloses the cluster's CRD schemas — gate it
            # exactly like listing CRDs in that cluster
            if self.authorizer is not None:
                user = self.authenticator.user_for(req.headers)
                if not await self._st(
                        self.authorizer.allowed, user, cluster, "list",
                        "apiextensions.k8s.io", "customresourcedefinitions"):
                    return Response.of_json(
                        _status_body(403, "Forbidden",
                                     f'user "{user}" cannot read the openapi '
                                     f'document of logical cluster "{cluster}"'),
                        403)
            return Response.of_json(await self._st(self._openapi_v2, cluster))
        return _error_response(errors.NotFoundError(f"unknown path {req.path}"))

    async def _route_apis(self, req: Request, cluster: str, segs: list[str]):
        if not segs:
            groups = []
            for group, versions in sorted(self.scheme.group_versions().items()):
                if not group:
                    continue
                vs = sorted(versions)
                groups.append({
                    "name": group,
                    "versions": [{"groupVersion": f"{group}/{v}", "version": v} for v in vs],
                    "preferredVersion": {"groupVersion": f"{group}/{vs[0]}", "version": vs[0]},
                })
            return Response.of_json({"kind": "APIGroupList", "apiVersion": "v1",
                                     "groups": groups})
        group, segs = segs[0], segs[1:]
        return await self._route_group(req, cluster, group, segs)

    async def _route_group(self, req: Request, cluster: str, group: str, segs: list[str]):
        if not segs:
            if group == "":
                return Response.of_json({"kind": "APIVersions", "versions": ["v1"]})
            versions = sorted(self.scheme.group_versions().get(group, ()))
            if not versions:
                return _error_response(errors.NotFoundError(f"unknown group {group}"))
            return Response.of_json({
                "kind": "APIGroup", "apiVersion": "v1", "name": group,
                "versions": [{"groupVersion": f"{group}/{v}", "version": v} for v in versions],
            })
        version, segs = segs[0], segs[1:]
        if not segs:
            return self._discovery(group, version)

        # path shapes (after group/version):
        #   <resource>[/<name>[/status]]                      cluster-scoped
        #   namespaces/<ns>/<resource>[/<name>[/status]]      namespaced
        namespace = ""
        if segs[0] == "namespaces" and len(segs) >= 3:
            namespace = segs[1]
            segs = segs[2:]
        resource, segs = segs[0], segs[1:]
        name = segs[0] if segs else None
        subresource = segs[1] if len(segs) > 1 else None
        if len(segs) > 2 or subresource not in (None, "status"):
            return _error_response(errors.NotFoundError(f"unknown path {req.path}"))

        info = self._resolve(group, version, resource)
        if info is None:
            return _error_response(
                errors.NotFoundError(f"the server could not find the requested "
                                     f"resource {resource} in {group}/{version}"))
        if self.authorizer is not None:
            from .authz import verb_for

            user = self.authenticator.user_for(req.headers)
            # ?watch=true is only served as a watch on collection GETs
            # (named GETs fall through to a plain get below) — authorize
            # the operation that will actually run
            is_watch = name is None and req.param("watch") in ("true", "1")
            verb = verb_for(req.method, name is not None, is_watch)
            if not await self._st(self.authorizer.allowed, user, cluster,
                                  verb, group, resource):
                return Response.of_json(
                    _status_body(403, "Forbidden",
                                 f'user "{user}" cannot {verb} {resource} '
                                 f'in logical cluster "{cluster}"'), 403)
            if (verb in ("create", "update", "patch")
                    and group == "rbac.authorization.k8s.io"
                    and resource in ("clusterroles", "clusterrolebindings")):
                # RBAC writes additionally pass Kubernetes' escalation
                # check: you cannot grant what you do not hold
                try:
                    body = req.json()
                except ValueError:
                    body = None
                if not isinstance(body, dict):
                    # malformed bodies fall through to _serve_resource's
                    # 400; the check itself must not crash on them
                    body = None
                denial = await self._st(
                    self.authorizer.escalation_denied,
                    user, cluster, resource, body)
                if denial:
                    return Response.of_json(
                        _status_body(403, "Forbidden", denial), 403)
        try:
            return await self._serve_resource(req, cluster, info, namespace, name, subresource)
        except errors.ApiError as e:
            return _error_response(e)

    @staticmethod
    def _trace_query(req: Request) -> Response:
        """Serve this process's span ring buffer: ``?id=<trace>`` returns
        one trace's spans, ``?slowest=N`` the N slowest buffered traces.
        The router scatter-gathers this endpoint across shards to
        assemble cross-process trees."""
        tracer = obs.TRACER
        tid = req.param("id")
        if tid:
            return Response.of_json({
                "id": tid, "proc": tracer.proc, "spans": tracer.get(tid)})
        try:
            n = max(1, min(int(req.param("slowest") or "3"), 32))
        except ValueError:
            n = 3
        return Response.of_json({
            "proc": tracer.proc, "traces": tracer.slowest(n)})

    def _openapi_v2(self, cluster: str) -> dict:
        """Serve the cluster's swagger document: an attached
        ``store.openapi_doc`` wins (the fake physical cluster's discovery
        fixture); otherwise it is synthesized from the cluster's CRDs
        (:func:`kcp_tpu_torch.crdpuller.openapi.doc_from_crds`)."""
        from ..apis import crd as crdapi
        from ..crdpuller.openapi import doc_from_crds

        if self.store.openapi_doc is not None:
            return self.store.openapi_doc
        try:
            crds, _ = self.store.list(crdapi.CRDS.storage_name, cluster)
        except errors.ApiError:
            crds = []
        return doc_from_crds(crds)

    def _resolve(self, group: str, version: str, resource: str) -> ResourceInfo | None:
        info = self.scheme.by_resource(GVR(group, version, resource).storage_name)
        if info is not None and info.gvr.version != version:
            return None
        return info

    def _discovery(self, group: str, version: str) -> Response:
        resources = []
        for info in self.scheme.all():
            if info.gvr.group != group or info.gvr.version != version:
                continue
            resources.append({
                "name": info.gvr.resource, "singularName": info.singular,
                "kind": info.kind, "namespaced": info.namespaced,
                "verbs": ["create", "delete", "get", "list", "update", "watch"],
            })
            if info.has_status:
                resources.append({
                    "name": f"{info.gvr.resource}/status", "singularName": "",
                    "kind": info.kind, "namespaced": info.namespaced,
                    "verbs": ["get", "update"],
                })
        if not resources:
            return _error_response(errors.NotFoundError(f"unknown group/version {group}/{version}"))
        gv = f"{group}/{version}" if group else version
        return Response.of_json({"kind": "APIResourceList", "apiVersion": "v1",
                                 "groupVersion": gv, "resources": resources})

    # ---------------------------------------------------------- resources

    async def _serve_resource(self, req: Request, cluster: str, info: ResourceInfo,
                              namespace: str, name: str | None, subresource: str | None):
        res = info.gvr.storage_name
        gv = f"{info.gvr.group}/{info.gvr.version}" if info.gvr.group else info.gvr.version

        if subresource == "status" and req.method not in ("GET", "PUT"):
            # discovery advertises get+update only; a DELETE here must not
            # silently remove the whole object
            raise errors.BadRequestError(
                "the status subresource supports get and update only")

        if req.method == "GET":
            from ..apis.printers import render_table, wants_table

            self._check_replica_lag()
            await self._consistent_read_gate(
                req, watch=(name is None
                            and req.param("watch") in ("true", "1")))
            as_table = wants_table(req.headers.get("accept", ""))
            if name is None:
                if req.param("watch") in ("true", "1"):
                    return self._watch(req, cluster, res, namespace or None)
                selector = parse_selector(req.param("labelSelector"))
                limit_s = req.param("limit")
                cont = req.param("continue")
                if ((limit_s or cont) and not as_table
                        and hasattr(self.store, "list_page")):
                    try:
                        limit = int(limit_s) if limit_s else 0
                    except ValueError:
                        raise errors.BadRequestError(
                            f"malformed limit {limit_s!r}") from None
                    if limit < 0:
                        raise errors.BadRequestError("limit must be >= 0")
                    return await self._list_page(
                        req, cluster, res, namespace, selector, info, gv,
                        limit, cont or None)
                if self._encode and not as_table:
                    return await self._list_encoded(
                        req, cluster, res, namespace, selector, info, gv)
                items, rv = await self._st(
                    self.store.list, res, cluster, namespace or None, selector)
                if as_table:  # kubectl get: server-side printer columns
                    return Response.of_json(render_table(res, items, rv))
                t0 = time.perf_counter()
                resp = Response.of_json({
                    "kind": info.list_kind, "apiVersion": gv,
                    "metadata": {"resourceVersion": str(rv)},
                    "items": items,
                })
                self._enc_seconds.observe(time.perf_counter() - t0)
                return resp
            target = await self._read_cluster(cluster, res, name, namespace)
            if self._encode and not as_table:
                raw = self._get_encoded(res, target, name, namespace)
                if raw is not None:
                    return Response(body=raw)
            obj = await self._st(self.store.get, res, target, name, namespace)
            # no table transform for the status subresource (matches the
            # real apiserver: table rendering applies to objects, not
            # subresources)
            if as_table and subresource is None:
                return Response.of_json(render_table(res, [obj]))
            return Response.of_json(self._stamp(obj, info, gv))

        if req.method == "POST" and name is None:
            obj = self._body_object(req)
            target = resolve_write_cluster(cluster, obj, errors.BadRequestError)
            # admission inline (reads never touch it): admit_nowait only
            # hands back a coroutine when flow control parks the request,
            # so the uncontended write path stays synchronous
            adm = self.admission
            if adm is None:
                ticket = NOOP_TICKET
            else:
                with obs.span("admission.admit", verb="create"):
                    got = adm.admit_nowait("create", res, target, namespace,
                                           obj)
                    ticket = got if hasattr(got, "ok") else await got
            try:
                created = await self._st(
                    self.store.create, res, target, obj, namespace)
            except BaseException:
                ticket.fail()
                raise
            await self._finish_write(ticket)
            return self._rv_stamped(
                Response.of_json(self._stamp(created, info, gv), 201),
                (created.get("metadata") or {}).get("resourceVersion"))

        if req.method == "PUT" and name is not None:
            obj = self._body_object(req)
            body_name = obj.setdefault("metadata", {}).setdefault("name", name)
            if body_name != name:
                raise errors.BadRequestError(
                    f"name in URL ({name}) does not match name in object ({body_name})")
            target = resolve_write_cluster(cluster, obj, errors.BadRequestError)
            adm = self.admission
            if adm is None:
                ticket = NOOP_TICKET
            else:
                with obs.span("admission.admit", verb="update"):
                    got = adm.admit_nowait("update", res, target, namespace,
                                           obj)
                    ticket = got if hasattr(got, "ok") else await got
            try:
                if subresource == "status":
                    updated = await self._st(
                        self.store.update_status, res, target, obj, namespace)
                else:
                    updated = await self._st(
                        self.store.update, res, target, obj, namespace)
            except BaseException:
                ticket.fail()
                raise
            await self._finish_write(ticket)
            return self._rv_stamped(
                Response.of_json(self._stamp(updated, info, gv)),
                (updated.get("metadata") or {}).get("resourceVersion"))

        if req.method == "DELETE" and name is not None:
            target = await self._read_cluster(cluster, res, name, namespace)
            adm = self.admission
            if adm is None:
                ticket = NOOP_TICKET
            else:
                with obs.span("admission.admit", verb="delete"):
                    got = adm.admit_nowait("delete", res, target, namespace,
                                           None)
                    ticket = got if hasattr(got, "ok") else await got
            try:
                await self._st(self.store.delete, res, target, name, namespace)
            except BaseException:
                ticket.fail()
                raise
            await self._finish_write(ticket)
            # a delete's Status body carries no RV, but session
            # read-your-writes needs a floor covering it: stamp the
            # store RV (>= the delete's own RV) as a response header
            rv = (0 if self._remote
                  else getattr(self.store, "resource_version", 0))
            return self._rv_stamped(
                Response.of_json(_status_body(
                    200, "Deleted", f"{res} {name} deleted")), rv)

        raise errors.BadRequestError(f"unsupported method {req.method} for {req.path}")

    @staticmethod
    def _rv_stamped(resp: Response, rv) -> Response:
        """Mirror a write's committed RV as ``X-Kcp-Rv`` so clients can
        raise their session read-your-writes floor without parsing the
        body (delete acks are Status objects with no RV at all)."""
        if rv:
            resp.headers["X-Kcp-Rv"] = str(rv)
        return resp

    @staticmethod
    def _body_object(req: Request) -> dict:
        try:
            obj = req.json()
        except ValueError as e:
            raise errors.BadRequestError(f"malformed JSON body: {e}") from e
        if not isinstance(obj, dict):
            raise errors.BadRequestError("body must be a JSON object")
        return obj

    def _stamp(self, obj: dict, info: ResourceInfo, gv: str) -> dict:
        obj.setdefault("kind", info.kind)
        obj.setdefault("apiVersion", gv)
        return obj

    async def _list_encoded(self, req: Request, cluster: str, res: str,
                            namespace: str, selector, info: ResourceInfo,
                            gv: str) -> Response:
        """Encode-once list serving: (1) an RV-keyed body cache answers
        repeated identical queries against an unchanged store without
        touching the items at all; (2) unselected lists assemble from
        the store's per-bucket span caches (no global sort, no per-item
        probe); (3) selector lists byte-splice the per-snapshot cached
        bytes. All three are byte-identical to dumping the full dict."""
        from .. import faults as _faults
        from ..analysis import sanitize as _san

        # bypassed while faults are active (encode.cache drops must
        # reach the per-record cache) and under the sanitizer (every hit
        # must flow through the verifying per-record paths)
        cacheable = (_faults._ACTIVE is None and _faults._ENV_CHECKED
                     and not _san.enabled())
        ck = (res, cluster, namespace, req.param("labelSelector") or "", gv)
        if cacheable:
            ent = self._list_cache.get(ck)
            if ent is not None and ent[0] == self.store.resource_version:
                REGISTRY.counter("encode_cache_hits_total").inc()
                REGISTRY.counter(
                    "encode_cache_bytes_shared_total").inc(ent[2])
                return Response(spans=list(ent[1]))
        t0 = time.perf_counter()
        if selector.empty and self._spans:
            spans, rv = await self._st(
                self.store.list_encoded, res, cluster, namespace or None)
        else:
            items, rv = await self._st(
                self.store.list, res, cluster, namespace or None, selector)
            spans = self.store.encode_many(items)
        # byte-splice: the envelope is dumped once with an empty items
        # array, then the item/span bytes are spliced in place of the
        # final `]}` — byte-identical to dumping the full dict, without
        # re-serializing 100k objects per request. The parts list IS the
        # response body (Response.spans): the wire layer writes the
        # spans scatter-style, so at 100k objects the tens-of-MB body is
        # never materialized as one joined copy at all
        # (KCP_WIRE_SCATTER; =0 restores the single join for A/B)
        head = json.dumps({
            "kind": info.list_kind, "apiVersion": gv,
            "metadata": {"resourceVersion": str(rv)},
            "items": [],
        }).encode()
        parts = [head[:-2]]
        for i, span in enumerate(spans):
            if i:
                parts.append(b", ")
            parts.append(span)
        parts.append(b"]}")
        total = sum(len(p) for p in parts)
        self._enc_seconds.observe(time.perf_counter() - t0)
        if cacheable:
            if (len(self._list_cache) >= self._list_cache_max
                    and ck not in self._list_cache):
                self._list_cache.pop(next(iter(self._list_cache)))
            self._list_cache[ck] = (rv, tuple(parts), total)
        return Response(spans=parts)

    async def _list_page(self, req: Request, cluster: str, res: str,
                         namespace: str, selector, info: ResourceInfo,
                         gv: str, limit: int, cont: str | None) -> Response:
        """KEP-365 chunked list serving: one RV-pinned page per request.

        Pages skip the RV-keyed whole-body cache (each page is its own
        body) but ride the same span-splice envelope as
        :meth:`_list_encoded` — a page is assembled from bucket-span
        slices, never a whole-body join. ``metadata`` keeps
        ``resourceVersion`` first so the router's vector-RV rewrite and
        continue-token splice anchor on it. A continue token the store's
        watch window no longer covers raises typed ``GoneError`` →
        HTTP 410, and the client restarts its chunked list."""
        t0 = time.perf_counter()
        if self._encode and selector.empty and self._spans:
            spans, rv, nxt = await self._st(
                self.store.list_encoded_page, res, cluster,
                namespace or None, limit, cont)
        else:
            items, rv, nxt = await self._st(
                self.store.list_page, res, cluster, namespace or None,
                selector, limit, cont)
            if not self._encode:
                meta: dict = {"resourceVersion": str(rv)}
                if nxt:
                    meta["continue"] = nxt
                resp = Response.of_json({
                    "kind": info.list_kind, "apiVersion": gv,
                    "metadata": meta, "items": items,
                })
                self._enc_seconds.observe(time.perf_counter() - t0)
                return resp
            spans = self.store.encode_many(items) if items else []
        meta = {"resourceVersion": str(rv)}
        if nxt:
            meta["continue"] = nxt
        head = json.dumps({
            "kind": info.list_kind, "apiVersion": gv,
            "metadata": meta, "items": [],
        }).encode()
        parts = [head[:-2]]
        for i, span in enumerate(spans):
            if i:
                parts.append(b", ")
            parts.append(span)
        parts.append(b"]}")
        self._enc_seconds.observe(time.perf_counter() - t0)
        return Response(spans=parts)

    def _get_encoded(self, res: str, cluster: str, name: str,
                     namespace: str) -> bytes | None:
        """Cached body for a single-object GET (encode-once: no deepcopy,
        no dumps on a warm snapshot). None when :meth:`_stamp` would have
        to add kind/apiVersion defaults — that rare shape takes the dict
        path so the wire stays byte-identical either way. In-process
        stores only (``self._encode``), so this runs inline."""
        snap = self.store.get_snapshot(res, cluster, name, namespace)
        if "kind" not in snap or "apiVersion" not in snap:
            return None
        t0 = time.perf_counter()
        raw = self.store.encode_obj(snap)
        self._enc_seconds.observe(time.perf_counter() - t0)
        return raw

    async def _read_cluster(self, cluster: str, res: str, name: str,
                            namespace: str) -> str:
        """Wildcard single-object reads scan tenants for the unique owner."""
        if cluster != WILDCARD:
            return cluster
        if self._remote:
            # storage frontend: the backend's own handler resolves '*'
            # (this same scan, against its in-memory index) — forwarding
            # the wildcard costs one round trip instead of tenants+1
            return cluster
        if hasattr(self.store, "locate"):
            # index-driven: only clusters holding the resource are probed
            matches = self.store.locate(res, name, namespace)
        else:
            matches = [c for c in self.store.clusters()
                       if self._exists(res, c, name, namespace)]
        if len(matches) == 1:
            return matches[0]
        if not matches:
            raise errors.NotFoundError(f"{res} {namespace}/{name} not found in any cluster")
        raise errors.BadRequestError(
            f"{res} {namespace}/{name} is ambiguous across clusters {matches}")

    def _exists(self, res: str, cluster: str, name: str, namespace: str) -> bool:
        try:
            self.store.get(res, cluster, name, namespace)
            return True
        except errors.NotFoundError:
            return False

    # -------------------------------------------------------- replication

    async def _replication(self, req: Request, segs: list[str]):
        """The WAL-shipping surface (kcp_tpu_torch/replication/):

        - ``GET  /replication/wal``    chunked record feed (followers)
        - ``GET  /replication/status`` role/epoch/applied-RV/lag probe
        - ``POST /replication/ack``    standby applied-RV report
        - ``POST /replication/fence``  epoch fence (promotion kill switch)

        The feed carries every tenant's objects and the fence can stop
        a primary cold, so everything but ``status`` is gated like the
        other server-global surfaces (/debug, /clusters).
        """
        if segs == ["status"] and req.method == "GET":
            st = self.store
            body = {
                "role": self.repl_role,
                "epoch": getattr(st, "epoch", 0),
                "applied_rv": getattr(st, "resource_version", 0),
                "read_only": getattr(st, "read_only", None),
                "fenced": bool(getattr(st, "fenced", False)),
            }
            ap = self.repl_applier
            if ap is not None:
                body["lag_records"] = ap.lag_records
                body["frontier_rv"] = ap.frontier_rv
                body["apply_rate"] = round(ap.apply_rate, 3)
                body["connected"] = ap.connected
                body["primary"] = ap.primary_url
                body["primary_candidates"] = list(ap.candidates)
            if self.repl_hub is not None:
                body["subscribers"] = len(self.repl_hub._subs)
            return Response.of_json(body)
        if not await self._server_scope_allowed(req):
            user = (self.authenticator.user_for(req.headers)
                    if self.authenticator else "anonymous")
            return Response.of_json(
                _status_body(403, "Forbidden",
                             f'user "{user}" cannot access replication'),
                403)
        if self.repl_hub is None:
            return _error_response(errors.NotFoundError(
                "no replication hub on this server (routers and "
                "remote-store frontends do not ship a WAL)"))
        if segs == ["wal"] and req.method == "GET":
            try:
                since_rv = int(req.param("sinceRV", "0") or "0")
                sub_epoch = int(req.param("epoch", "0") or "0")
            except ValueError as e:
                raise errors.BadRequestError(
                    f"malformed replication params: {e}") from e
            role = req.param("role", "replica")
            if role not in ("replica", "standby", "migration"):
                raise errors.BadRequestError(
                    f"unknown replication role {role!r}")
            # migration transport (sharding/migrate.py): one cluster's
            # post-fence snapshot + BARRIER, nothing else — the same
            # feed, filtered
            mig_cluster = req.param("cluster") or None
            hub = self.repl_hub

            async def produce(stream: StreamResponse) -> None:
                try:
                    await hub.serve_feed(stream, since_rv, sub_epoch,
                                         role, mig_cluster)
                except errors.ApiError as e:
                    await stream.send_json({
                        "type": "ERROR",
                        "object": _status_body(e.code, e.reason, e.message)})

            return StreamResponse(produce)
        if segs == ["ack"] and req.method == "POST":
            body = self._body_object(req)
            self.repl_hub.ack(int(body.get("sub", 0)),
                              int(body.get("rv", 0)))
            return Response.of_json(_status_body(200, "OK", "acked"))
        if segs == ["fence"] and req.method == "POST":
            body = self._body_object(req)
            epoch = int(body.get("epoch", 0))
            if epoch < self.store.epoch:
                # a stale fence (e.g. from a promotion that itself got
                # superseded) must not stick: epochs only move forward
                raise errors.ConflictError(
                    f"fence epoch {epoch} is older than this store's "
                    f"epoch {self.store.epoch}")
            if epoch > self.store.epoch:
                self.store.fence(epoch)
                # flush + terminate every live watch stream: an open
                # watch on a fenced store would otherwise idle forever
                # (no writes can commit here again), never seeing the
                # promoted primary's events
                self.watch_fence.set()
            # equal epoch: idempotent retry of an applied fence (or a
            # no-op against the current epoch's own primary)
            return Response.of_json(_status_body(
                200, "OK",
                f"epoch {self.store.epoch}"
                + (" (fenced)" if self.store.fenced else "")))
        return _error_response(
            errors.NotFoundError(f"unknown path {req.path}"))

    # --------------------------------------------------------- migration

    async def _ring_install(self, req: Request) -> Response:
        """Shard-side ring identity update (``POST /ring``): the router
        fans the grown/shrunk ring (names, epoch, pending-migration
        overrides) out to every member on each epoch bump, so direct
        smart-client verification keeps agreeing with routing. The
        epoch never rewinds (a late fan-out from a superseded publish
        must not reinstate a stale ring)."""
        if not await self._server_scope_allowed(req):
            return self._forbidden(req, "update the shard ring")
        body = self._body_object(req)
        try:
            epoch = int(body.get("epoch", 0))
            names = tuple(str(n) for n in (body.get("names") or ()))
            overrides = {str(c): str(n) for c, n in
                         (body.get("overrides") or {}).items()}
        except (TypeError, ValueError, AttributeError) as e:
            raise errors.BadRequestError(
                f"malformed ring document: {e}") from e
        if not names or self.shard_name not in names:
            raise errors.BadRequestError(
                f"ring names {list(names)} must include this shard "
                f"({self.shard_name!r})")
        if epoch < self.ring_epoch:
            raise errors.ConflictError(
                f"ring epoch {epoch} is older than this shard's "
                f"{self.ring_epoch}; ring epochs never rewind")
        self.ring_names = names
        self.ring_epoch = epoch
        self.ring_overrides = overrides
        return Response.of_json(_status_body(
            200, "OK", f"ring installed: epoch {epoch}, "
            f"{len(names)} shards, {len(overrides)} pending migrations"))

    async def _migration(self, req: Request, segs: list[str]):
        """The live-migration control surface (sharding/migrate.py):

        - ``POST /migration/fence``   {cluster} on the SOURCE — refuse
          further writes to the cluster, return its cutover RV
        - ``POST /migration/unfence`` {cluster} — abort rollback
        - ``POST /migration/ingest``  ndjson WAL-shaped records on the
          TARGET — apply with fresh local RVs
        - ``POST /migration/finish``  {cluster, source_rv} on the TARGET
          — advance the RV counter past the source's and set the
          cluster's resume floor
        - ``POST /migration/purge``   {cluster} on the SOURCE — evict
          the cluster's watches (typed 410) and drop its objects with
          no watch events

        All of it moves tenant data across trust boundaries, so every
        verb is gated like the other server-global surfaces."""
        if req.method != "POST":
            return _error_response(
                errors.BadRequestError("migration endpoints are POST-only"))
        if not await self._server_scope_allowed(req):
            user = (self.authenticator.user_for(req.headers)
                    if self.authenticator else "anonymous")
            return Response.of_json(
                _status_body(403, "Forbidden",
                             f'user "{user}" cannot access migration'),
                403)
        st = self.store
        if not hasattr(st, "fence_cluster"):
            return _error_response(errors.NotFoundError(
                "no local store on this server (routers and remote-store "
                "frontends do not hold cluster data)"))
        if segs == ["ingest"]:
            applied = 0
            last_rv = None
            for line in (req.body or b"").splitlines():
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except ValueError as e:
                    raise errors.BadRequestError(
                        f"malformed migration record: {e}") from e
                rv = st.apply_migrated(rec)
                if rv is not None:
                    applied += 1
                    last_rv = rv
            return Response.of_json({"applied": applied, "rv": last_rv})
        body = self._body_object(req)
        cluster = body.get("cluster")
        if not cluster or not isinstance(cluster, str):
            raise errors.BadRequestError(
                "migration request needs a cluster name")
        if segs == ["fence"]:
            return Response.of_json(
                {"cluster": cluster, "cutover_rv": st.fence_cluster(cluster)})
        if segs == ["unfence"]:
            st.unfence_cluster(cluster)
            return Response.of_json(_status_body(
                200, "OK", f"cluster {cluster} unfenced"))
        if segs == ["finish"]:
            floor = st.finish_migration(cluster,
                                        int(body.get("source_rv", 0)))
            return Response.of_json({"cluster": cluster, "floor_rv": floor})
        if segs == ["purge"]:
            return Response.of_json(
                {"cluster": cluster, "purged": st.purge_cluster(cluster)})
        return _error_response(
            errors.NotFoundError(f"unknown path {req.path}"))

    async def _finish_write(self, ticket) -> None:
        """Release one write's HTTP ack: durability barrier first (the
        commit window's shared WAL sync — a window that dies pre-sync
        fails every writer typed and acks none), then the semi-sync
        standby wait at the window's high RV (one ack releases every
        writer of the window). The admission ticket settles with the
        same cadence: serial writes settle inline; windowed writes free
        their flow slot immediately but batch the quota reserve→commit
        into ONE ledger pass per window (admission/quota.settle_batch).
        """
        st = self.store
        # lazy on rv: remote-store frontends price resource_version as a
        # backend round trip, and they have neither windows nor a hub
        wait = getattr(st, "commit_durable", None)
        aw = wait() if wait is not None else None
        if aw is None:
            ticket.ok()
            rv = None
        else:
            self._enroll_ticket(aw, ticket)
            rv = await aw  # window high RV; typed 503 on a failed sync
        await self._repl_wait(rv)

    def _enroll_ticket(self, fut, ticket) -> None:
        """Park one write's admission obligations on its commit window:
        the flow slot frees NOW (window linger must not throttle
        concurrency), the quota reservation + after-hooks settle once
        per window when the shared future resolves."""
        split = getattr(ticket, "split_for_window", None)
        if split is None:
            ticket.ok()  # foreign ticket shape: settle inline
            return
        reservation, after = split()
        if reservation is None and after is None:
            return
        batch = self._adm_windows.get(fut)
        if batch is None:
            batch = self._adm_windows[fut] = []
            fut.add_done_callback(self._settle_adm_window)
        batch.append((reservation, after))

    def _settle_adm_window(self, fut) -> None:
        """One commit window resolved: settle every enrolled write's
        quota reservation in one batched ledger pass (commit on a
        durable window, rollback on a failed sync — 'commit none'
        applies to the ledger too) and fire the after-hooks."""
        batch = self._adm_windows.pop(fut, None)
        if not batch:
            return
        from ..admission.quota import settle_batch

        ok = not fut.cancelled() and fut.exception() is None
        settle_batch([r for r, _ in batch], rollback=not ok)
        if ok:
            for _, after in batch:
                if after is not None:
                    after()

    async def _repl_wait(self, rv: int | None = None) -> None:
        """Semi-sync commit: with a standby attached, a write is only
        acknowledged once the standby has applied ``rv`` (the write's
        own RV, or its commit window's high RV so the whole window rides
        one ack) — the property the kill-the-primary drill measures as
        zero acknowledged-write loss. No standby, no wait (async
        replication)."""
        hub = self.repl_hub
        if hub is not None and hub.has_sync_subscribers:
            with obs.span("repl.ack"):
                await hub.wait_committed(
                    rv or self.store.resource_version)

    def _check_replica_lag(self) -> None:
        """Reads on a replica past KCP_REPL_LAG_MAX refuse 503 — for
        consumers that prefer unavailability over staleness; the
        default (0) serves any staleness RV-honestly. The refusal
        carries a computed Retry-After (current lag / recent apply
        rate) so informers back off exactly as long as catch-up needs
        instead of a generic jittered retry."""
        ap = self.repl_applier
        if (self.repl_lag_max and ap is not None
                and ap.lag_records > self.repl_lag_max):
            err = errors.UnavailableError(
                f"replica lag {ap.lag_records} records exceeds "
                f"KCP_REPL_LAG_MAX={self.repl_lag_max}; read the primary")
            rate = getattr(ap, "apply_rate", 0.0)
            err.retry_after = (min(30.0, max(1.0, ap.lag_records / rate))
                               if rate > 0 else 1.0)
            raise err

    @staticmethod
    def _consistent_timeout_s() -> float:
        try:
            ms = float(os.environ.get(
                "KCP_CONSISTENT_READ_TIMEOUT_MS", "2000") or 0)
        except ValueError:
            ms = 2000.0
        return max(0.0, ms / 1000.0)

    async def _consistent_read_gate(self, req: Request,
                                    watch: bool = False) -> None:
        """KEP-2340 RV-barrier for reads on a follower: a read carrying
        a required RV (``X-Kcp-Min-Rv: <rv>``, ``X-Kcp-Min-Rv:
        consistent`` resolved against the progress-notify frontier, an
        RV-pinned continue token, or a watch resume RV) parks on the
        applier's bounded waiter until ``applied_rv >= required``, then
        serves from the local store through the encode-once path —
        byte-identical to the primary at that RV. Timeout answers the
        typed 504 (:class:`~kcp_tpu_torch.utils.errors.FrontierTimeoutError`)
        and the caller falls back to the primary; a timed-out watch
        resume instead falls through to the store's own
        ``reject_future_rv`` answer (typed 410 → the client re-lists).
        No-op on a primary: it IS the frontier."""
        ap = self.repl_applier
        if ap is None or ap.promoted:
            return
        raw = (req.headers.get("x-kcp-min-rv") or "").strip()
        required = 0
        if raw:
            if raw.lower() == "consistent":
                # one cheap frontier probe: the progress-notify stream
                # keeps last_seen_rv fresh even on a quiet feed
                required = ap.frontier_rv
            else:
                try:
                    required = int(raw)
                except ValueError:
                    raise errors.BadRequestError(
                        f"malformed X-Kcp-Min-Rv {raw!r}") from None
        cont = req.param("continue")
        if cont:
            from ..store.store import decode_continue

            try:
                required = max(required, decode_continue(cont)[0])
            except ValueError:
                pass  # the page path answers the typed 410
        since = req.param("resourceVersion")
        if since:
            # a watch resume RV or an RV-pinned list: both mean "the
            # client has seen this RV" — the same barrier applies
            try:
                required = max(required, int(since))
            except ValueError:
                pass  # _watch raises the typed 400; lists ignore it
        if required <= self.store.resource_version:
            return
        timeout_s = self._consistent_timeout_s()
        self._consistent_waits.inc()
        t0 = time.perf_counter()
        ok = await ap.wait_applied(required, timeout_s)
        self._consistent_wait_seconds.observe(time.perf_counter() - t0)
        if ok or watch:
            return
        self._consistent_timeouts.inc()
        raise errors.FrontierTimeoutError(
            f"applied_rv {self.store.resource_version} < required "
            f"{required} after {int(timeout_s * 1000)}ms; "
            f"read the primary")

    # -------------------------------------------------------------- watch

    @staticmethod
    def _send_evicted(stream, message: str) -> None:
        """Buffer a terminal typed 410 on an evicted stream WITHOUT a
        drain — the socket may be exactly the full buffer eviction is
        punishing; close flushes what the client still reads."""
        line = (json.dumps({"type": "ERROR",
                            "object": _status_body(410, "Expired", message)})
                .encode() + b"\n")
        try:
            stream.write_raw_many([line])
        except (AttributeError, ConnectionError, RuntimeError):
            pass  # duck-typed test stream or torn-down transport

    def _watch(self, req: Request, cluster: str, res: str,
               namespace: str | None) -> StreamResponse:
        selector = parse_selector(req.param("labelSelector"))
        since = req.param("resourceVersion")
        try:
            since_rv = int(since) if since else None
        except ValueError as e:
            raise errors.BadRequestError(f"malformed resourceVersion {since!r}") from e
        timeout_s = req.param("timeoutSeconds")
        try:
            timeout = float(timeout_s) if timeout_s else None
        except ValueError as e:
            raise errors.BadRequestError(
                f"malformed timeoutSeconds {timeout_s!r}") from e
        import math

        if timeout is not None and (not math.isfinite(timeout) or timeout < 0):
            # nan/inf would turn the deadline math into a busy-spin
            raise errors.BadRequestError(
                f"timeoutSeconds must be a finite non-negative number, "
                f"got {timeout_s!r}")
        bookmarks = req.param("allowWatchBookmarks") in ("true", "1")
        initial_events = req.param("sendInitialEvents") in ("true", "1")
        if initial_events and self._remote:
            # a storage frontend would have to buffer the backend's
            # whole list to re-serve it — exactly what watch-list
            # exists to avoid; the client falls back to list+watch
            raise errors.BadRequestError(
                "sendInitialEvents is not supported on a storage "
                "frontend; list+watch instead")
        # bookmark cadence (KCP_WATCH_BOOKMARK_S): frequent enough that
        # resuming clients lose little window, cheap enough to be noise
        # (apiserver uses ~1/min; our watch windows are smaller)
        bookmark_every = self._bookmark_every

        async def produce(stream: StreamResponse) -> None:
            init_items = init_rv = None
            try:
                if initial_events:
                    # KEP-3157-style watch-list: open the watch and take
                    # the list snapshot in ONE store-loop step, so no
                    # event can fall between them — the ADDED stream
                    # plus the live tail is exactly list-then-watch,
                    # without the client ever holding a whole list body
                    def _open_watch_list():
                        w = self.store.watch(
                            res, cluster, namespace, selector, None)
                        items, rv = self.store.list(
                            res, cluster, namespace, selector)
                        return w, items, rv
                    watch, init_items, init_rv = await self._st(
                        _open_watch_list)
                else:
                    watch = await self._st(
                        self.store.watch, res, cluster, namespace,
                        selector, since_rv)
            except errors.ConflictError as e:
                # expired watch window → 410 Gone in-stream, like the
                # apiserver's "too old resource version"
                await stream.send_json({"type": "ERROR",
                                        "object": _status_body(410, "Expired", e.message)})
                return
            except errors.ApiError as e:
                # a remote-store backend can refuse the watch itself
                # (403 bad --store-token, 404 unknown resource, ...):
                # relay the mapped Status in-stream instead of silently
                # dropping the client connection (ADVICE r5)
                await stream.send_json({
                    "type": "ERROR",
                    "object": _status_body(e.code, e.reason, e.message)})
                return
            if init_items is not None:
                # stream the snapshot as ADDED events in bounded
                # batches, then the sync BOOKMARK that marks the end of
                # initial events — the client is consistent at init_rv
                # and keeps this very stream for the live tail
                send_raw = (getattr(stream, "send_raw_many", None)
                            if self._encode else None)
                if send_raw is not None:
                    batch: list[bytes] = []
                    for obj in init_items:
                        batch.append(b'{"type": "ADDED", "object": '
                                     + self.store.encode_obj(obj) + b"}\n")
                        if len(batch) >= 512:
                            await send_raw(batch)
                            batch = []
                    if batch:
                        await send_raw(batch)
                else:
                    for obj in init_items:
                        await stream.send_json(
                            {"type": "ADDED", "object": obj})
                await stream.send_json({
                    "type": "BOOKMARK",
                    "object": {"kind": "Bookmark", "metadata": {
                        "resourceVersion": str(init_rv),
                        "annotations": {INITIAL_EVENTS_END: "true"}}},
                })
                REGISTRY.counter(
                    "watch_list_streams_total",
                    "watch streams opened with sendInitialEvents").inc()
            loop = asyncio.get_event_loop()
            deadline = loop.time() + timeout if timeout else None
            drain_task: asyncio.Task | None = None
            fence_task: asyncio.Task | None = None

            async def send_batch(batch) -> None:
                # coalesce whatever else the watch already buffered
                # (the store's batched fan-out delivers in bursts)
                # into one chunk/one drain instead of a write per
                # event; drain() never raises, so error mapping below
                # is unaffected. Streams without the batch method
                # (test fakes/duck types) get the per-event sends.
                send_raw = (getattr(stream, "send_raw_many", None)
                            if self._encode else None)
                send_many = getattr(stream, "send_json_many", None)
                if send_raw is not None:
                    # encode-once: every relay serving this store
                    # splices the same cached event-line bytes — a
                    # 64-watcher fan-out encodes each event once
                    t0 = loop.time()
                    lines = self.store.encode_events(batch)
                    self._enc_seconds.observe(loop.time() - t0)
                    if (self._coalescer is not None
                            and getattr(stream, "write_raw_many", None)
                            is not None):
                        # batched flush: lines park with every other
                        # stream's and each socket is written once per
                        # coalescing tick; False = this socket is past
                        # the buffer bound — evict, don't buffer more.
                        # Duck-typed streams without the buffered write
                        # half (test sinks) keep the direct path.
                        if not await self._coalescer.write(stream, lines):
                            raise _SlowWatcher()
                    else:
                        await send_raw(lines)
                elif send_many is not None:
                    await send_many(
                        [{"type": e.type, "object": e.object} for e in batch])
                else:
                    for e in batch:
                        await stream.send_json({"type": e.type,
                                                "object": e.object})

            async def flush_and_terminate() -> None:
                # graceful drain: every event the fan-out already queued
                # is delivered, then a final BOOKMARK anchors the client
                # at the store's true position — DELETED events carry
                # the object's last-written RV, so a client that saw
                # every event can still trail the store RV, and resuming
                # from that trailing RV against the restarted server's
                # empty history would answer a false 410. The terminal
                # in-stream Status then tells the client this stream
                # ends deliberately: resume from the bookmark, nothing
                # was swallowed.
                batch = watch.drain()
                if batch:
                    await send_batch(batch)
                rv_now = (getattr(watch, "last_rv", 0) if self._remote
                          else self.store.resource_version)
                if rv_now:
                    await stream.send_json({
                        "type": "BOOKMARK",
                        "object": {"kind": "Bookmark", "metadata": {
                            "resourceVersion": str(rv_now)}},
                    })
                await stream.send_json({
                    "type": "ERROR",
                    "object": _status_body(
                        503, "ServiceUnavailable",
                        "server is draining; resume from your last "
                        "resourceVersion")})

            nxt: asyncio.Task | None = None
            try:
                it = watch.__aiter__()
                while True:
                    if self.draining.is_set() or self.watch_fence.is_set():
                        await flush_and_terminate()
                        return
                    step = bookmark_every if bookmarks else 3600.0
                    if deadline is not None:
                        step = min(step, max(0.0, deadline - loop.time()))
                    nxt = asyncio.ensure_future(it.__anext__())
                    if drain_task is None:
                        drain_task = asyncio.ensure_future(
                            self.draining.wait())
                    if fence_task is None:
                        fence_task = asyncio.ensure_future(
                            self.watch_fence.wait())
                    done, _ = await asyncio.wait(
                        {nxt, drain_task, fence_task}, timeout=step,
                        return_when=asyncio.FIRST_COMPLETED)
                    ev = None
                    err: BaseException | None = None
                    if nxt in done:
                        try:
                            ev = nxt.result()
                        except BaseException as e:  # noqa: BLE001 — mapped below
                            err = e
                    else:
                        # timeout or drain woke us: reap the in-flight
                        # __anext__ without losing an event that raced in
                        # between wait() returning and the cancel
                        nxt.cancel()
                        try:
                            ev = await nxt
                        except (asyncio.CancelledError, StopAsyncIteration):
                            ev = None
                        except BaseException as e:  # noqa: BLE001 — mapped below
                            err = e
                    if err is not None:
                        if isinstance(err, errors.ConflictError):
                            # remote-store frontends surface an expired
                            # watch window from the first iteration (the
                            # backend's 410 arrives in-stream) rather than
                            # from watch() — translate it the same way so
                            # clients relist instead of seeing a silent
                            # connection drop
                            await stream.send_json({
                                "type": "ERROR",
                                "object": _status_body(410, "Expired",
                                                       err.message)})
                            return
                        if isinstance(err, errors.ApiError):
                            # any other backend refusal mid-relay (403/404/
                            # 5xx mapped by the REST client) ends the stream
                            # with a terminal Status carrying the real code,
                            # not a silent connection drop (ADVICE r5)
                            await stream.send_json({
                                "type": "ERROR",
                                "object": _status_body(err.code, err.reason,
                                                       err.message)})
                            return
                        if isinstance(err, StopAsyncIteration):
                            if getattr(watch, "evicted", False):
                                # backpressure eviction (KCP_WATCH_QUEUE
                                # overflow or the watch.evict drill): a
                                # typed in-stream 410 — the informer
                                # relists NOW and resumes; the metric
                                # was counted at the eviction site
                                self._send_evicted(
                                    stream,
                                    "watch queue overflowed "
                                    "(KCP_WATCH_QUEUE): slow watcher "
                                    "evicted; re-list and resume")
                            return
                        raise err
                    if ev is not None:
                        await send_batch([ev, *watch.drain()])
                        continue
                    if self.draining.is_set() or self.watch_fence.is_set():
                        await flush_and_terminate()
                        return
                    if deadline is not None and loop.time() >= deadline:
                        return  # server-side watch timeout: clean close
                    # only bookmark when nothing is buffered: the store
                    # RV may already cover an event still queued in this
                    # watch, and a client resuming from such a bookmark
                    # would skip that event forever
                    if bookmarks and not watch.pending():
                        # progress marker carrying the current RV so
                        # clients can resume without replay. On a
                        # remote-store frontend the store RV is ahead
                        # of the relayed stream (an event can commit
                        # backend-side while its chunk is still in
                        # flight), so bookmark only what this stream
                        # has DELIVERED (last_rv) — a fresher store
                        # RV would let a resuming client skip that
                        # in-flight event forever.
                        if self._remote:
                            rv_now = getattr(watch, "last_rv", 0)
                            if not rv_now:
                                continue  # nothing delivered yet
                        else:
                            rv_now = self.store.resource_version
                        await stream.send_json({
                            "type": "BOOKMARK",
                            "object": {"kind": "Bookmark", "metadata": {
                                "resourceVersion": str(rv_now)}},
                        })
            except _SlowWatcher:
                # the socket sat past KCP_WATCH_BUFFER_MAX: terminal
                # typed 410 buffered without a drain (draining a full
                # slow socket is exactly what eviction exists to avoid)
                REGISTRY.counter("watch_evicted_total").inc()
                self._send_evicted(
                    stream,
                    "watch socket backlog exceeded KCP_WATCH_BUFFER_MAX: "
                    "slow watcher evicted; re-list and resume")
                return
            finally:
                # reap outstanding helper tasks without awaiting (this
                # block also runs under cancellation): the callback
                # retrieves any late exception (watch.close() below
                # completes a pending __anext__ with StopAsyncIteration)
                # so the loop never logs "exception was never retrieved"
                for t in (nxt, drain_task, fence_task):
                    if t is not None and not t.done():
                        t.cancel()
                    if t is not None:
                        t.add_done_callback(
                            lambda t: t.cancelled() or t.exception())
                watch.close()

        return StreamResponse(produce)


def render_kubeconfig(address: str, path: str, token: str = "",
                      ca_pem: bytes | None = None) -> None:
    """Write an admin kubeconfig-style file with admin + user contexts.

    Mirrors the reference writing .kcp/admin.kubeconfig with contexts
    ``admin`` and ``user`` (the latter scoped to /clusters/user)
    (reference: pkg/server/server.go:151-176). When RBAC-lite is on,
    the minted admin bearer token rides along as the user credential;
    with TLS, the CA certificate rides as certificate-authority-data so
    clients verify the self-signed endpoint."""
    users = [{"name": "admin", "user": ({"token": token} if token else {})}]
    cluster_fields = {}
    if ca_pem is not None:
        import base64

        cluster_fields["certificate-authority-data"] = base64.b64encode(
            ca_pem).decode("ascii")
    cfg = {
        "kind": "Config", "apiVersion": "v1",
        "clusters": [
            {"name": "admin", "cluster": {"server": address, **cluster_fields}},
            {"name": "user", "cluster": {"server": f"{address}/clusters/user",
                                         **cluster_fields}},
        ],
        "users": users,
        "contexts": [
            {"name": "admin", "context": {"cluster": "admin", "user": "admin"}},
            {"name": "user", "context": {"cluster": "user", "user": "admin"}},
        ],
        "current-context": "admin",
    }
    # 0600: the file may carry a cluster-admin bearer token (kubeconfig
    # convention)
    fd = os.open(path, os.O_CREAT | os.O_WRONLY | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "w", encoding="utf-8") as f:
        json.dump(cfg, f, indent=2)
