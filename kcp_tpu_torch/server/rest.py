"""RestClient: the Client interface spoken over HTTP.

The out-of-process analog of the reference's client-go REST clients: the
standalone binaries (cluster-controller, syncer, deployment-splitter,
crd-puller — reference cmd/*/main.go) connect to a kcp server with a
kubeconfig; here they construct a RestClient against the server address.
Implements the same interface as :class:`kcp_tpu_torch.client.Client`, so every
controller runs equally in-process (store-backed) or remote (HTTP).

Watch streams are chunked-transfer JSON lines (see server.handler._watch);
RestWatch reassembles them into store Events so the shared Informer works
unchanged over the wire.
"""

from __future__ import annotations

import asyncio
import codecs
import http.client
import json
import os
import threading
import time
from urllib.parse import quote, urlsplit

from .. import obs
from ..analysis.sanitize import make_lock
from ..apis.scheme import GVR, ResourceInfo, Scheme, default_scheme
from ..faults import link_fault, maybe_fail, should_drop
from ..store.selectors import LabelSelector
from ..store.store import INITIAL_EVENTS_END, WILDCARD, Event
from ..utils import errors
from ..utils.circuit import CircuitBreaker
from ..utils.routing import resolve_write_cluster


def _status_error(code: int, reason: str, message: str,
                  details: dict | None = None,
                  retry_after: float | None = None) -> errors.ApiError:
    """Map a Status (code, reason) to the ApiError taxonomy — shared by
    response handling and in-stream watch ERROR events. 429s become the
    typed TooManyRequestsError carrying the server's Retry-After pacing
    hint (header or Status ``details.retryAfterSeconds``)."""
    by_reason = {
        "NotFound": errors.NotFoundError,
        "AlreadyExists": errors.AlreadyExistsError,
        "Conflict": errors.ConflictError,
        "Invalid": errors.InvalidError,
        "BadRequest": errors.BadRequestError,
        "Forbidden": errors.ForbiddenError,
        "TooManyRequests": errors.TooManyRequestsError,
        "ServiceUnavailable": errors.UnavailableError,
        "FrontierWaitTimeout": errors.FrontierTimeoutError,
        "Expired": errors.GoneError,
        "Gone": errors.GoneError,
    }
    cls = by_reason.get(reason)
    if cls is None:
        cls = {404: errors.NotFoundError, 409: errors.ConflictError,
               410: errors.GoneError,
               422: errors.InvalidError, 400: errors.BadRequestError,
               403: errors.ForbiddenError,
               429: errors.TooManyRequestsError,
               503: errors.UnavailableError,
               504: errors.FrontierTimeoutError}.get(code, errors.ApiError)
    err = cls(message)
    if cls is errors.ApiError and code >= 400:
        # codes without a dedicated class (401/...) keep their real
        # code + reason on the instance so relays don't flatten to 500
        err.code = code
        if reason:
            err.reason = reason
    if isinstance(err, errors.TooManyRequestsError):
        hint = (details or {}).get("retryAfterSeconds", retry_after)
        try:
            err.retry_after = max(0.0, float(hint))
        except (TypeError, ValueError):
            pass  # class default (1.0) stands
    elif isinstance(err, errors.UnavailableError):
        # lag-shed 503s carry a computed Retry-After (replica lag /
        # apply rate): informers back off exactly as long as catch-up
        # needs instead of the generic jittered retry
        hint = (details or {}).get("retryAfterSeconds", retry_after)
        try:
            err.retry_after = max(0.0, float(hint))
        except (TypeError, ValueError):
            pass  # no hint: callers keep their generic backoff
    return err


def _raise_for_status(code: int, body: bytes,
                      retry_after: float | None = None,
                      headers: dict[str, str] | None = None) -> None:
    """Map an HTTP error status to the typed ApiError. ``headers`` (the
    response headers, lower-cased keys) ride the raised error as
    ``err.http_headers`` — relayed errors keep ``Retry-After`` /
    ``X-Kcp-Ring-Epoch`` visible to callers on the direct path too (the
    smart client's ring-staleness detection and PR 4's 429 pacing both
    read them)."""
    if code < 400:
        return
    try:
        status = json.loads(body)
    except (ValueError, UnicodeDecodeError):
        status = {}
    message = status.get("message", body.decode("latin-1")[:200])
    err = _status_error(code, status.get("reason", ""), message,
                        details=status.get("details"),
                        retry_after=retry_after)
    err.http_headers = headers or {}
    raise err


def _list_page_size() -> int:
    """Transparent list-chunking page size (KCP_LIST_PAGE, default
    10000; ``0`` restores the legacy one-shot list — the A/B lane).
    Read per call so tests and scenario phases can flip it live."""
    try:
        return int(os.environ.get("KCP_LIST_PAGE", "10000") or "0")
    except ValueError:
        return 10000


def _session_rv_enabled() -> bool:
    """Session read-your-writes (KCP_SESSION_RV, default on): clients
    track the max RV observed from their own write acks and watch
    streams per cluster and stamp it as ``X-Kcp-Min-Rv`` on subsequent
    reads — any replica then serves them no staler than the session's
    own past (KEP-2340 consistent reads). ``0`` restores the plain
    any-staleness read path."""
    return os.environ.get("KCP_SESSION_RV", "1").lower() not in (
        "0", "false", "off")


def _path_cluster(path: str) -> str:
    """The ``/clusters/<name>/`` tenant a request path targets; ""
    for non-cluster paths and the wildcard — RVs are per-store
    sequences, so a session floor is only meaningful against the one
    cluster (= shard) that minted it."""
    if not path.startswith("/clusters/"):
        return ""
    c = path[len("/clusters/"):].partition("/")[0].partition("?")[0]
    return "" if c in ("", WILDCARD) else c


class _SessionRv:
    """Per-cluster session read-your-writes floor, SHARED across every
    scoped() clone of one client (the holder object rides the
    ``__dict__`` copy, like the smart client's ring state): the max RV
    this session observed from its own write acks and watch streams.
    Thread-safe — scenario writers and watch feed tasks update it
    concurrently."""

    def __init__(self):
        self._lock = make_lock("rest.session")
        self._floor: dict[str, int] = {}

    def note(self, cluster: str, rv) -> None:
        if not cluster:
            return
        try:
            rv = int(rv)
        except (TypeError, ValueError):
            return
        if rv <= 0:
            return
        with self._lock:
            if rv > self._floor.get(cluster, 0):
                self._floor[cluster] = rv

    def floor(self, cluster: str) -> int:
        if not cluster:
            return 0
        with self._lock:
            return self._floor.get(cluster, 0)


class RestWatch:
    """Async iterator over a server watch stream, yielding store Events.

    Duck-types the parts of :class:`kcp_tpu_torch.store.store.Watch` that
    informers and syncers use: ``async for``, :meth:`next_batch`,
    :meth:`drain`, :meth:`close`.
    """

    # class-level default so a skeletal instance (tests build one via
    # ``__new__`` to drive ``_feed`` directly) still parses bookmarks
    _initial_events = False
    # session read-your-writes: when a _SessionRv rides along, every
    # observed event/bookmark RV raises the session floor (class-level
    # defaults keep skeletal __new__ instances working)
    _session = None
    _session_cluster = ""
    # source name for peer-scoped link faults (link.partition/link.delay);
    # the destination is the watched server's host:port
    link_src = "watch"

    def __init__(self, host: str, port: int, path: str, resource: str,
                 token: str = "", ssl_context=None,
                 extra_headers: dict[str, str] | None = None,
                 initial_events: bool = False,
                 session=None, session_cluster: str = ""):
        self._host = host
        self._port = port
        self._path = path
        self._token = token
        self._ssl = ssl_context
        # watch-list mode: the initial-events-end BOOKMARK is yielded
        # (instead of absorbed) so the informer knows when it is synced
        self._initial_events = initial_events
        # extra request headers (the smart client's X-Kcp-Ring-Epoch
        # stamp on direct-to-shard watches rides here)
        self._extra_headers = extra_headers or {}
        self._session = session
        self._session_cluster = session_cluster
        self.resource = resource
        self._events: asyncio.Queue[Event | None] = asyncio.Queue()
        self._task: asyncio.Task | None = None
        self._closed = False
        self.error: Exception | None = None  # set on non-2xx watch responses
        self.responded = False  # True once the server sent a status line —
        # lets consumers tell "connect refused" from "established stream
        # died" (the scenario harness's unclean-death accounting)
        self.last_rv = 0  # highest RV seen (events + bookmarks), for resume
        # chunk reassembly state (_feed): decoded-but-incomplete trailing
        # line, and an incremental UTF-8 decoder so each chunk is decoded
        # exactly once — a multi-byte sequence straddling a chunk
        # boundary is carried by the decoder, not re-scanned
        self._buf = ""
        self._decoder = codecs.getincrementaldecoder("utf-8")()

    def _ensure_started(self) -> None:
        if self._task is None and not self._closed:
            self._task = asyncio.ensure_future(self._run())

    async def _run(self) -> None:
        reader = writer = None
        try:
            # WAN-link realism: a peer-scoped partition cuts the stream at
            # connect time exactly like a refused connection (the informer
            # relists against another peer or backs off); link.delay adds
            # the configured one-way latency before the connect
            delay = link_fault(self.link_src, f"{self._host}:{self._port}")
            if delay:
                await asyncio.sleep(delay)
            reader, writer = await asyncio.open_connection(
                self._host, self._port, ssl=self._ssl,
                server_hostname=self._host if self._ssl else None)
            auth = (f"Authorization: Bearer {self._token}\r\n"
                    if self._token else "")
            extra = "".join(f"{k}: {v}\r\n"
                            for k, v in self._extra_headers.items())
            writer.write(
                f"GET {self._path} HTTP/1.1\r\nHost: {self._host}\r\n"
                f"{auth}{extra}Connection: close\r\n\r\n".encode())
            await writer.drain()
            head = await reader.readuntil(b"\r\n\r\n")
            status_line = head.split(b"\r\n", 1)[0].decode("latin-1")
            code = int(status_line.split(" ")[1])
            self.responded = True
            if code >= 400:
                body = await reader.read(64 * 1024)
                # response headers ride the error (err.http_headers) so
                # a direct-to-shard watch refusal keeps its ring-epoch
                # stamp, exactly like the request path
                hdrs: dict[str, str] = {}
                for hline in head.split(b"\r\n")[1:]:
                    if b":" in hline:
                        hk, _, hv = hline.partition(b":")
                        hdrs[hk.decode("latin-1").strip().lower()] = \
                            hv.decode("latin-1").strip()
                # strip chunked framing if present; _raise_for_status just
                # needs the JSON Status body
                try:
                    _raise_for_status(
                        code, body[body.find(b"{"):body.rfind(b"}") + 1],
                        headers=hdrs)
                except errors.ApiError as e:
                    self.error = e
                return
            while True:
                if should_drop("watch"):
                    # injected stream loss (KCP_FAULTS `watch:drop...`):
                    # die mid-stream like a dropped connection — the
                    # informer's reflector loop re-lists and re-watches
                    break
                size_line = await reader.readline()
                if not size_line:
                    break
                size = int(size_line.strip() or b"0", 16)
                if size == 0:
                    break
                chunk = await reader.readexactly(size)
                await reader.readexactly(2)  # trailing \r\n
                self._feed(chunk)
        except (ConnectionError, asyncio.IncompleteReadError, OSError,
                ValueError, IndexError):
            pass  # connection died or stream garbled → clean end-of-stream
        finally:
            if writer is not None:
                writer.close()
            self._closed = True
            self._events.put_nowait(None)

    def _feed(self, chunk: bytes) -> None:
        """Reassemble one chunk payload into complete event lines.

        The chunk is decoded to ``str`` exactly once and split in one
        pass; ``json.loads`` then parses ready text instead of
        re-detecting and re-decoding bytes per line (the server's relay
        batches event bursts into multi-line chunks, so a chunk commonly
        carries many events). The incomplete trailing line — and any
        multi-byte UTF-8 sequence the chunk boundary split — carries
        over to the next chunk."""
        lines = (self._buf + self._decoder.decode(chunk)).split("\n")
        self._buf = lines.pop()  # partial trailing line (usually empty)
        for line in lines:
            if line.strip():
                self._handle_line(json.loads(line))

    def _handle_line(self, msg: dict) -> None:
        if msg.get("type") == "ERROR":
            obj = msg.get("object") or {}
            code = obj.get("code", 410)
            reason = obj.get("reason", "")
            message = obj.get("message", "watch window expired")
            if code == 410 or reason == "Expired":
                # 410 Gone — watch window expired. Typed GoneError (a
                # ConflictError subclass, matching the in-process Watch)
                # so consumers re-list NOW instead of backoff-retrying a
                # watch that can never be served.
                self.error = errors.GoneError(message)
            else:
                # a relayed backend refusal (403 bad store token, 404,
                # 429 throttling, ...): carry the real taxonomy so
                # callers don't relist forever against a watch that can
                # never be served — and so 429s keep their pacing hint
                self.error = _status_error(code, reason, message,
                                           details=obj.get("details"))
            self._closed = True
            self._events.put_nowait(None)
            return
        if msg.get("type") == "BOOKMARK":
            # progress marker: remember the RV for resume, emit nothing —
            # EXCEPT the watch-list sync marker, which the consumer needs
            # to see to know its initial ADDED stream is complete
            meta = (msg.get("object") or {}).get("metadata") or {}
            try:
                rv = int(meta.get("resourceVersion", "0"))
                self.last_rv = rv
            except ValueError:
                rv = 0
            if self._session is not None:
                self._session.note(self._session_cluster, rv)
            if (self._initial_events and (meta.get("annotations") or {})
                    .get(INITIAL_EVENTS_END) == "true"):
                self._events.put_nowait(Event(
                    type="BOOKMARK", resource=self.resource, cluster="",
                    namespace="", name="", object=msg.get("object") or {},
                    rv=rv))
            return
        obj = msg["object"]
        meta = obj.get("metadata") or {}
        rv = int(meta.get("resourceVersion", "0"))
        self.last_rv = max(self.last_rv, rv)
        if self._session is not None:
            self._session.note(self._session_cluster
                               or meta.get("clusterName", ""), rv)
        self._events.put_nowait(Event(
            type=msg["type"],
            resource=self.resource,
            cluster=meta.get("clusterName", ""),
            namespace=meta.get("namespace", ""),
            name=meta.get("name", ""),
            object=obj,
            rv=rv,
        ))

    def __aiter__(self) -> "RestWatch":
        self._ensure_started()
        return self

    async def __anext__(self) -> Event:
        self._ensure_started()
        if self._closed and self._events.empty():
            self._raise_if_error()
            raise StopAsyncIteration
        ev = await self._events.get()
        if ev is None:
            # keep the sentinel so repeated iteration keeps terminating
            self._events.put_nowait(None)
            self._raise_if_error()
            raise StopAsyncIteration
        return ev

    def _raise_if_error(self) -> None:
        if self.error is not None:
            err, self.error = self.error, None
            raise err

    async def next_batch(self, max_wait: float = 0.05) -> list[Event]:
        self._ensure_started()
        out: list[Event] = []
        if self._closed and self._events.empty():
            self._raise_if_error()
            return out
        try:
            ev = await asyncio.wait_for(self._events.get(), timeout=max_wait)
            if ev is None:
                self._events.put_nowait(None)
                self._raise_if_error()
                return out
            out.append(ev)
        except asyncio.TimeoutError:
            return out
        out.extend(self.drain())
        return out

    def drain(self) -> list[Event]:
        out: list[Event] = []
        while not self._events.empty():
            ev = self._events.get_nowait()
            if ev is None:
                self._events.put_nowait(None)
                break
            out.append(ev)
        return out

    def pending(self) -> int:
        """Buffered event count (may include the end-of-stream sentinel);
        part of the Watch duck type — the handler's watch streamer emits
        bookmarks only when a watch has nothing pending."""
        return self._events.qsize()

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        self._closed = True
        if self._task is not None:
            self._task.cancel()
            self._task = None


class RestClient:
    """HTTP twin of :class:`kcp_tpu_torch.client.Client`."""

    # source name for peer-scoped link faults; harnesses that model a
    # specific vantage point (a router relay pool, a syncer) override it
    link_src = "client"

    def __init__(self, base_url: str, cluster: str = "admin",
                 scheme: Scheme | None = None, token: str = "",
                 ca_data: bytes | str | None = None,
                 ca_file: str | None = None):
        parts = urlsplit(base_url)
        self._host = parts.hostname or "127.0.0.1"
        self._tls = parts.scheme == "https"
        self._port = parts.port or (443 if self._tls else 80)
        self.base_url = base_url.rstrip("/")
        self.cluster = cluster
        self.scheme = scheme if scheme is not None else default_scheme()
        self.token = token  # bearer credential (RBAC-lite servers)
        self.ca_data = ca_data  # PEM trust anchor for the server's CA
        self.ca_file = ca_file
        self._ssl = None
        if self._tls:
            from .certs import client_context

            self._ssl = client_context(ca_data, ca_file)
        self._discovered: dict[str, ResourceInfo] = {}
        # _discovered is SHARED across every scoped() clone (a cheap
        # process-wide discovery cache), and RemoteStore's per-cluster
        # store-pool threads refresh it concurrently — guard it with an
        # explicit lock instead of relying on the GIL making dict ops
        # atomic (ADVICE r5). The lock is shared by the clones too;
        # refreshes run under it on the caller's own connection, so
        # holding it never waits on another client's in-flight verb.
        self._disc_lock = make_lock("rest.discovery")
        # circuit breaker per peer, SHARED by every scoped() clone (like
        # the discovery cache): a dead backend trips once and every
        # cluster-scoped client fails fast instead of each burning its
        # own 30s connect timeouts on the store-I/O executor
        self._breaker = CircuitBreaker(f"rest_{self._host}_{self._port}")
        self._conn: http.client.HTTPConnection | None = None
        # session read-your-writes floor (KCP_SESSION_RV), shared across
        # scoped() clones via the __dict__ copy; None when disabled
        self._session = _SessionRv() if _session_rv_enabled() else None

    def scoped(self, cluster: str) -> "RestClient":
        # type(self), not RestClient: a subclass's scoped clones keep the
        # subclass behavior (a SmartRestClient's clones must keep routing
        # direct — the shared ring state rides the __dict__ copy)
        c = type(self).__new__(type(self))
        c.__dict__.update(self.__dict__)  # _discovered + _disc_lock shared
        c.cluster = cluster
        c._conn = None  # connections are per-instance; ssl ctx is shared
        return c

    # ------------------------------------------------------------ plumbing

    def _roundtrip(self, method: str, path: str, payload: bytes | None,
                   headers: dict[str, str]):
        """One request over a kept-alive connection; returns
        ``(status, response, body bytes)`` — the already-read response
        object is kept only for header access — without interpreting the
        status: the JSON verbs raise through :func:`_raise_for_status`,
        the shard router relays status/headers/body verbatim.

        Retry discipline: a send-stage failure on a *reused* connection is
        the classic stale-keep-alive case and is safe to retry for any
        method (the request never reached the server). A failure while
        reading the response is only retried for GET — the server may have
        already committed a POST/PUT/DELETE, and re-sending would duplicate
        the write.

        Degraded-mode I/O: the per-peer circuit breaker fails fast
        (UnavailableError) while the peer is known-dead, counting only
        transport failures that actually propagate — a stale keep-alive
        recovered by the retry is not a dead peer, and an HTTP error
        status is the peer answering. ``rest.request`` is a KCP_FAULTS
        injection point (error/latency).
        """
        self._breaker.check()
        try:
            delay = maybe_fail("rest.request")
            # WAN-link realism: a peer-scoped partition toward this
            # server raises ConnectionError exactly where a refused
            # connect would; link.delay models the one-way wire latency
            delay += link_fault(self.link_src, f"{self._host}:{self._port}")
        except Exception:
            # injected transport failure: feed the breaker so chaos
            # schedules exercise the open/half-open transitions
            self._breaker.record_failure()
            raise
        if delay:
            time.sleep(delay)
        for attempt in (0, 1):
            reused = self._conn is not None
            if self._conn is None:
                if self._tls:
                    self._conn = http.client.HTTPSConnection(
                        self._host, self._port, timeout=30, context=self._ssl)
                else:
                    self._conn = http.client.HTTPConnection(
                        self._host, self._port, timeout=30)
            try:
                self._conn.request(method, path, body=payload, headers=headers)
            except (ConnectionError, http.client.HTTPException, OSError):
                self._conn.close()
                self._conn = None
                if reused and attempt == 0:
                    continue
                self._breaker.record_failure()
                raise
            try:
                resp = self._conn.getresponse()
                data = resp.read()
            except (ConnectionError, http.client.HTTPException, OSError):
                self._conn.close()
                self._conn = None
                if method == "GET" and attempt == 0:
                    continue
                self._breaker.record_failure()
                raise
            self._breaker.record_success()
            return resp.status, resp, data
        raise AssertionError("unreachable")

    def _request(self, method: str, path: str, body: dict | None = None) -> dict | None:
        """One JSON verb round trip (see :meth:`_roundtrip` for the retry
        and circuit-breaker discipline); raises the mapped ApiError on
        HTTP error statuses.

        Tracing: with KCP_TRACE on, the request carries a ``traceparent``
        header — the current context's child when one is installed (a
        traced caller, e.g. a syncer apply), else a freshly minted
        head-sampled root; sampled round trips record a
        ``client.request`` span. KCP_TRACE=0 skips even the header, so
        the wire is byte-identical to the pre-tracing client."""
        payload = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"} if payload else {}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        if method == "GET" and self._session is not None:
            # session read-your-writes: stamp the per-cluster floor so
            # a replica serves this read no staler than the session's
            # own writes/watch position (headers are built before
            # _roundtrip, so the smart client's direct path rides this
            # unchanged)
            floor = self._session.floor(_path_cluster(path))
            if floor:
                headers["X-Kcp-Min-Rv"] = str(floor)
        tracer = obs.TRACER
        sub = t0 = None
        if tracer.enabled:
            ctx = obs.current()
            if ctx is None and tracer.head_sampled():
                ctx = tracer.mint(sampled=True)
            if ctx is not None and ctx.sampled:
                sub = tracer.child(ctx)
                headers[obs.TRACEPARENT] = sub.header()
                t0 = time.time()
            elif ctx is not None:
                # a traced-but-unsampled caller still propagates, so a
                # downstream SLO force-record shares its trace id
                headers[obs.TRACEPARENT] = ctx.header()
        status, resp, data = self._roundtrip(method, path, payload, headers)
        if sub is not None:
            obs.record_span(
                "client.request", sub, ctx.span_id, t0, time.time() - t0,
                {"method": method, "path": path.partition("?")[0][:160],
                 "status": status})
        retry_after = None
        rheaders = None
        if status >= 400:
            # error responses keep their headers on the raised ApiError
            # (err.http_headers): Retry-After pacing and the shard's
            # X-Kcp-Ring-Epoch stamp must survive the raise so the smart
            # client's fallback sees them on the direct path too
            rheaders = {k.lower(): v for k, v in resp.getheaders()}
            if status in (429, 503, 504):
                # a throttling/shedding answer is the peer ALIVE (the
                # breaker saw record_success above); surface the pacing
                # hint instead
                try:
                    retry_after = float(rheaders.get("retry-after") or "")
                except ValueError:
                    pass
        _raise_for_status(status, data, retry_after=retry_after,
                          headers=rheaders)
        out = json.loads(data) if data else None
        if (self._session is not None
                and method in ("POST", "PUT", "DELETE")):
            # raise the session floor from the write's committed RV:
            # X-Kcp-Rv header (covers delete Status bodies), else the
            # object's own metadata.resourceVersion
            geth = getattr(resp, "getheaders", None)
            rv = (next((v for k, v in geth()
                        if k.lower() == "x-kcp-rv"), None)
                  if geth is not None else None)
            if rv is None and isinstance(out, dict):
                rv = (out.get("metadata") or {}).get("resourceVersion")
            self._session.note(_path_cluster(path), rv)
        return out

    def request_raw(self, method: str, target: str,
                    payload: bytes | None = None,
                    headers: dict[str, str] | None = None,
                    ) -> tuple[int, dict[str, str], bytes]:
        """Raw relay round trip for proxies (the shard router): the
        caller's target/body/headers go over the wire verbatim and the
        response ``(status, headers, body)`` comes back uninterpreted —
        HTTP error statuses are the peer ANSWERING and are relayed, not
        raised. Transport failures and an open circuit breaker still
        raise (the router maps those to a fail-fast 503). This client's
        configured bearer token is added only when the caller forwarded
        no Authorization of its own."""
        h = dict(headers or {})
        if self.token and not any(k.lower() == "authorization" for k in h):
            h["Authorization"] = f"Bearer {self.token}"
        status, resp, data = self._roundtrip(method, target, payload, h)
        return status, dict(resp.getheaders()), data

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def _resolve(self, resource: str) -> ResourceInfo:
        info = self.scheme.by_resource(resource)
        if info is not None:
            return info
        with self._disc_lock:
            info = self._discovered.get(resource)
        if info is not None:
            return info
        self._refresh_discovery()
        with self._disc_lock:
            info = self._discovered.get(resource)
        if info is None:
            raise errors.NotFoundError(f"resource {resource} not served")
        return info

    def _refresh_discovery(self) -> None:
        """Populate the resource→GVR map from /api + /apis discovery.

        The HTTP walk runs unlocked (on this client's own connection);
        the shared map is swapped in one locked merge so concurrent
        store-pool refreshes never interleave partial states."""
        gvs: list[tuple[str, str]] = [("", "v1")]
        groups = self._request("GET", "/apis") or {}
        for g in groups.get("groups", []):
            for v in g.get("versions", []):
                gvs.append((g["name"], v["version"]))
        found: dict[str, ResourceInfo] = {}
        for group, version in gvs:
            prefix = f"/apis/{group}/{version}" if group else f"/api/{version}"
            try:
                rlist = self._request("GET", prefix) or {}
            except errors.ApiError:
                continue
            for r in rlist.get("resources", []):
                if "/" in r["name"]:
                    continue
                gvr = GVR(group, version, r["name"])
                found[gvr.storage_name] = ResourceInfo(
                    gvr=gvr, kind=r["kind"], list_kind=r["kind"] + "List",
                    singular=r.get("singularName") or r["kind"].lower(),
                    namespaced=bool(r.get("namespaced")),
                )
        with self._disc_lock:
            self._discovered.update(found)

    def _path(self, resource: str, namespace: str | None, name: str | None = None,
              subresource: str | None = None, cluster: str | None = None,
              query: str = "") -> str:
        info = self._resolve(resource)
        gvr = info.gvr
        prefix = f"/apis/{gvr.group}/{gvr.version}" if gvr.group else f"/api/{gvr.version}"
        p = f"/clusters/{quote(cluster or self.cluster, safe='*')}" + prefix
        if namespace:
            p += f"/namespaces/{namespace}"
        p += f"/{gvr.resource}"
        if name:
            p += f"/{name}"
        if subresource:
            p += f"/{subresource}"
        if query:
            p += "?" + query
        return p

    @staticmethod
    def _resource_name(gvr: GVR | str) -> str:
        return gvr.storage_name if isinstance(gvr, GVR) else gvr

    # -------------------------------------------------------------- reads

    def get(self, gvr: GVR | str, name: str, namespace: str = "") -> dict:
        res = self._resource_name(gvr)
        return self._request("GET", self._path(res, namespace, name))

    # paged list iteration is transparent, so informers relist in
    # bounded pages — and servers that page can also watch-list
    supports_watch_list = True

    def list(self, gvr: GVR | str, namespace: str | None = None,
             selector: LabelSelector | None = None,
             limit: int | None = None) -> tuple[list[dict], int]:
        """List, paging transparently (KEP-365): ``KCP_LIST_PAGE``
        (default 10000) bounds how much any one response buffers;
        ``limit`` overrides per call; ``0`` restores the legacy one-shot
        list. The returned RV is the first page's pin — every follow-up
        page is served *at that RV*, so the concatenation is exactly the
        one-shot list. A continue token that outlives the server's watch
        window answers 410: the chunked list restarts from scratch once,
        then propagates."""
        res = self._resource_name(gvr)
        base_q = []
        if selector is not None and not selector.empty:
            base_q.append("labelSelector=" + quote(str(selector)))
        page = _list_page_size() if limit is None else limit
        if page <= 0:
            body = self._request(
                "GET", self._path(res, namespace, query="&".join(base_q)))
            rv = int((body.get("metadata") or {})
                     .get("resourceVersion", "0"))
            return body.get("items", []), rv
        items: list[dict] = []
        rv = 0
        cont = ""
        restarted = False
        while True:
            q = list(base_q) + [f"limit={page}"]
            if cont:
                q.append("continue=" + quote(cont, safe=""))
            try:
                body = self._request(
                    "GET", self._path(res, namespace, query="&".join(q)))
            except errors.GoneError:
                if not cont or restarted:
                    raise
                items, cont, rv, restarted = [], "", 0, True
                continue
            meta = body.get("metadata") or {}
            if not cont:
                rv = int(meta.get("resourceVersion", "0"))
            items.extend(body.get("items", []))
            cont = meta.get("continue") or ""
            if not cont:
                return items, rv

    def watch(self, gvr: GVR | str, namespace: str | None = None,
              selector: LabelSelector | None = None,
              since_rv: int | None = None,
              bookmarks: bool = True,
              initial_events: bool = False) -> RestWatch:
        """Open a watch stream. ``bookmarks`` (default on, KEP-1904
        style) asks the server for periodic BOOKMARK progress markers:
        RestWatch absorbs them into ``last_rv`` without yielding, so a
        stream dropped after a quiet period resumes from a fresh RV
        inside the watch window instead of 410ing into a relist.
        ``initial_events`` (KEP-3157 style) asks the server to stream
        the current state as ADDED events first, ending with a sync
        BOOKMARK that RestWatch *yields* — list+watch in one stream,
        never holding a whole list body (``since_rv`` must be None)."""
        res = self._resource_name(gvr)
        query = "watch=true"
        if selector is not None and not selector.empty:
            query += "&labelSelector=" + quote(str(selector))
        if since_rv is not None:
            query += f"&resourceVersion={since_rv}"
        if bookmarks:
            query += "&allowWatchBookmarks=true"
        if initial_events:
            query += "&sendInitialEvents=true"
        path = self._path(res, namespace, query=query)
        return RestWatch(self._host, self._port, path, res, token=self.token,
                         ssl_context=self._ssl,
                         initial_events=initial_events,
                         session=self._session,
                         session_cluster=(self.cluster
                                          if self.cluster != WILDCARD
                                          else ""))

    # ------------------------------------------------------------- writes

    def _write_cluster(self, obj: dict) -> str:
        return resolve_write_cluster(self.cluster, obj)

    def create(self, gvr: GVR | str, obj: dict, namespace: str = "") -> dict:
        res = self._resource_name(gvr)
        namespace = namespace or (obj.get("metadata") or {}).get("namespace", "")
        return self._request(
            "POST", self._path(res, namespace, cluster=self._write_cluster(obj)), obj)

    def update(self, gvr: GVR | str, obj: dict, namespace: str = "") -> dict:
        res = self._resource_name(gvr)
        meta = obj.get("metadata") or {}
        namespace = namespace or meta.get("namespace", "")
        return self._request(
            "PUT",
            self._path(res, namespace, meta["name"], cluster=self._write_cluster(obj)),
            obj)

    def update_status(self, gvr: GVR | str, obj: dict, namespace: str = "") -> dict:
        res = self._resource_name(gvr)
        meta = obj.get("metadata") or {}
        namespace = namespace or meta.get("namespace", "")
        return self._request(
            "PUT",
            self._path(res, namespace, meta["name"], "status",
                       cluster=self._write_cluster(obj)),
            obj)

    def delete(self, gvr: GVR | str, name: str, namespace: str = "",
               cluster: str | None = None) -> None:
        res = self._resource_name(gvr)
        target = cluster or self.cluster
        if target == WILDCARD:
            raise errors.InvalidError("wildcard delete requires an explicit cluster")
        self._request("DELETE", self._path(res, namespace, name, cluster=target))

    # ---------------------------------------------------------- discovery

    def resources(self) -> list[str]:
        self._refresh_discovery()
        with self._disc_lock:
            discovered = set(self._discovered)
        return sorted(discovered |
                      {i.gvr.storage_name for i in self.scheme.all()})

    def openapi_v2(self) -> dict | None:
        """Fetch the server's ``/openapi/v2`` document (None on 404)."""
        try:
            return self._request(
                "GET", f"/clusters/{quote(self.cluster, safe='*')}/openapi/v2")
        except errors.NotFoundError:
            return None


class MultiClusterRestClient(RestClient):
    """Wildcard RestClient (EnableMultiCluster analog over the wire)."""

    def __init__(self, base_url: str, scheme: Scheme | None = None,
                 token: str = "", ca_data: bytes | str | None = None,
                 ca_file: str | None = None):
        super().__init__(base_url, WILDCARD, scheme, token=token,
                         ca_data=ca_data, ca_file=ca_file)

    def cluster_client(self, cluster: str) -> RestClient:
        return self.scoped(cluster)
