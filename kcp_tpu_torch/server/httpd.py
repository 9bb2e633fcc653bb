"""Minimal asyncio HTTP/1.1 server for the control-plane REST surface.

Only what the API surface needs: request-line + header parsing,
Content-Length bodies, one-shot JSON responses, and chunked streaming
responses for watches. TLS via an ``ssl.SSLContext`` (the server's
self-signed serving certs, kcp_tpu_torch/server/certs.py — parity with the
reference's generated-cert TLS endpoint, pkg/etcd/etcd.go:98-188 +
pkg/server/server.go:151-176).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from dataclasses import dataclass
from typing import Awaitable, Callable
from urllib.parse import parse_qs, unquote, urlsplit

from ..utils.trace import REGISTRY, SIZE_BUCKETS

log = logging.getLogger(__name__)

#: stream flush operations — one buffered chunk write (plus, on the
#: non-coalesced paths, its drain round trip) per socket. The watcher-
#: scale A/B (`bench.py --watchers`) reads the per-fan-out reduction off
#: this counter.
_FLUSHES = REGISTRY.counter(
    "watch_flush_total",
    "watch-stream flush operations (one chunk write per socket)")
_FLUSH_BATCH = REGISTRY.histogram(
    "watch_flush_batch_size",
    "event lines merged into one stream flush", buckets=SIZE_BUCKETS)
#: the zero-copy wire meters: spans handed to the transport through the
#: scatter path (no whole-body b"".join), and the bytes that skipped the
#: full-body join copy because of it. `bench.py --smartclient` proves the
#: scatter path byte-identical to the join path (sha256 over the wire).
_SPANS_WRITTEN = REGISTRY.counter(
    "wire_spans_written_total",
    "encode-once byte spans written through the scatter wire path "
    "(KCP_WIRE_SCATTER) without an intermediate whole-body join")
_JOIN_AVOIDED = REGISTRY.counter(
    "wire_join_avoided_total",
    "response-body bytes written without the whole-body b''.join copy "
    "the legacy wire path paid (scatter path only)")

MAX_HEADER_BYTES = 64 * 1024
# listener accept backlog: a 10k-watcher reconnect storm lands thousands
# of TCP connects in the same instant — the asyncio default (100) would
# refuse most of the herd and stretch resume latency by retry round
# trips (kernel still caps at net.core.somaxconn)
LISTEN_BACKLOG = int(os.environ.get("KCP_LISTEN_BACKLOG", "4096"))
# request-body ceiling (KCP_MAX_BODY_BYTES): the cheapest admission
# control of all — a declared body over the limit is refused 413 before
# a single payload byte is buffered. 3 MiB default ~= the apiserver's
# etcd request ceiling; read at import, overridable per-process.
MAX_BODY_BYTES = int(os.environ.get("KCP_MAX_BODY_BYTES", str(3 * 1024 * 1024)))
# spans below this size coalesce into one bounded join before hitting
# the transport (a send syscall per 200-byte watch line would cost more
# than the copy it saves); spans at or above it go to the transport
# as-is — the writev-spirit scatter path for big encode-once spans
# (pre-joined bucket spans, large objects)
SCATTER_MIN = int(os.environ.get("KCP_WIRE_SCATTER_MIN", str(16 * 1024)))


def scatter_enabled() -> bool:
    """KCP_WIRE_SCATTER (default on): scatter/writev-style body writes —
    span lists are handed to the transport without the whole-body
    ``b"".join`` (big spans go as-is; small ones coalesce into bounded
    <= SCATTER_MIN join buffers). ``=0`` restores the single-join wire
    path for A/B; both produce byte-identical streams. Read per response
    (one dict probe) so tests and benches can flip it on a live server."""
    return os.environ.get("KCP_WIRE_SCATTER", "1").lower() not in (
        "0", "false", "off")


def _write_parts(writer: asyncio.StreamWriter, parts) -> None:
    """Write ``parts`` (framing + spans) to the transport without one
    whole-body join: spans >= SCATTER_MIN are written as-is (the bytes
    the encode cache holds are the bytes on the wire — no intermediate
    copy), smaller ones coalesce into bounded join buffers so tiny
    spans don't become per-span syscalls."""
    small: list[bytes] = []
    small_len = 0
    spans = 0
    avoided = 0
    for p in parts:
        if len(p) >= SCATTER_MIN:
            if small:
                writer.write(small[0] if len(small) == 1 else b"".join(small))
                small = []
                small_len = 0
            writer.write(p)
            spans += 1
            avoided += len(p)
        else:
            small.append(p)
            small_len += len(p)
            if small_len >= SCATTER_MIN:
                writer.write(small[0] if len(small) == 1
                             else b"".join(small))
                spans += 1
                small = []
                small_len = 0
    if small:
        writer.write(small[0] if len(small) == 1 else b"".join(small))
        spans += 1
    _SPANS_WRITTEN.inc(spans)
    if avoided:
        _JOIN_AVOIDED.inc(avoided)


class RequestTooLarge(Exception):
    """Raised by request parsing when Content-Length exceeds
    MAX_BODY_BYTES; the connection loop answers 413 and closes (the
    unread body makes the connection unusable for keep-alive)."""

    def __init__(self, size: int):
        super().__init__(f"request body {size} bytes exceeds limit")
        self.size = size


@dataclass
class Request:
    method: str
    path: str
    query: dict[str, list[str]]
    headers: dict[str, str]  # keys lower-cased
    body: bytes
    # the request target exactly as it appeared on the request line
    # (still percent-encoded, query included) — what a proxy (the shard
    # router) forwards so relayed requests stay byte-identical
    target: str = ""

    def param(self, name: str, default: str | None = None) -> str | None:
        vals = self.query.get(name)
        return vals[0] if vals else default

    def json(self):
        if not self.body:
            return None
        return json.loads(self.body)


class Response:
    """One-shot response. ``spans`` is the zero-copy body form: a list of
    byte spans whose concatenation IS the body (the handler's encode-once
    list assembly hands the cached spans straight through and the wire
    path writes them scatter-style, never paying the whole-body join).
    ``.body`` stays correct for direct consumers — it joins lazily on
    first access and memoizes; the HTTP write path checks ``spans``
    first and never triggers that join while scatter is on."""

    def __init__(self, status: int = 200, body: bytes = b"",
                 content_type: str = "application/json",
                 headers: dict[str, str] | None = None,
                 spans: list[bytes] | None = None):
        self.status = status
        self._body = body
        self.content_type = content_type
        self.headers: dict[str, str] = headers if headers is not None else {}
        self.spans = spans

    @property
    def body(self) -> bytes:
        if self.spans is not None and not self._body:
            self._body = b"".join(self.spans)
        return self._body

    @body.setter
    def body(self, value: bytes) -> None:
        self._body = value
        self.spans = None

    def body_len(self) -> int:
        """Content-Length without materializing a joined body."""
        if self.spans is not None and not self._body:
            return sum(len(s) for s in self.spans)
        return len(self._body)

    @classmethod
    def of_json(cls, obj, status: int = 200) -> "Response":
        return cls(status=status, body=json.dumps(obj).encode())


class StreamResponse:
    """A chunked-transfer streaming response (the watch wire format).

    The handler returns one of these; the connection loop then calls
    :meth:`send_json` per event until the producer finishes or the client
    disconnects.
    """

    def __init__(self, producer: Callable[["StreamResponse"], Awaitable[None]],
                 status: int = 200):
        self.status = status
        self.producer = producer
        self._writer: asyncio.StreamWriter | None = None

    async def _begin(self, writer: asyncio.StreamWriter) -> None:
        self._writer = writer
        writer.write(
            f"HTTP/1.1 {self.status} {_reason(self.status)}\r\n"
            "Content-Type: application/json\r\n"
            "Transfer-Encoding: chunked\r\n"
            "Connection: close\r\n\r\n".encode()
        )
        await writer.drain()

    async def send_json(self, obj) -> None:
        assert self._writer is not None
        data = json.dumps(obj).encode() + b"\n"
        self._writer.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        await self._writer.drain()

    async def send_json_many(self, objs) -> None:
        """All objects as ndjson lines in ONE chunk + one drain — the
        watch relay's wire-level fan-out batching. Clients reassemble by
        newline (RestWatch already splits chunk payloads on ``\\n``), so
        framing is unchanged; a burst of N events costs one syscall
        instead of N."""
        assert self._writer is not None
        if not objs:
            return
        data = b"".join(json.dumps(o).encode() + b"\n" for o in objs)
        self._writer.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        _FLUSHES.inc()
        _FLUSH_BATCH.observe(len(objs))
        await self._writer.drain()

    async def send_raw_many(self, lines) -> None:
        """Pre-encoded newline-terminated JSON lines in ONE chunk + one
        drain — the encode-once twin of :meth:`send_json_many`. The relay
        hands every watcher the same cached bytes (store.encode_event),
        so a 64-way fan-out costs one encode instead of 64; the chunked
        framing is byte-identical to the json path."""
        assert self._writer is not None
        if not lines:
            return
        self.write_raw_many(lines)
        await self._writer.drain()

    async def send_spans(self, lines) -> None:
        """The raw-spans twin of :meth:`send_json_many`: encode-once byte
        spans framed as ONE chunk and written scatter-style (no
        whole-chunk ``b"".join`` while ``KCP_WIRE_SCATTER`` is on) + one
        drain. The replication hub's batch sends ride this — a catchup
        tail of N pre-encoded WAL records costs zero re-encodes and zero
        whole-batch join copies."""
        await self.send_raw_many(lines)

    def write_raw_many(self, lines) -> None:
        """Frame pre-encoded lines as ONE chunk and buffer them on the
        transport WITHOUT draining — the :class:`FlushCoalescer`'s write
        half. Backpressure is handled by eviction (the coalescer checks
        the transport buffer against ``KCP_WATCH_BUFFER_MAX``), never by
        awaiting a slow socket. With ``KCP_WIRE_SCATTER`` on, the lines
        go to the transport as spans (bounded coalescing, no whole-chunk
        join); ``=0`` keeps the legacy single-join write — byte-identical
        either way (same bytes, same single chunk frame)."""
        assert self._writer is not None
        if not lines:
            return
        tr = self._writer.transport
        if tr is None or tr.is_closing():
            raise ConnectionResetError("stream transport closed")
        total = sum(len(ln) for ln in lines)
        if not total:
            return  # an all-empty batch must not emit a terminal 0-chunk
        if scatter_enabled():
            _write_parts(self._writer,
                         [f"{total:x}\r\n".encode(), *lines, b"\r\n"])
        else:
            data = b"".join(lines)
            self._writer.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        _FLUSHES.inc()
        _FLUSH_BATCH.observe(len(lines))

    async def relay_chunk(self, size_line: bytes, payload: bytes) -> None:
        """Forward one upstream chunk frame verbatim (the router's
        zero-parse relay): the upstream's own length-delimited framing
        and payload bytes go to the transport untouched — no decode, no
        line split, no re-frame, no join."""
        assert self._writer is not None
        tr = self._writer.transport
        if tr is None or tr.is_closing():
            raise ConnectionResetError("stream transport closed")
        self._writer.write(size_line)
        self._writer.write(payload)
        _FLUSHES.inc()
        await self._writer.drain()

    def write_buffer_size(self) -> int:
        """Bytes buffered on this stream's transport — the slow-client
        signal the coalescer's eviction policy reads."""
        w = self._writer
        if w is None or w.transport is None:
            return 0
        try:
            return w.transport.get_write_buffer_size()
        except Exception:  # noqa: BLE001 — transport torn down mid-call
            return 0

    async def _finish(self) -> None:
        if self._writer is not None:
            try:
                self._writer.write(b"0\r\n\r\n")
                await self._writer.drain()
            except (ConnectionError, RuntimeError):
                pass


class FlushCoalescer:
    """Batches watch-stream writes across many sockets into one
    event-loop pass (``KCP_WATCH_COALESCE``).

    Producers call ``await write(stream, lines)``; lines park per-stream
    and the whole map flushes after one coalescing tick
    (``KCP_WATCH_FLUSH_MS``): each socket gets ONE joined chunk write
    per tick no matter how many event batches accumulated, so a
    sustained fan-out to N watchers costs O(sockets) buffered writes of
    shared encode-once bytes per tick instead of O(batches × watchers)
    write+drain round trips.

    Backpressure is by eviction, not drain: the flush never awaits a
    slow socket. A stream whose transport buffer exceeds ``buffer_max``
    (``KCP_WATCH_BUFFER_MAX``) resolves its producer's future ``False``
    — the producer ends the stream with a terminal typed 410 and the
    informer's relist-NOW path takes over. Everyone else's tick is never
    held hostage by the slowest reader.
    """

    def __init__(self, tick_s: float = 0.002,
                 buffer_max: int = 2 * 1024 * 1024):
        self.tick_s = tick_s
        self.buffer_max = buffer_max
        self._pending: dict[StreamResponse,
                            tuple[list[bytes], asyncio.Future]] = {}
        self._scheduled = False

    def write(self, stream: StreamResponse, lines) -> "asyncio.Future[bool]":
        """Park ``lines`` for ``stream``; the returned future resolves
        True once flushed (False = over the buffer bound: evict)."""
        loop = asyncio.get_running_loop()
        ent = self._pending.get(stream)
        if ent is None:
            ent = self._pending[stream] = ([], loop.create_future())
        ent[0].extend(lines)
        if not self._scheduled:
            self._scheduled = True
            if self.tick_s > 0:
                loop.call_later(self.tick_s, self._flush)
            else:
                loop.call_soon(self._flush)
        return ent[1]

    def _flush(self) -> None:
        self._scheduled = False
        pending, self._pending = self._pending, {}
        for stream, (lines, fut) in pending.items():
            if fut.done():
                continue  # producer cancelled (client went away)
            try:
                stream.write_raw_many(lines)
            except Exception as e:  # noqa: BLE001 — surfaced to the producer
                fut.set_exception(e)
                continue
            fut.set_result(stream.write_buffer_size() <= self.buffer_max)


_REASONS = {200: "OK", 201: "Created", 400: "Bad Request", 403: "Forbidden",
            404: "Not Found", 405: "Method Not Allowed", 409: "Conflict",
            410: "Gone", 413: "Request Entity Too Large",
            422: "Unprocessable Entity", 429: "Too Many Requests",
            500: "Internal Server Error", 503: "Service Unavailable"}


def _reason(status: int) -> str:
    return _REASONS.get(status, "Unknown")


Handler = Callable[[Request], Awaitable["Response | StreamResponse"]]


class HttpServer:
    """asyncio.start_server wrapper dispatching to a single handler."""

    def __init__(self, handler: Handler, host: str = "127.0.0.1", port: int = 0,
                 ssl_context=None):
        self.handler = handler
        self.host = host
        self.port = port
        self.ssl_context = ssl_context
        self._server: asyncio.AbstractServer | None = None
        self._conns: set[asyncio.Task] = set()
        # graceful drain state: once draining, the listener is closed
        # (late connections are refused at the TCP level), idle
        # keep-alive connections are torn down, and in-flight responses
        # force ``Connection: close``
        self._draining = False
        self._idle: set[asyncio.StreamWriter] = set()
        self._busy = 0  # requests currently between parse and response

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._serve, self.host, self.port, ssl=self.ssl_context,
            backlog=LISTEN_BACKLOG)
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("http%s server listening on %s:%d",
                 "s" if self.ssl_context else "", self.host, self.port)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # long-lived watch streams never finish on their own — cancel
            # them or wait_closed() blocks forever
            for task in list(self._conns):
                task.cancel()
            await asyncio.gather(*self._conns, return_exceptions=True)
            await self._server.wait_closed()
            self._server = None

    @property
    def address(self) -> str:
        scheme = "https" if self.ssl_context else "http"
        return f"{scheme}://{self.host}:{self.port}"

    # ------------------------------------------------------------- drain

    def begin_drain(self) -> None:
        """Stop accepting work: close the listener (late connections are
        refused), tear down idle keep-alive connections, and mark every
        in-flight response ``Connection: close``. In-flight requests and
        open streams keep running — :meth:`finish_drain` bounds them."""
        self._draining = True
        if self._server is not None:
            self._server.close()
        for w in list(self._idle):
            try:
                w.close()
            except Exception:  # noqa: BLE001 — already-dead transport
                pass

    async def wait_requests_idle(self, deadline: float) -> bool:
        """Wait until no request is between parse and response write
        (watch streams excluded — they end via the handler's drain
        signal). Returns False if the deadline expired first."""
        loop = asyncio.get_running_loop()
        while self._busy > 0:
            if loop.time() >= deadline:
                return False
            await asyncio.sleep(0.005)
        return True

    async def finish_drain(self, deadline: float) -> int:
        """Wait for every connection task to finish (stream producers
        end once the handler's draining signal is set); tasks still
        alive at the deadline are cancelled. Returns the forced count."""
        forced = 0
        conns = set(self._conns)
        if conns:
            loop = asyncio.get_running_loop()
            timeout = max(0.0, deadline - loop.time())
            _done, pending = await asyncio.wait(conns, timeout=timeout)
            for t in pending:
                t.cancel()
                forced += 1
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None
        return forced

    async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._conns.add(task)
            task.add_done_callback(self._conns.discard)
        try:
            while True:
                self._idle.add(writer)
                try:
                    req = await self._read_request(reader)
                except RequestTooLarge as e:
                    # 413 instead of buffering: the body was never read,
                    # so answer and close rather than resynchronize
                    body = json.dumps({
                        "kind": "Status", "apiVersion": "v1",
                        "status": "Failure",
                        "reason": "RequestEntityTooLarge",
                        "message": (f"request body of {e.size} bytes exceeds "
                                    f"the {MAX_BODY_BYTES}-byte limit "
                                    f"(KCP_MAX_BODY_BYTES)"),
                        "code": 413,
                    }).encode()
                    writer.write(
                        f"HTTP/1.1 413 {_reason(413)}\r\n"
                        "Content-Type: application/json\r\n"
                        f"Content-Length: {len(body)}\r\n"
                        "Connection: close\r\n\r\n".encode() + body)
                    await writer.drain()
                    break
                finally:
                    self._idle.discard(writer)
                if req is None:
                    break
                keep = True
                self._busy += 1
                try:
                    try:
                        resp = await self.handler(req)
                    except Exception:  # handler bug — surface as 500, keep serving
                        log.exception("handler error for %s %s",
                                      req.method, req.path)
                        resp = Response.of_json(
                            {"kind": "Status", "status": "Failure",
                             "reason": "InternalError", "code": 500}, 500)
                    if not isinstance(resp, StreamResponse):
                        # draining forces Connection: close so keep-alive
                        # clients re-resolve instead of queueing more
                        # requests on a server that is going away
                        keep = (req.headers.get("connection", "keep-alive")
                                != "close") and not self._draining
                        head = (
                            f"HTTP/1.1 {resp.status} {_reason(resp.status)}\r\n"
                            f"Content-Type: {resp.content_type}\r\n"
                            f"Content-Length: {resp.body_len()}\r\n"
                        )
                        for k, v in resp.headers.items():
                            head += f"{k}: {v}\r\n"
                        head += ("Connection: "
                                 f"{'keep-alive' if keep else 'close'}\r\n\r\n")
                        if resp.spans is not None and scatter_enabled():
                            # zero-copy body: the encode-once spans go to
                            # the transport without the whole-body join
                            _write_parts(writer,
                                         [head.encode(), *resp.spans])
                        else:
                            writer.write(head.encode() + resp.body)
                        await writer.drain()
                finally:
                    self._busy -= 1
                if isinstance(resp, StreamResponse):
                    await resp._begin(writer)
                    # watch the socket for client disconnect: an idle stream
                    # never writes, so EOF would otherwise go unnoticed and
                    # the producer (and its store subscription) would leak
                    monitor = asyncio.ensure_future(reader.read(1))
                    producer = asyncio.ensure_future(resp.producer(resp))
                    try:
                        await asyncio.wait({monitor, producer},
                                           return_when=asyncio.FIRST_COMPLETED)
                    finally:
                        for t in (monitor, producer):
                            t.cancel()
                        results = await asyncio.gather(
                            monitor, producer, return_exceptions=True)
                        for r in results:
                            if isinstance(r, Exception) and not isinstance(
                                r, (asyncio.CancelledError, ConnectionError)
                            ):
                                log.error(
                                    "stream producer failed", exc_info=r)
                    await resp._finish()
                    break  # streams always close the connection
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            pass
        except asyncio.CancelledError:
            # server stop cancelled this connection task: a graceful TLS
            # close would block on the peer's close_notify until the SSL
            # shutdown timeout (observed: 30s per idle keep-alive conn) —
            # abort the transport so stop() returns promptly
            transport = writer.transport
            if transport is not None:
                transport.abort()
            raise
        finally:
            try:
                # graceful close: unbounded, so large in-flight responses
                # to slow readers always flush fully
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, RuntimeError, TimeoutError,
                    asyncio.CancelledError):
                pass

    async def _read_request(self, reader: asyncio.StreamReader) -> Request | None:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, ConnectionError):
            return None
        if len(head) > MAX_HEADER_BYTES:
            return None
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, _version = lines[0].split(" ", 2)
        except ValueError:
            return None
        headers: dict[str, str] = {}
        for line in lines[1:]:
            if not line:
                continue
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
        body = b""
        clen = int(headers.get("content-length", "0") or "0")
        if clen:
            if clen > MAX_BODY_BYTES:
                raise RequestTooLarge(clen)
            body = await reader.readexactly(clen)
        parts = urlsplit(target)
        return Request(
            method=method.upper(),
            path=unquote(parts.path),
            query=parse_qs(parts.query),
            headers=headers,
            body=body,
            target=target,
        )
