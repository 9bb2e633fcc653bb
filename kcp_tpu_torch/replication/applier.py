"""ReplicationApplier: the follower side of WAL shipping.

Runs on a replica or standby server's event loop, keeps one chunked
feed connection to the primary (``GET /replication/wal``), and applies
every shipped record into the local store at the primary's exact RVs —
watch events fan out locally (replica informers stay live), the record
lands in the local WAL (replica durability), and ``repl_applied_rv`` /
``repl_lag_records`` make the follower's honesty observable.

Standby promotion rides the PR 2 circuit machinery: when the feed dies,
the applier probes the primary's ``/healthz`` through a
:class:`~kcp_tpu_torch.utils.circuit.CircuitBreaker`; once the breaker is OPEN
and stays open past the hysteresis window, the standby promotes — bumps
the replication epoch (persisted with the WAL), opens the store for
writes, and fences the old primary (best-effort POST
``/replication/fence`` retried in the background) so a zombie coming
back cannot commit.

``repl.apply`` (error = the apply loop drops the connection and
re-resumes from the applied RV) and ``repl.promote`` (error = the
promotion attempt aborts and retries after the next probe cycle) are
KCP_FAULTS injection points.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import logging
import time
from urllib.parse import urlsplit

from .. import obs
from ..faults import link_fault, maybe_fail
from ..server.rest import RestWatch, _status_error
from ..utils import errors
from ..utils.circuit import CircuitBreaker
from ..utils.trace import REGISTRY

log = logging.getLogger(__name__)


class _FeedStream(RestWatch):
    """The replication feed as parsed ndjson messages (reuses the
    RestWatch chunked-transfer reassembly; the Event wrapping of the
    watch wire format does not apply here)."""

    def _handle_line(self, msg: dict) -> None:
        self._events.put_nowait(msg)

    async def next(self) -> dict | None:
        self._ensure_started()
        if self._closed and self._events.empty():
            return None
        item = await self._events.get()
        if item is None:
            self._events.put_nowait(None)
            return None
        return item

    def drain_msgs(self) -> list[dict]:
        out: list[dict] = []
        while not self._events.empty():
            item = self._events.get_nowait()
            if item is None:
                self._events.put_nowait(None)
                break
            out.append(item)
        return out


class ReplicationApplier:
    """Follow a primary's WAL feed into a local LogicalStore."""

    def __init__(self, store, primary_url: str, role: str = "replica",
                 token: str = "", ca_data=None, ca_file: str | None = None,
                 hysteresis_s: float = 3.0, probe_interval_s: float = 0.3,
                 on_promote=None):
        if role not in ("replica", "standby"):
            raise ValueError(f"unknown replication role {role!r}")
        self.store = store
        # ``primary_url`` may be a comma-separated CANDIDATE list
        # (url1,url2 — the KCP_PRIMARY form): the first entry is the
        # configured primary; a replica whose primary stays dead or
        # fenced past the hysteresis window probes the candidates in
        # order and re-homes onto whichever one answers as the live
        # primary (the promoted standby after a failover)
        self.candidates = [u.strip().rstrip("/")
                           for u in primary_url.split(",") if u.strip()]
        if not self.candidates:
            raise ValueError("replication applier needs a primary URL")
        self.role = role
        self.token = token
        self._ca_data = ca_data
        self._ca_file = ca_file
        self.hysteresis_s = hysteresis_s
        self.probe_interval_s = probe_interval_s
        self.on_promote = on_promote
        self.promoted = False
        self.connected = False
        self.last_seen_rv = 0  # primary's rv from the stream header/records
        self._sub_id: int | None = None
        self._stream_epoch = 0
        self._task: asyncio.Task | None = None
        self._fence_task: asyncio.Task | None = None
        self._stopped = False
        # RV-barrier waiters (KEP-2340 consistent reads): rv -> shared
        # future resolved when applied_rv reaches it. Same coalescing
        # discipline as the hub's semi-sync waiters.
        self._barrier_futs: dict[int, asyncio.Future] = {}
        # recent apply throughput (records/s, EWMA over feed batches) —
        # the denominator of the lag-shed Retry-After hint
        self._apply_rate = 0.0
        self._rate_t0 = 0.0
        self._set_primary(self.candidates[0])
        self._rehomes = REGISTRY.counter(
            "repl_rehome_total",
            "times a follower re-resolved its feed onto another primary "
            "candidate (the promoted standby after a failover)")
        self._applied_gauge = REGISTRY.gauge(
            "repl_applied_rv",
            "highest primary RV this follower has applied")
        self._lag_gauge = REGISTRY.gauge(
            "repl_lag_records",
            "records between the primary's last seen RV and this "
            "follower's applied RV")
        self._applied_total = REGISTRY.counter(
            "repl_apply_records_total",
            "WAL records applied from the replication feed")
        self._frontier_gauge = REGISTRY.gauge(
            "repl_frontier_rv",
            "primary's commit RV as last seen by this follower (stream "
            "header, records, or PROGRESS heartbeats)")

    def _set_primary(self, url: str) -> None:
        """Point the feed/probe/ack/fence plumbing at ``url`` (the
        initial primary, or a re-homed candidate) with a fresh breaker —
        the new primary must not inherit the dead one's open circuit."""
        self.primary_url = url
        parts = urlsplit(url)
        self._host = parts.hostname or "127.0.0.1"
        self._tls = parts.scheme == "https"
        self._port = parts.port or (443 if self._tls else 80)
        self._ssl = None
        if self._tls:
            from ..server.certs import client_context

            self._ssl = client_context(self._ca_data, self._ca_file)
        # the primary-death detector: transport probes through a breaker,
        # exactly like any other dead-peer detection in this codebase
        self.breaker = CircuitBreaker(
            f"repl_primary_{self._host}_{self._port}", failure_threshold=3,
            reset_timeout=self.probe_interval_s)

    # ------------------------------------------------------------ public

    @property
    def applied_rv(self) -> int:
        return self.store.resource_version

    @property
    def lag_records(self) -> int:
        return max(0, self.last_seen_rv - self.store.resource_version)

    @property
    def frontier_rv(self) -> int:
        """The primary's commit frontier as last observed (header, WAL
        records, or PROGRESS heartbeats on an idle feed)."""
        return max(self.last_seen_rv, self.store.resource_version)

    @property
    def apply_rate(self) -> float:
        """Recent apply throughput in records/s (0.0 until measured)."""
        return self._apply_rate

    async def wait_applied(self, rv: int, timeout_s: float) -> bool:
        """RV-barrier for consistent reads: park until this follower's
        applied RV reaches ``rv`` or ``timeout_s`` expires. Waiters at
        the same RV share one future (the hub semi-sync discipline).
        True when the barrier is satisfied; False on timeout — the
        caller answers the typed 504 and the read falls back to the
        primary.

        Fast-fail: when ``rv`` is above the frontier AND the feed is
        down, no in-flight record can ever satisfy the barrier — the
        progress-notify frontier is exactly the proof that this
        follower has never even seen the RV. Parking the full window
        would only slow the caller's fallback (a dead primary mid
        failover would turn every pinned read into a full timeout)."""
        if self.store.resource_version >= rv or self.promoted:
            return True
        if rv > self.frontier_rv and not self.connected:
            return False
        # reachability: the EWMA apply rate bounds how far this
        # follower can catch up inside the window — a barrier that is
        # provably out of reach (2x slack for bursty batches) answers
        # immediately too. A wrong fast-fail only costs one primary
        # read; a doomed park costs the caller the whole window on
        # every read while the follower is drowning
        rate = self._apply_rate
        if rate > 0.0 and (rv - self.store.resource_version) \
                > rate * timeout_s * 2.0:
            return False
        fut = self._barrier_futs.get(rv)
        if fut is None or fut.done():
            fut = asyncio.get_running_loop().create_future()
            self._barrier_futs[rv] = fut
        try:
            # shield: the shared future must survive one reader's timeout
            await asyncio.wait_for(asyncio.shield(fut), timeout=timeout_s)
            # releases fire on apply, promote, AND stop: re-check rather
            # than trusting the future (a stop-path release must not
            # pretend the barrier was reached)
            return self.store.resource_version >= rv or self.promoted
        except asyncio.TimeoutError:
            return self.store.resource_version >= rv

    def _release_barriers(self) -> None:
        if not self._barrier_futs:
            return
        applied = self.store.resource_version
        for rv in [r for r, f in self._barrier_futs.items()
                   if r <= applied or f.done()]:
            fut = self._barrier_futs.pop(rv)
            if not fut.done():
                fut.set_result(True)

    def _release_all_barriers(self) -> None:
        """Promotion/shutdown: nothing will ever apply again on this
        path — release every parked reader (they re-check applied_rv)."""
        for fut in self._barrier_futs.values():
            if not fut.done():
                fut.set_result(True)
        self._barrier_futs.clear()

    async def start(self) -> None:
        self._task = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        self._stopped = True
        self._release_all_barriers()
        for t in (self._task, self._fence_task):
            if t is not None:
                t.cancel()
                try:
                    await t
                except (asyncio.CancelledError, Exception):
                    pass
        self._task = self._fence_task = None

    # -------------------------------------------------------------- loop

    async def _run(self) -> None:
        down_since: float | None = None
        loop = asyncio.get_running_loop()
        while not self._stopped and not self.promoted:
            try:
                streamed = await self._follow_once()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # injected apply faults, garbled feed
                log.warning("replication feed error: %s", e)
                streamed = False
            if self._stopped or self.promoted:
                return
            if streamed:
                down_since = None  # we WERE connected; restart the clock
            info = await loop.run_in_executor(None, self._probe_blocking,
                                              None)
            # a reachable primary is healthy for a standby (promotion is
            # about primary DEATH); a replica additionally treats a
            # FENCED primary as gone — its feed can never commit again,
            # so the re-home clock runs even though the process answers
            healthy = info is not None
            if healthy and self.role == "replica" and info.get("fenced"):
                healthy = False
            if healthy:
                self.breaker.record_success()
                down_since = None
            else:
                self.breaker.record_failure()
                if down_since is None:
                    down_since = loop.time()
                from ..utils.circuit import OPEN

                if (self.breaker.state == OPEN
                        and loop.time() - down_since >= self.hysteresis_s):
                    if self.role == "standby":
                        try:
                            await self._promote()
                            return
                        except asyncio.CancelledError:
                            raise
                        except Exception as e:
                            # injected repl.promote fault (or a transient
                            # persistence failure): retry next cycle — the
                            # hysteresis clock keeps running
                            log.warning("promotion attempt aborted: %s", e)
                    elif len(self.candidates) > 1:
                        # replica re-homing: the configured primary is
                        # dead or fenced past hysteresis — probe the
                        # candidate list for the promoted primary and
                        # follow the live epoch
                        if await loop.run_in_executor(
                                None, self._rehome_blocking):
                            down_since = None
            await asyncio.sleep(self.probe_interval_s)

    def _probe_blocking(self, url: str | None = None) -> dict | None:
        """One short-timeout ``/replication/status`` probe (executor
        thread) — the liveness AND role/epoch/fence oracle; None when
        unreachable. ``url`` overrides the current primary (candidate
        probes during re-homing)."""
        if url is None:
            host, port = self._host, self._port
            tls, ssl_ctx = self._tls, self._ssl
        else:
            parts = urlsplit(url)
            host = parts.hostname or "127.0.0.1"
            tls = parts.scheme == "https"
            port = parts.port or (443 if tls else 80)
            ssl_ctx = None
            if tls:
                from ..server.certs import client_context

                ssl_ctx = client_context(self._ca_data, self._ca_file)
        conn = None
        try:
            # a peer-scoped link.partition makes the probe target
            # unreachable from THIS follower (ConnectionError -> None),
            # which is what drives the breaker open and the promotion
            d = link_fault(self.role, f"{host}:{port}")
            if d:
                time.sleep(d)
            if tls:
                conn = http.client.HTTPSConnection(
                    host, port, timeout=1.0, context=ssl_ctx)
            else:
                conn = http.client.HTTPConnection(host, port, timeout=1.0)
            conn.request("GET", "/replication/status")
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                return None
            out = json.loads(body)
            return out if isinstance(out, dict) else None
        except (ConnectionError, OSError, http.client.HTTPException,
                ValueError):
            return None
        finally:
            if conn is not None:
                conn.close()

    def _rehome_blocking(self) -> bool:
        """Probe the candidate list in order and adopt the first live,
        unfenced PRIMARY at our epoch or newer (the promoted standby
        after a failover; an older epoch is a zombie). Runs on the
        executor thread the probe loop already awaits, so the feed task
        never observes a half-switched primary. True when re-pointed."""
        for url in self.candidates:
            if url == self.primary_url:
                continue
            info = self._probe_blocking(url)
            if info is None or info.get("fenced"):
                continue
            if info.get("role") != "primary":
                continue  # an unpromoted standby cannot feed us writes yet
            if int(info.get("epoch", 0) or 0) < self.store.epoch:
                continue  # a fenced-epoch zombie answering before its fence
            log.warning("re-homing replication feed: %s -> %s (epoch %s)",
                        self.primary_url, url, info.get("epoch"))
            self._set_primary(url)
            self._rehomes.inc()
            return True
        return False

    async def _follow_once(self) -> bool:
        """One feed connection: catch up, then apply live records until
        the stream dies. Returns True if the stream delivered a valid
        header (i.e. the primary was alive at some point)."""
        query = (f"sinceRV={self.store.resource_version}"
                 f"&epoch={self.store.epoch}&role={self.role}")
        ws = _FeedStream(self._host, self._port,
                         f"/replication/wal?{query}", "",
                         token=self.token, ssl_context=self._ssl)
        got_header = False
        in_snapshot = False

        async def _link_sentinel() -> None:
            # WAN realism: a peer-scoped partition must sever an
            # ESTABLISHED feed, not just refuse new connects — an idle
            # stream would otherwise keep a partitioned standby happy
            # forever and promotion would never fire. Poll the link
            # fault point and kill the stream the moment the path to
            # the primary is cut (real TCP would time out the same way).
            while True:
                await asyncio.sleep(self.probe_interval_s)
                try:
                    link_fault(self.role, f"{self._host}:{self._port}")
                except ConnectionError:
                    ws.close()
                    return

        sentinel = asyncio.ensure_future(_link_sentinel())
        try:
            while True:
                msg = await ws.next()
                if msg is None:
                    self.connected = False
                    return got_header
                batch = [msg, *ws.drain_msgs()]
                delay = maybe_fail("repl.apply")
                if delay:
                    await asyncio.sleep(delay)
                applied = 0
                for m in batch:
                    mtype = m.get("type")
                    if mtype == "HEADER":
                        got_header = True
                        self.connected = True
                        self._sub_id = m.get("sub")
                        self._stream_epoch = int(m.get("epoch", 0))
                        if self._stream_epoch < self.store.epoch:
                            # a zombie primary from a fenced epoch: its
                            # feed must not rewind us (the hub normally
                            # self-fences first, but never trust a wire)
                            REGISTRY.counter(
                                "repl_fenced_writes_total").inc()
                            raise errors.GoneError(
                                f"feed epoch {self._stream_epoch} < local "
                                f"epoch {self.store.epoch}; refusing")
                        if self._stream_epoch > self.store.epoch:
                            self.store.set_epoch(self._stream_epoch)
                        self.last_seen_rv = max(self.last_seen_rv,
                                                int(m.get("rv", 0)))
                        if m.get("snapshot"):
                            in_snapshot = True
                            self.store.reset_for_resync()
                    elif mtype == "SNAP":
                        self.store.load_snapshot_object(m["key"], m["obj"])
                    elif mtype == "BARRIER":
                        in_snapshot = False
                        self.store.finish_resync(int(m["rv"]))
                        applied += 1
                    elif mtype == "PROGRESS":
                        # bodyless frontier heartbeat: the primary is
                        # quiet but alive — advance the frontier so
                        # repl_lag stays honest between records and
                        # RV-barrier reads can resolve "consistent"
                        self.last_seen_rv = max(self.last_seen_rv,
                                                int(m.get("rv", 0)))
                    elif mtype == "ERROR":
                        obj = m.get("object") or {}
                        raise _status_error(obj.get("code", 410),
                                            obj.get("reason", ""),
                                            obj.get("message", ""))
                    else:  # a WAL record
                        rv = int(m.get("rv", 0))
                        self.last_seen_rv = max(self.last_seen_rv, rv)
                        tctx = obs.ctx_from_wal(m.get("tc"))
                        t0 = time.time() if tctx is not None else 0.0
                        if self.store.apply_replicated(
                                m, epoch=self._stream_epoch):
                            applied += 1
                        if tctx is not None:
                            # the primary's sampled write rides the
                            # record: this follower's apply lands in ITS
                            # buffer under the same trace id, assembled
                            # by the router's /debug/trace scatter
                            obs.record_span(
                                "repl.apply", obs.TRACER.child(tctx),
                                tctx.span_id, t0, time.time() - t0,
                                {"rv": str(rv), "role": self.role})
                if applied:
                    self._applied_total.inc(applied)
                    now = time.monotonic()
                    if self._rate_t0:
                        dt = max(1e-6, now - self._rate_t0)
                        inst = applied / dt
                        self._apply_rate = (
                            inst if self._apply_rate == 0.0
                            else 0.7 * self._apply_rate + 0.3 * inst)
                    self._rate_t0 = now
                self._applied_gauge.set(self.store.resource_version)
                self._lag_gauge.set(self.lag_records)
                self._frontier_gauge.set(self.frontier_rv)
                self._release_barriers()
                if applied and not in_snapshot and self.role == "standby" \
                        and self._sub_id is not None:
                    await self._send_ack()
        finally:
            sentinel.cancel()
            ws.close()
            self.connected = False

    async def _send_ack(self) -> None:
        """Report the applied RV to the primary (semi-sync commits)."""
        sid, rv = self._sub_id, self.store.resource_version
        await asyncio.get_running_loop().run_in_executor(
            None, self._ack_blocking, sid, rv)

    def _ack_blocking(self, sid: int, rv: int) -> None:
        conn = None
        try:
            d = link_fault(self.role, f"{self._host}:{self._port}")
            if d:
                time.sleep(d)
            if self._tls:
                conn = http.client.HTTPSConnection(
                    self._host, self._port, timeout=5.0, context=self._ssl)
            else:
                conn = http.client.HTTPConnection(
                    self._host, self._port, timeout=5.0)
            body = json.dumps({"sub": sid, "rv": rv}).encode()
            headers = {"Content-Type": "application/json"}
            if self.token:
                headers["Authorization"] = f"Bearer {self.token}"
            conn.request("POST", "/replication/ack", body=body,
                         headers=headers)
            conn.getresponse().read()
        except (ConnectionError, OSError, http.client.HTTPException):
            pass  # best-effort: a lost ack only delays the sync floor
        finally:
            if conn is not None:
                conn.close()

    # --------------------------------------------------------- promotion

    async def _promote(self) -> None:
        """Fence the old epoch, open for writes, become the primary."""
        delay = maybe_fail("repl.promote")
        if delay:
            await asyncio.sleep(delay)
        new_epoch = self.store.epoch + 1
        self.store.set_epoch(new_epoch)  # durable BEFORE serving writes
        self.store.read_only = None
        self.store.fenced = False
        self.store.reject_future_rv = False
        self.promoted = True
        self._release_all_barriers()
        REGISTRY.counter(
            "repl_promotions_total",
            "standby promotions to primary").inc()
        log.warning("standby PROMOTED to primary at epoch %d (rv %d); "
                    "fencing %s", new_epoch, self.store.resource_version,
                    self.primary_url)
        if self.on_promote is not None:
            self.on_promote()
        self._fence_task = asyncio.ensure_future(
            self._fence_old_primary(new_epoch))

    async def _fence_old_primary(self, epoch: int) -> None:
        """Best-effort fence of the superseded primary, retried with
        backoff: if the old process ever comes back as a zombie, its
        store goes read-only before a client can land a write on it."""
        backoff = 0.5
        while not self._stopped:
            ok = await asyncio.get_running_loop().run_in_executor(
                None, self._fence_blocking, epoch)
            if ok:
                log.info("old primary %s fenced at epoch %d",
                         self.primary_url, epoch)
                return
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, 5.0)

    def _fence_blocking(self, epoch: int) -> bool:
        conn = None
        try:
            # the partition-during-promotion drill's key property: while
            # the old primary is unreachable the fence retries fail here,
            # and the fence must still land once the link heals
            d = link_fault(self.role, f"{self._host}:{self._port}")
            if d:
                time.sleep(d)
            if self._tls:
                conn = http.client.HTTPSConnection(
                    self._host, self._port, timeout=2.0, context=self._ssl)
            else:
                conn = http.client.HTTPConnection(
                    self._host, self._port, timeout=2.0)
            body = json.dumps({"epoch": epoch}).encode()
            headers = {"Content-Type": "application/json"}
            if self.token:
                headers["Authorization"] = f"Bearer {self.token}"
            conn.request("POST", "/replication/fence", body=body,
                         headers=headers)
            resp = conn.getresponse()
            resp.read()
            return 200 <= resp.status < 300
        except (ConnectionError, OSError, http.client.HTTPException):
            return False
        finally:
            if conn is not None:
                conn.close()
