"""Seeded workloads + honest accounting: writers, observers, ledgers.

The determinism contract: the full op schedule is a pure function of
``(seed, spec)`` — generated up front, hashed into the scorecard, and
replayed identically on the same seed. Execution timing varies run to
run (real HTTP, real restarts); the *schedule* and the derived
final-state expectation never do.

Accounting is the point of the harness, so it is explicit:

- every acknowledged write is a ledger entry ``(tenant, name, rv,
  kind, t_ack)`` — "zero lost acked writes" is checked against a fold
  of the schedule, never against what the server claims;
- every observer is a raw watch stream with the client-side resume
  discipline spelled out (terminal drain Status → resume from
  ``last_rv``; abrupt death → resume, counting the breach; 410 →
  relist, counting the unrecoverable gap), so "zero lost watch events"
  distinguishes *delivered late* from *never delivered*;
- client-visible 5xx/429/ambiguous outcomes are counted per phase —
  the error-budget SLOs read these, not server metrics.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import random
import threading
import time
from dataclasses import dataclass, field

from .. import obs
from ..server.rest import RestClient
from ..utils import errors

RESOURCE = "configmaps"
NAMESPACE = "default"


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Op:
    tenant: str
    kind: str   # create | update | delete
    name: str
    step: int


def tenant_name(i: int) -> str:
    return f"t{i}"


def build_schedule(seed: int, spec) -> dict[str, list[list[Op]]]:
    """phase -> per-tenant op lists, derived from the seed alone.

    Each (tenant, phase) stream has its own PRNG keyed by name, so a
    scaled run changes other tenants' schedules not at all — the same
    per-point independence discipline as the fault injector."""
    out: dict[str, list[list[Op]]] = {}
    for phase in spec.phases:
        per_tenant: list[list[Op]] = []
        for ti in range(spec.tenants):
            t = tenant_name(ti)
            rng = random.Random(f"{seed}:{spec.name}:{phase.name}:{t}")
            live: list[str] = []
            counter = 0
            ops: list[Op] = []
            for step in range(phase.ops_per_tenant):
                roll = rng.random()
                if live and roll < 0.15:
                    name = live.pop(rng.randrange(len(live)))
                    ops.append(Op(t, "delete", name, step))
                elif live and roll < 0.45:
                    name = live[rng.randrange(len(live))]
                    ops.append(Op(t, "update", name, step))
                else:
                    name = f"{t}-{phase.name}-{counter}"
                    counter += 1
                    live.append(name)
                    ops.append(Op(t, "create", name, step))
            per_tenant.append(ops)
        out[phase.name] = per_tenant
    return out


def schedule_hash(seed: int, spec, schedule: dict) -> str:
    doc = {
        "seed": seed,
        "scenario": spec.name,
        "phases": [{"name": p.name, "faults": p.faults, "action": p.action}
                   for p in spec.phases],
        "ops": {ph: [[(o.kind, o.name) for o in ops] for ops in tenants]
                for ph, tenants in schedule.items()},
    }
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode()).hexdigest()[:16]


def expected_final_state(schedule: dict, spec) -> dict[str, set[str]]:
    """Fold the full schedule: tenant -> names that must exist at the
    end (the authority "zero lost acked writes" is checked against)."""
    expect: dict[str, set[str]] = {tenant_name(i): set()
                                   for i in range(spec.tenants)}
    for phase in spec.phases:
        for ops in schedule[phase.name]:
            for op in ops:
                if op.kind == "delete":
                    expect[op.tenant].discard(op.name)
                else:
                    expect[op.tenant].add(op.name)
    return expect


# ---------------------------------------------------------------------------
# writer ledger
# ---------------------------------------------------------------------------


@dataclass
class WriterStats:
    """Shared, lock-guarded ledger all writer threads append to."""

    acks: list[tuple] = field(default_factory=list)  # (tenant,name,rv,kind,t)
    latencies: dict[str, dict[str, list[float]]] = field(
        default_factory=dict)  # phase -> class -> per-op seconds
    http_5xx: int = 0
    http_429: int = 0
    ambiguous: int = 0      # ack lost but write landed (AlreadyExists etc.)
    gave_up: int = 0        # ops abandoned at their deadline
    max_rv: dict[str, int] = field(default_factory=dict)  # tenant -> rv
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def ack(self, tenant: str, name: str, rv: int, kind: str) -> None:
        with self._lock:
            self.acks.append((tenant, name, rv, kind, time.monotonic()))
            if rv:
                self.max_rv[tenant] = max(self.max_rv.get(tenant, 0), rv)

    def note(self, what: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, what, getattr(self, what) + n)

    def latency(self, phase: str, klass: str, seconds: float) -> None:
        with self._lock:
            self.latencies.setdefault(phase, {}).setdefault(
                klass, []).append(seconds)


def _obj(tenant: str, name: str, step: int) -> dict:
    return {"apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": name, "namespace": NAMESPACE,
                         "clusterName": tenant},
            "data": {"v": str(step)}}


def run_writer(base_url: str, tenant: str, ops: list[Op], stats: WriterStats,
               phase: str, klass: str = "quiet",
               op_deadline_s: float = 30.0, pace_s: float = 0.0,
               smart: bool = False) -> None:
    """Execute one tenant's op list (a blocking worker thread).

    Retry discipline mirrors a production client: 503/transport errors
    back off and retry until the per-op deadline (counting every
    client-visible 5xx into the error budget), 429 honors Retry-After,
    and an AlreadyExists/NotFound answer to a RETRIED create/delete is
    an ack whose response was lost — the write landed, counted
    ambiguous, never double-applied.

    ``smart=True`` writes through a shard-aware
    :class:`~kcp_tpu_torch.client.smart.SmartRestClient` (direct to the HRW
    owner, one-shot router fallback on ring staleness) — the
    ring-change scenario runs smart and routed tenants side by side on
    the same schedule."""
    if smart:
        from ..client.smart import SmartRestClient

        c: RestClient = SmartRestClient(base_url, cluster=tenant)
    else:
        c = RestClient(base_url, cluster=tenant)
    try:
        for op in ops:
            if pace_s:
                time.sleep(pace_s)
            deadline = time.monotonic() + op_deadline_s
            backoff = 0.05
            retried = False
            while True:
                t0 = time.monotonic()
                # driver-side trace root: the whole op (incl. the server
                # round trip) is the convergence timeline's "write"
                # phase — the scenario engine attaches the slowest
                # assembled traces to the scorecard per phase
                tctx = None
                if obs.TRACER.enabled and obs.TRACER.head_sampled():
                    tctx = obs.TRACER.mint(sampled=True)
                tw0 = time.time()
                try:
                    with obs.use(tctx):
                        if op.kind == "create":
                            resp = c.create(RESOURCE, _obj(
                                op.tenant, op.name, op.step))
                        elif op.kind == "update":
                            resp = c.update(RESOURCE, _obj(
                                op.tenant, op.name, op.step))
                        else:
                            c.delete(RESOURCE, op.name, NAMESPACE)
                            resp = None
                    stats.latency(phase, klass, time.monotonic() - t0)
                    rv = 0
                    if resp is not None:
                        rv = int(resp.get("metadata", {})
                                 .get("resourceVersion", "0"))
                    if tctx is not None and tctx.sampled:
                        obs.phase("write", tctx, tw0, time.time(),
                                  rv=str(rv), obj=op.name)
                    stats.ack(op.tenant, op.name, rv, op.kind)
                    break
                except errors.AlreadyExistsError:
                    if op.kind == "create" and retried:
                        stats.note("ambiguous")
                        stats.ack(op.tenant, op.name, 0, op.kind)
                        break
                    raise
                except errors.NotFoundError:
                    if op.kind == "create":
                        raise  # a 404'd create is a harness bug
                    if op.kind == "delete":
                        # a retried delete whose first attempt landed —
                        # or a target a failed upstream op never created:
                        # either way the name is absent, which is the
                        # outcome; the final-state check arbitrates
                        if retried:
                            stats.note("ambiguous")
                        stats.ack(op.tenant, op.name, 0, op.kind)
                        break
                    # update of a vanished object (an upstream give-up
                    # or ambiguous delete): record and move on — the
                    # final-state verification reports the divergence
                    stats.note("gave_up")
                    break
                except errors.TooManyRequestsError as e:
                    stats.note("http_429")
                    if time.monotonic() > deadline:
                        stats.note("gave_up")
                        break
                    time.sleep(min(getattr(e, "retry_after", 0.2) or 0.2,
                                   1.0))
                    retried = True
                except (errors.UnavailableError, errors.GoneError,
                        ConnectionError, OSError) as e:
                    if isinstance(e, errors.ApiError):
                        stats.note("http_5xx")
                    if time.monotonic() > deadline:
                        stats.note("gave_up")
                        break
                    time.sleep(backoff)
                    backoff = min(backoff * 1.7, 0.5)
                    retried = True
    finally:
        c.close()


def run_consistent_reader(base_url: str, tenant: str, stats: WriterStats,
                          shared: dict, stop: threading.Event,
                          pace_s: float = 0.01) -> None:
    """Session-consistency prober (a blocking worker thread): reads the
    tenant's collection through the scenario's client endpoint with the
    session's own write floor pinned (``X-Kcp-Min-Rv`` = the tenant's
    max acked RV). Whichever node answers — the primary, the standby,
    or a WAN-lagged replica parked on its RV barrier — the response's
    list RV must never fall below the floor; a response that does is a
    stale read-your-write, the thing the consistent-read SLOs forbid.
    Counts fold into ``shared`` (``consistent_reads`` /
    ``stale_consistent_reads`` / ``consistent_read_errors``)."""
    c = RestClient(base_url, cluster=tenant)
    lock = shared["_lock"]
    target = f"/clusters/{tenant}/api/v1/namespaces/{NAMESPACE}/{RESOURCE}"
    try:
        while not stop.is_set():
            if pace_s:
                time.sleep(pace_s)
            with stats._lock:
                floor = stats.max_rv.get(tenant, 0)
            if not floor:
                continue
            ok = stale = err = 0
            for attempt in range(3):
                try:
                    s, _h, body = c.request_raw(
                        "GET", target,
                        headers={"X-Kcp-Min-Rv": str(floor)})
                except (ConnectionError, OSError, errors.ApiError):
                    s, body = 0, b""
                if s == 200:
                    rv = int(json.loads(body)["metadata"]
                             .get("resourceVersion", "0"))
                    if rv >= floor:
                        ok = 1
                    else:
                        stale = 1
                    break
                # transport hiccup or relayed 5xx: the router's fallback
                # should have absorbed it — brief retry before counting
                # a surfaced error against the zero-error SLO
                time.sleep(0.1)
            else:
                err = 1
            with lock:
                shared["consistent_reads"] += ok
                shared["stale_consistent_reads"] += stale
                shared["consistent_read_errors"] += err
    finally:
        c.close()


def run_flood(base_url: str, tenant: str, n_ops: int,
              stats: WriterStats) -> tuple[int, int]:
    """The noisy neighbor: fire creates as fast as the wire allows; no
    retries — the point is to be throttled. Returns (ok, throttled)."""
    c = RestClient(base_url, cluster=tenant)
    ok = throttled = 0
    try:
        for i in range(n_ops):
            name = f"{tenant}-flood-{i}"
            try:
                resp = c.create(RESOURCE, _obj(tenant, name, i))
                ok += 1
                stats.ack(tenant, name,
                          int(resp.get("metadata", {})
                              .get("resourceVersion", "0")), "create")
            except errors.TooManyRequestsError:
                throttled += 1
            except errors.ApiError:
                pass  # the flood takes what it gets
    finally:
        c.close()
    return ok, throttled


# ---------------------------------------------------------------------------
# observers
# ---------------------------------------------------------------------------


@dataclass
class ObserverStats:
    events: dict[tuple[str, int], float] = field(default_factory=dict)
    terminal_statuses: int = 0   # drain Status received (clean)
    unclean_ends: int = 0        # established stream died with no Status
    gone_410: int = 0            # resume refused: unrecoverable gap
    relists: int = 0
    reconnects: int = 0
    last_rv: int = 0
    # reconnect-storm accounting: seconds from a deliberate drop to the
    # resumed stream's first delivered event (the client-visible resume
    # latency the watcher-scale SLO bounds)
    resume_s: list[float] = field(default_factory=list)


class StreamObserver:
    """One raw watch stream per (tenant, slot) with the production
    resume discipline; the thing the watch-loss SLOs measure."""

    def __init__(self, base_url: str, tenant: str):
        self.base_url = base_url
        self.tenant = tenant
        self.client = RestClient(base_url, cluster=tenant)
        self.stats = ObserverStats()
        self.cache: dict[str, dict] = {}
        self._stopping = False
        self._dropped = False
        self._resume_t0: float | None = None
        self._watch = None
        self._task: asyncio.Task | None = None
        self.synced = asyncio.Event()

    async def start(self) -> None:
        self._task = asyncio.ensure_future(self._run())
        await self.synced.wait()

    def drop(self) -> None:
        """Sever the live stream (the reconnect-storm lever): the run
        loop notices the closed stream and resumes from last_rv."""
        self._dropped = True
        if self._watch is not None:
            self._watch.close()

    async def stop(self) -> None:
        self._stopping = True
        if self._watch is not None:
            self._watch.close()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None
        self.client.close()

    # ------------------------------------------------------------ loop

    def _relist(self) -> None:
        items, rv = self.client.list(RESOURCE, NAMESPACE)
        now = time.monotonic()
        self.cache = {o["metadata"]["name"]: o for o in items}
        # a relist is delivery, not amnesia: an informer synthesizes
        # events from the list contents, so every listed (name, rv)
        # counts as observed. Acked states OVERWRITTEN before the relist
        # stay unobserved — the intermediate-event gap a kill-without-
        # drain costs — and across a shard migration the target's
        # re-minted rvs are only ever coverable here (the 410→relist is
        # the designed hand-off, not a loss).
        for o in items:
            self.stats.events.setdefault(
                (o["metadata"]["name"],
                 int(o["metadata"].get("resourceVersion", "0"))), now)
        self.stats.last_rv = max(self.stats.last_rv, rv)
        self.stats.relists += 1
        # fd hygiene at watcher scale: a 10k-observer fleet must not
        # also pin 10k idle keep-alive list connections — the client
        # reopens on the next (rare) relist
        self.client.close()

    def _record(self, ev) -> None:
        now = time.monotonic()
        key = (ev.name, ev.rv)
        self.stats.events.setdefault(key, now)
        self.stats.last_rv = max(self.stats.last_rv, ev.rv)
        if self._resume_t0 is not None:
            self.stats.resume_s.append(now - self._resume_t0)
            self._resume_t0 = None
        if ev.type == "DELETED":
            self.cache.pop(ev.name, None)
        else:
            self.cache[ev.name] = ev.object

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        # initial list+watch, retried while the endpoint comes up
        while not self._stopping:
            try:
                await loop.run_in_executor(None, self._relist)
                self.stats.relists -= 1  # the seed list is not a re-list
                break
            except Exception:  # noqa: BLE001 — endpoint still starting
                await asyncio.sleep(0.1)
        self.synced.set()
        while not self._stopping:
            w = self.client.watch(RESOURCE, NAMESPACE,
                                  since_rv=self.stats.last_rv)
            self._watch = w
            delivered = 0
            err: Exception | None = None
            try:
                async for ev in w:
                    self._record(ev)
                    delivered += 1
            except Exception as e:  # noqa: BLE001 — classified below
                err = e
            # bookmarks (including the drain terminal's final one) only
            # advance the stream's last_rv, they are not yielded events
            self.stats.last_rv = max(self.stats.last_rv, w.last_rv)
            if self._stopping:
                return
            if isinstance(err, errors.GoneError):
                # the server cannot replay the gap: INTERMEDIATE states
                # between our last_rv and the relist are UNRECOVERABLE —
                # exactly what kill-without-drain costs (still counted
                # as lost by the coverage check: an overwritten rv is in
                # nobody's relist). Current states land via the relist.
                self.stats.gone_410 += 1
                try:
                    await loop.run_in_executor(None, self._relist)
                except Exception:  # noqa: BLE001 — server mid-restart
                    await asyncio.sleep(0.15)
            elif isinstance(err, errors.UnavailableError):
                # the graceful-drain terminal Status: everything
                # committed before the drain was delivered; resume from
                # last_rv once the endpoint is back
                self.stats.terminal_statuses += 1
            elif self._dropped:
                # our own reconnect-storm drop: a deliberate client-side
                # severing, not a server-side breach. The clock on the
                # resume starts here and stops at the resumed stream's
                # first delivered event.
                self._dropped = False
                self.stats.reconnects += 1
                self._resume_t0 = time.monotonic()
            elif err is None and not getattr(w, "responded", True):
                # connect refused (endpoint restarting): not a stream
                # death, just a failed attempt
                self.stats.reconnects += 1
            else:
                # an ESTABLISHED stream ended with no terminal Status —
                # the violation drain exists to prevent
                self.stats.unclean_ends += 1
            await asyncio.sleep(0.15)
