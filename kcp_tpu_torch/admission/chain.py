"""The pluggable admission chain: mutating defaulting → validation → quota.

The missing stage of the REST write path — the reference's forked
apiserver inherits Kubernetes admission between authz and storage;
here the chain is wired into ``RestHandler._serve_resource`` the same
way, with this repo's disciplines: every plugin declares the
``(verb, resource)`` sets it intercepts (the routing table is
precomputed, so non-intercepted writes touch two dict lookups and reads
never touch the chain at all), the whole chain is metered
(``admission_seconds`` / ``admission_denied_total``) and
fault-injectable (``admission.chain`` / ``admission.quota`` /
``admission.flow`` KCP_FAULTS points).

Protocol: the handler calls ``ticket = await chain.admit(...)`` before
the store verb, then ``ticket.ok()`` on success or ``ticket.fail()`` on
any failure — the ticket carries the quota reservation
(commit/rollback) and the flow-control concurrency slot, so neither can
leak past one request.

``KCP_ADMISSION=0`` disables the chain entirely (``build_chain``
returns None and the handler's write path is byte-identical to the
pre-admission server).
"""

from __future__ import annotations

import os
import time

from ..faults import maybe_fail
from ..utils.errors import ApiError, InvalidError
from ..utils.trace import REGISTRY

from .flow import FlowController
from .quota import QUOTA_RESOURCE, QuotaLedger, QuotaPlugin, normalize_hard

WRITE_VERBS = frozenset({"create", "update", "delete"})


class _NoopTicket:
    __slots__ = ()

    def ok(self) -> None:
        pass

    def fail(self) -> None:
        pass

    def split_for_window(self):
        """Group-commit form of settle: nothing to defer."""
        return None, None


NOOP_TICKET = _NoopTicket()


class FastTicket:
    """Reusable release-only ticket: the common admitted write (no
    reservation, no after-callback) has exactly one obligation — free
    its flow slot — and the release callable is the same bound method
    for every request through one chain, so ONE instance serves them
    all. The handler settles each ticket exactly once by construction
    (ok on success xor fail on failure), which is what makes sharing
    safe; anything stateful gets a real :class:`Ticket`."""

    __slots__ = ("_release",)

    def __init__(self, release):
        self._release = release

    def ok(self) -> None:
        self._release()

    fail = ok

    def split_for_window(self):
        """Group-commit form of settle: free the flow slot now (the
        window linger must not hold concurrency), nothing to defer."""
        self._release()
        return None, None


class Ticket:
    """One admitted write's obligations: settle exactly once."""

    __slots__ = ("_reservation", "_release", "_after", "_done")

    def __init__(self, reservation=None, release=None, after=None):
        self._reservation = reservation
        self._release = release
        self._after = after
        self._done = False

    def ok(self) -> None:
        if self._done:
            return
        self._done = True
        if self._reservation is not None:
            self._reservation.commit()
        if self._after is not None:
            self._after()
        if self._release is not None:
            self._release()

    def fail(self) -> None:
        if self._done:
            return
        self._done = True
        if self._reservation is not None:
            self._reservation.rollback()
        if self._release is not None:
            self._release()

    def split_for_window(self):
        """Group-commit form of settle: free the flow slot NOW and hand
        the stateful half — (quota reservation, after-hook) — to the
        caller's commit window, which settles a whole window's
        reservations in one batched ledger pass
        (admission/quota.settle_batch). Marks the ticket done: the
        window owns the rest."""
        if self._done:
            return None, None
        self._done = True
        if self._release is not None:
            self._release()
        return self._reservation, self._after


class DefaultingPlugin:
    """Mutating admission: per-resource defaulters edit the body in
    place before validation sees it. ``resources`` is exactly the
    registered set, so unregistered resources never route here."""

    name = "defaulting"
    verbs = frozenset({"create", "update"})

    def __init__(self):
        self._defaulters: dict[str, list] = {}
        self.register(QUOTA_RESOURCE, _default_resourcequota)

    @property
    def resources(self) -> frozenset:
        return frozenset(self._defaulters)

    def register(self, resource: str, fn) -> None:
        self._defaulters.setdefault(resource, []).append(fn)

    def admit(self, verb: str, resource: str, cluster: str,
              namespace: str, obj: dict | None):
        if obj is None:
            return None
        for fn in self._defaulters.get(resource, ()):
            fn(obj)
        return None


def _default_resourcequota(obj: dict) -> None:
    """Normalize ``spec.hard`` to canonical ``count/<resource>: int``
    form so the ledger (and every reader) sees one spelling."""
    spec = obj.get("spec")
    if not isinstance(spec, dict):
        return
    hard = spec.get("hard")
    if not isinstance(hard, dict):
        return
    try:
        normalized = normalize_hard(hard)
    except (ValueError, TypeError):
        return  # validation rejects it with a real message
    spec["hard"] = {f"count/{res}": n for res, n in sorted(normalized.items())}


class ValidationPlugin:
    """Non-mutating admission: reject malformed writes with 422 before
    they reach storage."""

    name = "validation"
    verbs = frozenset({"create", "update"})
    resources = None  # every resource: the generic metadata checks

    def admit(self, verb: str, resource: str, cluster: str,
              namespace: str, obj: dict | None):
        if obj is None:
            return None
        meta = obj.get("metadata")
        if meta is not None and not isinstance(meta, dict):
            raise InvalidError("metadata must be an object")
        if verb == "create":
            meta = meta or {}
            if not meta.get("name") and not meta.get("generateName"):
                raise InvalidError("metadata.name is required")
        if resource == QUOTA_RESOURCE:
            spec = obj.get("spec")
            if spec is not None and not isinstance(spec, dict):
                raise InvalidError("spec must be an object")
            hard = (spec or {}).get("hard")
            if hard is not None:
                if not isinstance(hard, dict):
                    raise InvalidError("spec.hard must be a map")
                try:
                    normalize_hard(hard)
                except (ValueError, TypeError) as e:
                    raise InvalidError(f"malformed spec.hard: {e}") from e
        return None


class AdmissionChain:
    """Ordered plugins + optional flow control, with precomputed
    (verb, resource) routing."""

    def __init__(self, plugins, flow: FlowController | None = None,
                 ledger: QuotaLedger | None = None, store=None):
        self.plugins = list(plugins)
        self.flow = flow
        self.ledger = ledger
        self._store = store
        # the one ticket shape the uncontended happy path ever needs
        self._fast_ticket = (FastTicket(flow.release) if flow is not None
                             else NOOP_TICKET)
        self._route: dict[tuple[str, str], tuple] = {}
        self._seconds = REGISTRY.histogram(
            "admission_seconds", "time spent in the write admission chain")
        self._denied = REGISTRY.counter(
            "admission_denied_total",
            "writes denied by the admission chain (quota, validation, flow)")

    def defaulting(self) -> DefaultingPlugin | None:
        for p in self.plugins:
            if isinstance(p, DefaultingPlugin):
                return p
        return None

    def _plugins_for(self, verb: str, resource: str) -> tuple:
        key = (verb, resource)
        route = self._route.get(key)
        if route is None:
            route = tuple(
                p for p in self.plugins
                if verb in p.verbs
                and (p.resources is None or resource in p.resources))
            self._route[key] = route
        return route

    def admit_nowait(self, verb: str, resource: str, cluster: str,
                     namespace: str, obj: dict | None):
        """Run the chain for one mutating request. Raises ApiError on
        denial (403 quota, 422 validation, 429 flow, injected 503).
        Returns the Ticket to settle around the store verb — or, only
        when flow control must queue the request, a coroutine resolving
        to that Ticket. The uncontended path is fully synchronous: no
        coroutine, no future (the handler awaits per-write otherwise,
        and that alone costs more than the whole chain)."""
        t0 = time.perf_counter()
        try:
            maybe_fail("admission.chain")
            release = None
            flow = self.flow
            if flow is not None:
                got = flow.try_acquire(cluster, verb)
                if type(got) is int:
                    return self._admit_queued(
                        got, verb, resource, cluster, namespace, obj, t0)
                release = got
        except ApiError:
            self._denied.inc()
            self._seconds.observe(time.perf_counter() - t0)
            raise
        return self._run_plugins(verb, resource, cluster, namespace, obj,
                                 release, t0)

    async def _admit_queued(self, fid: int, verb: str, resource: str,
                            cluster: str, namespace: str, obj: dict | None,
                            t0: float) -> Ticket:
        try:
            release = await self.flow.queue_wait(fid)
        except ApiError:
            self._denied.inc()
            self._seconds.observe(time.perf_counter() - t0)
            raise
        return self._run_plugins(verb, resource, cluster, namespace, obj,
                                 release, t0)

    def _run_plugins(self, verb, resource, cluster, namespace, obj,
                     release, t0) -> Ticket:
        reservation = None
        try:
            route = self._route.get((verb, resource))
            if route is None:
                route = self._plugins_for(verb, resource)
            for p in route:
                r = p.admit(verb, resource, cluster, namespace, obj)
                if r is not None:
                    reservation = r
            after = None
            if resource == QUOTA_RESOURCE and self.ledger is not None:
                # a ResourceQuota write re-derives that cluster's hard
                # limits synchronously once the store verb lands (the
                # recount controller covers non-REST writers)
                store, ledger = self._store, self.ledger
                after = lambda: ledger.resync_limits(store, cluster)  # noqa: E731
        except BaseException as e:
            if reservation is not None:
                reservation.rollback()
            if release is not None:
                release()
            if isinstance(e, ApiError):
                self._denied.inc()
            self._seconds.observe(time.perf_counter() - t0)
            raise
        self._seconds.observe(time.perf_counter() - t0)
        if reservation is None and after is None:
            # nothing stateful to settle: the shared release-only ticket
            return self._fast_ticket if release is not None else NOOP_TICKET
        return Ticket(reservation, release, after)

    async def admit(self, verb: str, resource: str, cluster: str,
                    namespace: str, obj: dict | None) -> Ticket:
        """Awaitable form of :meth:`admit_nowait` (tests, simple callers)."""
        got = self.admit_nowait(verb, resource, cluster, namespace, obj)
        return got if hasattr(got, "ok") else await got


def enabled() -> bool:
    return os.environ.get("KCP_ADMISSION", "1").lower() not in (
        "0", "false", "off")


def build_chain(store, flow: FlowController | None = None,
                ledger: QuotaLedger | None = None) -> AdmissionChain | None:
    """The server's default chain: defaulting → validation → quota, with
    env-configured flow control. Returns None when ``KCP_ADMISSION=0``.

    Remote-store frontends get no quota plugin — usage/limits are
    enforced once, by the storage backend's own chain (the same
    division of labor as RVs and conflicts); local flow control still
    sheds load before it ever reaches the backend.
    """
    if not enabled():
        return None
    if flow is None:
        flow = FlowController.from_env()
    plugins: list = [DefaultingPlugin(), ValidationPlugin()]
    is_remote = getattr(store, "is_remote", False)
    if not is_remote:
        if ledger is None:
            ledger = QuotaLedger()
        ledger.attach(store)
        plugins.append(QuotaPlugin(ledger))
    else:
        ledger = None
    return AdmissionChain(plugins, flow=flow, ledger=ledger, store=store)
