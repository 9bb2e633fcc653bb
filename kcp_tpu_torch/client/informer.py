"""Informers: list+watch caches with indexers and event handlers.

The analog of the reference's shared informer factories (generated in
pkg/client/informers/**, used by every controller). Differences, by
design:

- async tasks instead of goroutines
- handlers receive (event_type, old, new) and are called on the event
  loop; controllers usually just enqueue keys — the heavy lifting happens
  in the batched reconcile tick
- a periodic resync replays the full cache as MODIFIED events, the
  level-triggered safety net that bounds missed-event damage
  (reference resyncPeriod=10h, pkg/syncer/syncer.go:27)
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
from typing import Awaitable, Callable, Iterable

from ..apis.scheme import GVR
from ..store.selectors import LabelSelector
from ..store.store import ADDED, DELETED, MODIFIED, Event
from ..utils import errors
from ..utils.trace import REGISTRY
from .client import Client

log = logging.getLogger(__name__)

Handler = Callable[[str, dict | None, dict | None], None]
IndexFunc = Callable[[dict], Iterable[str]]

# Standard indexers, mirroring the reference's
# (pkg/reconciler/cluster/controller.go:50-60, 134-149).
def by_cluster(obj: dict) -> list[str]:
    return [obj["metadata"].get("clusterName", "")]


def by_namespace(obj: dict) -> list[str]:
    return [obj["metadata"].get("namespace", "")]


def by_location(obj: dict) -> list[str]:
    """APIResourceImport spec.location indexer (LocationInLogicalCluster)."""
    return [f'{obj["metadata"].get("clusterName", "")}/{obj.get("spec", {}).get("location", "")}']


def by_location_and_gvr(obj: dict) -> list[str]:
    """GVRForLocationInLogicalCluster analog."""
    spec = obj.get("spec", {})
    gv = spec.get("groupVersion", {})
    gvr = f'{gv.get("group", "")}/{gv.get("version", "")}/{spec.get("plural", "")}'
    return [
        f'{obj["metadata"].get("clusterName", "")}/{spec.get("location", "")}/{gvr}'
    ]


class Informer:
    """A list+watch cache for one GVR (optionally selector/namespace bound)."""

    def __init__(
        self,
        client: Client,
        gvr: GVR | str,
        selector: LabelSelector | None = None,
        namespace: str | None = None,
        resync_period: float | None = None,
        watch_list: bool | None = None,
    ):
        self.client = client
        self.gvr = gvr
        self.selector = selector
        self.namespace = namespace
        self.resync_period = resync_period
        self.cache: dict[tuple[str, str, str], dict] = {}  # (cluster, ns, name) -> obj
        self._handlers: list[Handler] = []
        self._indexers: dict[str, IndexFunc] = {}
        self._indices: dict[str, dict[str, set[tuple[str, str, str]]]] = {}
        self._synced = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._resync_task: asyncio.Task | None = None
        self._watch = None
        self._stopping = False
        self.rewatch_backoff = 0.2  # reflector retry pacing on stream loss
        self.retry_after_cap = 30.0  # ceiling on server Retry-After hints
        # resume point: the highest RV this informer has OBSERVED —
        # advanced by delivered events and, crucially, by server
        # BOOKMARKs absorbed into the watch's last_rv (no handler wakes,
        # no resync) — so a stream dropped after a quiet period resumes
        # inside the watch window instead of relisting the world
        self._rv = 0
        # KEP-3157-style watch-list start (opt-in: ctor arg, or
        # KCP_WATCH_LIST=1): the initial state arrives as ADDED events
        # on the watch stream itself, ending in a sync BOOKMARK — the
        # informer never holds a whole list body. Only clients that
        # advertise support (RestClient family) use it; others (and any
        # refusal at runtime) fall back to classic list+watch.
        if watch_list is None:
            watch_list = os.environ.get("KCP_WATCH_LIST", "") == "1"
        self._watch_list = bool(watch_list) and bool(
            getattr(client, "supports_watch_list", False))

    def _retry_delay(self, err: BaseException | None) -> float:
        """Reflector retry pacing: the flat rewatch backoff, unless the
        server sent a 429 with a Retry-After hint — then sleep the
        hinted interval (jittered up to +25% so a fleet of informers
        doesn't re-arrive in lockstep, capped so a bogus hint can't
        park the cache for minutes)."""
        if isinstance(err, errors.GoneError):
            # 410 Gone: the server said the watch window is EXPIRED —
            # waiting cannot revive it, and every second of backoff is a
            # second the cache serves stale state. Re-list immediately
            # (the router's shard-death catchup path depends on this).
            return 0.0
        hint = getattr(err, "retry_after", None)
        if hint is None:
            return self.rewatch_backoff
        try:
            base = min(float(hint), self.retry_after_cap)
        except (TypeError, ValueError):
            return self.rewatch_backoff
        return max(self.rewatch_backoff, base * (1.0 + 0.25 * random.random()))

    # ------------------------------------------------------------ wiring

    def add_handler(self, handler: Handler) -> None:
        self._handlers.append(handler)
        # late subscribers see the existing cache as adds, as in client-go
        for obj in list(self.cache.values()):
            try:
                handler(ADDED, None, obj)
            except Exception:  # noqa: BLE001
                log.exception("informer %s: handler failed on replay", self.gvr)

    def add_indexer(self, name: str, fn: IndexFunc) -> None:
        self._indexers[name] = fn
        self._indices[name] = {}
        for key, obj in self.cache.items():
            self._index_insert(name, key, obj)

    def index(self, name: str, value: str) -> list[dict]:
        keys = self._indices.get(name, {}).get(value, set())
        return [self.cache[k] for k in keys if k in self.cache]

    # ------------------------------------------------------------- cache

    @staticmethod
    def _key(obj: dict) -> tuple[str, str, str]:
        m = obj["metadata"]
        return (m.get("clusterName", ""), m.get("namespace", ""), m["name"])

    def get(self, cluster: str, name: str, namespace: str = "") -> dict | None:
        return self.cache.get((cluster, namespace, name))

    def list(self) -> list[dict]:
        return list(self.cache.values())

    def _index_insert(self, iname: str, key, obj) -> None:
        for v in self._indexers[iname](obj):
            self._indices[iname].setdefault(v, set()).add(key)

    def _index_remove(self, iname: str, key, obj) -> None:
        for v in self._indexers[iname](obj):
            s = self._indices[iname].get(v)
            if s:
                s.discard(key)

    def _apply(self, etype: str, obj: dict) -> None:
        key = self._key(obj)
        old = self.cache.get(key)
        if etype == DELETED:
            if old is not None:
                del self.cache[key]
                for iname in self._indexers:
                    self._index_remove(iname, key, old)
            new = None
        else:
            self.cache[key] = obj
            for iname in self._indexers:
                if old is not None:
                    self._index_remove(iname, key, old)
                self._index_insert(iname, key, obj)
            new = obj
        self._notify(etype, old, new)

    def _notify(self, etype: str, old: dict | None, new: dict | None) -> None:
        # a throwing handler must not kill the pump task (and with it all
        # cache updates for every consumer of this informer)
        for h in self._handlers:
            try:
                h(etype, old, new)
            except Exception:  # noqa: BLE001
                log.exception("informer %s: handler failed on %s event", self.gvr, etype)

    # --------------------------------------------------------------- run

    async def start(self) -> None:
        """List, populate, open the watch, and start the pump task.

        In watch-list mode the list+watch is ONE stream: the server
        sends the current state as ADDED events, then the sync BOOKMARK
        that marks the cache consistent, and the same stream carries the
        live tail — the informer is synced without ever buffering a
        whole list response."""
        started = False
        if self._watch_list:
            started = await self._start_watch_list()
        if not started:
            items, rv = self.client.list(self.gvr, self.namespace,
                                         self.selector)
            for obj in items:
                self._apply(ADDED, obj)
            self._rv = max(self._rv, rv)
            self._watch = self.client.watch(
                self.gvr, self.namespace, self.selector, since_rv=rv
            )
        self._synced.set()
        self._task = asyncio.create_task(self._pump())
        if self.resync_period:
            self._resync_task = asyncio.create_task(self._resync_loop())

    async def _start_watch_list(self) -> bool:
        """Consume initial ADDED events until the server's
        initial-events-end BOOKMARK, then keep the very same stream as
        the live watch. False (with the partial state discarded by
        replace-semantics on the fallback list) on any refusal — an
        older server, a router wildcard — so start() degrades to
        classic list+watch."""
        try:
            w = self.client.watch(self.gvr, self.namespace, self.selector,
                                  initial_events=True)
        except Exception:  # noqa: BLE001 — client can't even build it
            log.warning("informer %s: watch-list unsupported; falling "
                        "back to list+watch", self.gvr, exc_info=True)
            return False
        try:
            async for ev in w:
                if ev.type == "BOOKMARK":
                    self._rv = max(self._rv, ev.rv,
                                   getattr(w, "last_rv", 0) or 0)
                    self._watch = w
                    REGISTRY.counter(
                        "informer_watch_list_starts_total",
                        "informer syncs served as one watch-list "
                        "stream (no whole-list buffering)").inc()
                    return True
                self._apply(ev.type, ev.object)
                if ev.rv:
                    self._rv = max(self._rv, ev.rv)
            # stream ended before the sync marker (refusal or drop)
        except Exception:  # noqa: BLE001 — server refused (400/410/...)
            pass
        log.warning("informer %s: watch-list start failed; falling back "
                    "to list+watch", self.gvr)
        w.close()
        return False

    async def _pump(self) -> None:
        """Dispatch watch events; on stream end, resume or re-list.

        The reflector loop of client-go: an in-process store Watch only
        ends when closed, but a REST watch ends on connection drop, an
        eviction, or an expired watch window (410). A dropped stream
        first tries a FAST RESUME — re-watch from the highest observed
        RV (events + absorbed bookmarks), no relist — so a reconnect
        storm of N informers costs N window resumes served from the
        store's shared watch-cache index, not N full lists. A 410 (the
        window really is gone, or we were evicted) or a fast resume that
        delivers nothing re-lists, exactly as before.
        """
        assert self._watch is not None
        delay = self.rewatch_backoff
        fast_budget = 1
        while True:
            delivered = 0
            err: BaseException | None = None
            try:
                async for ev in self._watch:
                    self._dispatch(ev)
                    if ev.rv:
                        self._rv = max(self._rv, ev.rv)
                    delivered += 1
                delay = self.rewatch_backoff
            except Exception as e:  # noqa: BLE001 — expired window / transport error
                err = e
                delay = self._retry_delay(err)
                log.warning("informer %s: watch failed; resuming in %.2fs",
                            self.gvr, delay, exc_info=True)
            # BOOKMARK progress markers advanced the stream's last_rv
            # without waking any handler — absorb them into the resume
            # point here, once, at stream end
            self._rv = max(self._rv, getattr(self._watch, "last_rv", 0) or 0)
            if self._stopping:
                return
            if delivered:
                fast_budget = 1
            use_fast = (fast_budget > 0 and self._rv > 0
                        and not isinstance(err, errors.GoneError))
            if err is not None or not (use_fast and delivered):
                await asyncio.sleep(delay)
            try:
                if use_fast:
                    # resume from where the stream left off: no relist,
                    # no cache churn — the server replays (since_rv, now]
                    # from its watch window or answers a 410 we turn
                    # into a relist on the next lap
                    fast_budget -= 1
                    self._watch = self.client.watch(
                        self.gvr, self.namespace, self.selector,
                        since_rv=self._rv)
                    REGISTRY.counter(
                        "informer_fast_resumes_total",
                        "dropped informer streams resumed from the last "
                        "observed RV without a relist").inc()
                else:
                    rv = self._relist()
                    self._rv = max(self._rv, rv)
                    self._watch = self.client.watch(
                        self.gvr, self.namespace, self.selector,
                        since_rv=rv)
                    fast_budget = 1
                delay = self.rewatch_backoff
            except Exception as err2:  # noqa: BLE001 — server down or shedding load
                # an overloaded frontend's 429 hint paces the next lap;
                # a 410 on the fast resume falls through to a relist
                if isinstance(err2, errors.GoneError):
                    fast_budget = 0
                delay = self._retry_delay(err2)
                log.warning("informer %s: %s failed; retrying in %.2fs",
                            self.gvr,
                            "fast resume" if use_fast else "re-list",
                            delay, exc_info=True)

    def _relist(self) -> int:
        """Fresh list reconciled against the cache (replace semantics)."""
        items, rv = self.client.list(self.gvr, self.namespace, self.selector)
        fresh = {self._key(o): o for o in items}
        for key, old in list(self.cache.items()):
            if key not in fresh:
                self._apply(DELETED, old)
        for key, obj in fresh.items():
            old = self.cache.get(key)
            if old is not None:
                old_rv = old["metadata"].get("resourceVersion")
                if old_rv is not None and old_rv == obj["metadata"].get("resourceVersion"):
                    # unchanged since the last observation: nothing was
                    # missed for this key, so skip the MODIFIED fan-out
                    # (a relist after a dropped stream would otherwise
                    # wake every controller for the whole cache)
                    self.cache[key] = obj
                    continue
            self._apply(MODIFIED if old is not None else ADDED, obj)
        return rv

    def _dispatch(self, ev: Event) -> None:
        self._apply(ev.type, ev.object)

    async def _resync_loop(self) -> None:
        while True:
            await asyncio.sleep(self.resync_period)
            self.resync()

    def resync(self) -> None:
        """Replay the cache as MODIFIED events (level-triggered safety net)."""
        for obj in list(self.cache.values()):
            self._notify(MODIFIED, obj, obj)

    async def wait_synced(self) -> None:
        await self._synced.wait()

    @property
    def synced(self) -> bool:
        return self._synced.is_set()

    async def stop(self) -> None:
        self._stopping = True
        for t in (self._task, self._resync_task):
            if t is not None:
                t.cancel()
                try:
                    await t
                except asyncio.CancelledError:
                    pass
        self._task = self._resync_task = None
        if self._watch is not None:
            self._watch.close()
            self._watch = None


class SharedInformerFactory:
    """One informer per GVR, shared across controllers.

    The analog of the reference's externalversions.SharedInformerFactory
    (generated; used at pkg/server/server.go:231-250).
    """

    def __init__(self, client: Client, resync_period: float | None = None):
        self.client = client
        self.resync_period = resync_period
        self._informers: dict[str, Informer] = {}

    def informer(self, gvr: GVR | str, selector: LabelSelector | None = None) -> Informer:
        key = str(gvr) + ("|" + str(selector) if selector and not selector.empty else "")
        if key not in self._informers:
            self._informers[key] = Informer(
                self.client, gvr, selector, resync_period=self.resync_period
            )
        return self._informers[key]

    async def start(self) -> None:
        await asyncio.gather(
            *(i.start() for i in self._informers.values() if not i.synced)
        )

    async def stop(self) -> None:
        await asyncio.gather(*(i.stop() for i in self._informers.values()))


async def run_informers(*informers: Informer) -> None:
    await asyncio.gather(*(i.start() for i in informers))


HandlerCoro = Callable[[str, dict | None, dict | None], Awaitable[None]]
