"""Fake physical clusters — the framework's kind-replacement.

The reference tests against real kind (Kubernetes-in-Docker) clusters
(contrib/demo/clusters/kind/). This framework ships an in-process
substitute so the whole multi-cluster story — registration, API import,
sync, placement — runs hermetically (SURVEY.md §4 implication):

- :class:`PhysicalRegistry` resolves a Cluster's ``spec.kubeconfig`` to a
  client. ``fake://<name>`` creates/returns an in-process store; anything
  else is resolved by pluggable factories (the REST client registers an
  ``https://`` factory).
- :class:`FakeClusterAgent` plays the part of the cluster's controllers:
  it marks Deployments ready (status counters follow spec.replicas), so
  pull-mode health checks and status upsync have something to observe.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Callable

from ..apis.scheme import Scheme, default_scheme
from ..client import Client, Informer
from ..store.store import LogicalStore

log = logging.getLogger(__name__)

FAKE_PREFIX = "fake://"
PHYSICAL_CLUSTER_NAME = "physical"


class PhysicalRegistry:
    """kubeconfig string -> physical-cluster Client."""

    def __init__(self):
        self._fakes: dict[str, LogicalStore] = {}
        self._schemes: dict[str, Scheme] = {}
        self._factories: dict[str, Callable[[str], Client]] = {}

    def register_factory(self, scheme: str, factory: Callable[[str], Client]) -> None:
        self._factories[scheme] = factory

    def resolve(self, kubeconfig: str) -> Client:
        if not kubeconfig or not kubeconfig.strip():
            raise ValueError("empty kubeconfig")
        if kubeconfig.startswith(FAKE_PREFIX):
            name = kubeconfig[len(FAKE_PREFIX):]
            if not name:
                raise ValueError("fake:// kubeconfig needs a cluster name")
            store = self._fakes.get(name)
            if store is None:
                store = LogicalStore()
                self._fakes[name] = store
                self._schemes[name] = default_scheme()
            # every client resolved for one fake shares one scheme: a
            # physical cluster has ONE API surface, so a type a test
            # registers (e.g. a custom resource the importer should
            # discover) is visible to the controllers' clients too
            return Client(store, PHYSICAL_CLUSTER_NAME, self._schemes[name])
        scheme = kubeconfig.split("://", 1)[0] if "://" in kubeconfig else ""
        factory = self._factories.get(scheme)
        if factory is None:
            raise ValueError(f"unsupported kubeconfig {kubeconfig!r}")
        return factory(kubeconfig)

    def fake_store(self, name: str) -> LogicalStore | None:
        return self._fakes.get(name)


class ChurnDriver:
    """Seeded, replayable health/capacity churn over a fleet of fake
    pclusters — shared by the fleet scenarios and the unit tests instead
    of ad-hoc per-test condition flipping.

    The whole fleet story is a *pure function of the constructor
    arguments*: capacities are drawn once from a skewed lognormal,
    locality labels round-robin over ``regions``, and every Ready flap is
    precomputed as per-cluster NotReady intervals — same (seed, n, ticks,
    rates) ⇒ the same schedule bit-for-bit on any host, so a scenario
    scorecard names the seed and anyone can replay the run.

    Two kinds of outage drive the hysteresis story:

    - *flaps*: NotReady dips of ``flap_len`` ticks — shorter than the
      evacuation hysteresis window, so the inventory must ride through
      them with ZERO placement churn
    - *outages*: sustained NotReady of ``outage_len`` ticks — these must
      evacuate past the window and readmit on recovery

    ``capacity_churn`` additionally shrinks a cluster's allocatable to
    half its capacity for the duration of an outage-free "pressure"
    interval, exercising capacity-delta re-solves without a health edge.
    """

    def __init__(self, n: int, seed: int = 0, ticks: int = 64,
                 flap_rate: float = 0.05, flap_len: int = 1,
                 outage_rate: float = 0.008, outage_len: int = 12,
                 capacity_churn: float = 0.01,
                 base_capacity: int = 64, skew: float = 1.0,
                 regions: tuple[str, ...] = ("us-east", "us-west",
                                             "eu-west", "ap-south")):
        import numpy as np

        if ticks < 1 or n < 1:
            raise ValueError("ChurnDriver needs n >= 1, ticks >= 1")
        self.n, self.ticks, self.seed = n, ticks, seed
        rng = np.random.default_rng(seed)
        self.names = [f"pc-{i:04d}" for i in range(n)]
        # skewed capacity: a few big clusters, a long tail of small ones
        self.capacity = np.maximum(
            1, np.round(base_capacity * rng.lognormal(0.0, skew, n))
        ).astype(np.int64)
        self.region = [regions[int(r)] for r in rng.integers(0, len(regions), n)]
        down = np.zeros((ticks, n), dtype=bool)
        pressure = np.zeros((ticks, n), dtype=bool)
        flap_starts = rng.random((ticks, n)) < flap_rate
        outage_starts = rng.random((ticks, n)) < outage_rate
        pressure_starts = rng.random((ticks, n)) < capacity_churn
        for t in range(ticks):
            for starts, length, mask in ((flap_starts, flap_len, down),
                                         (outage_starts, outage_len, down),
                                         (pressure_starts, outage_len,
                                          pressure)):
                idx = starts[t].nonzero()[0]
                if idx.size:
                    mask[t:t + length, idx] = True
        self._down = down
        self._pressure = pressure

    # ------------------------------------------------------ pure queries

    def ready_at(self, tick: int) -> "list[bool]":
        """Per-cluster Ready at ``tick`` (ticks past the end = final
        state healed: everything Ready — scenarios settle there)."""
        if tick >= self.ticks:
            return [True] * self.n
        return (~self._down[tick]).tolist()

    def allocatable_at(self, tick: int) -> "list[int]":
        """Health-adjusted allocatable at ``tick`` (pressure halves it)."""
        caps = self.capacity.copy()
        if tick < self.ticks:
            caps[self._pressure[tick]] //= 2
        return caps.tolist()

    def transitions(self, tick: int) -> list[tuple[int, bool]]:
        """(cluster index, now-ready) edges between tick-1 and tick —
        tick 0 is measured against the all-Ready birth state."""
        now = self.ready_at(tick)
        prev = [True] * self.n if tick == 0 else self.ready_at(tick - 1)
        return [(i, now[i]) for i in range(self.n) if now[i] != prev[i]]

    def flap_count(self) -> int:
        import numpy as np

        edges = np.diff(self._down.astype(np.int8), axis=0)
        return int((edges != 0).sum() + self._down[0].sum())

    # --------------------------------------------- Cluster-API applicator

    def seed_fleet(self, client: Client) -> None:
        """Create the fleet's Cluster objects (capacity + locality set,
        all Ready) in ``client``'s logical cluster."""
        from ..apis import cluster as capi

        for i, name in enumerate(self.names):
            obj = capi.new_cluster(name, kubeconfig=f"fake://{name}")
            capi.set_capacity(obj, int(self.capacity[i]),
                              region=self.region[i])
            capi.set_ready(obj)
            client.create(capi.CLUSTERS, obj)

    def apply(self, client: Client, tick: int) -> int:
        """Write ``tick``'s health/capacity deltas onto the Cluster
        objects (delta-based: untouched clusters see no write). Returns
        the number of objects updated."""
        from ..apis import cluster as capi

        ready = self.ready_at(tick)
        alloc = self.allocatable_at(tick)
        prev_alloc = (self.allocatable_at(tick - 1) if tick > 0
                      else self.capacity.tolist())
        changed = {i for i, _ in self.transitions(tick)}
        changed.update(i for i in range(self.n)
                       if alloc[i] != prev_alloc[i])
        for i in sorted(changed):
            obj = client.get(capi.CLUSTERS, self.names[i])
            if ready[i]:
                capi.set_ready(obj)
            else:
                capi.set_not_ready(obj, capi.REASON_SYNCER_NOT_READY,
                                   "churn: heartbeat missed")
            obj.setdefault("status", {})["allocatable"] = {
                capi.CAPACITY_KEY: alloc[i]}
            client.update_status(capi.CLUSTERS, obj)
        return len(changed)


class FakeClusterAgent:
    """Simulates a physical cluster's deployment controller: any
    Deployment becomes fully ready shortly after creation/update."""

    def __init__(self, client: Client, delay: float = 0.0):
        self.client = client
        self.delay = delay
        self.informer = Informer(client, "deployments.apps")
        self._tasks: set[asyncio.Task] = set()
        self.informer.add_handler(self._on_event)

    def _on_event(self, etype: str, old: dict | None, new: dict | None) -> None:
        if etype == "DELETED" or new is None:
            return
        replicas = (new.get("spec") or {}).get("replicas", 0) or 0
        status = new.get("status") or {}
        if status.get("readyReplicas") == replicas and status.get("replicas") == replicas:
            return
        t = asyncio.get_event_loop().create_task(self._mark_ready(new, replicas))
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)

    async def _mark_ready(self, obj: dict, replicas: int) -> None:
        if self.delay:
            await asyncio.sleep(self.delay)
        m = obj["metadata"]
        try:
            fresh = self.client.get("deployments.apps", m["name"], m.get("namespace", ""))
            fresh["status"] = {
                "replicas": replicas,
                "updatedReplicas": replicas,
                "readyReplicas": replicas,
                "availableReplicas": replicas,
                "unavailableReplicas": 0,
                "observedGeneration": fresh["metadata"].get("generation", 1),
                "conditions": [{"type": "Available", "status": "True",
                                "reason": "MinimumReplicasAvailable"}],
            }
            self.client.update_status("deployments.apps", fresh,
                                      namespace=m.get("namespace", ""))
        except Exception:  # noqa: BLE001 — object may be gone; agent is best-effort
            log.debug("fake agent: could not mark %s ready", m.get("name"))

    async def start(self) -> None:
        await self.informer.start()

    async def stop(self) -> None:
        for t in list(self._tasks):
            t.cancel()
        await self.informer.stop()
