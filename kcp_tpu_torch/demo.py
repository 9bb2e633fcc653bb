"""The two demo scenarios through the port's controller plane (the
port's counterpart of ``contrib/demo/run_demo.py``).

Both run in-process against fake physical clusters and print the same
normalised transcript as ``contrib/demo/run_demo.py``; ``--check`` compares it
line for line with the committed ``contrib/demo/demo.result`` (read only).

- ``apiNegotiation``: register us-east1, import, publish, CRD
  established; register us-west1 with a narrower schema and observe
  Compatible=False on its import.
- ``kubecon``: register two clusters, create a root Deployment, watch it
  split, sync down, and aggregate status back up.

The push syncers and the splitter share the loop's ``FusedCore`` on
``--device`` (the CUDA card by default); ``--mesh SPEC`` shards it over
that many copies of the device (``"4"``, ``"4x2"``).

``controller_plane_load`` runs the same controllers at a fleet's size in
one loop; ``front_door_load`` runs that fleet through ``kcp start``'s
``Server``, driven over REST from another thread, and
``fleet_front_door_load`` the same with fleet placement on
(``Config(fleet=True)``: the ``FleetScheduler`` and its solver).

Usage:
    python -m kcp_tpu_torch.demo [apiNegotiation|kubecon|all] [--check]
                                 [--device cpu] [--mesh 4x2]
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import math
import os
import sys
import threading
from collections import deque

import torch

from .apis import apiresource as ar
from .apis import cluster as clusterapi
from .apis import conditions as cond
from .apis import crd as crdapi
from .client import Client, MultiClusterClient
from .parallel.mesh import mesh_from_spec
from .physical import FakeClusterAgent, PhysicalRegistry
from .reconcilers.apiresource import NegotiationController
from .reconcilers.cluster import ClusterController, SyncerMode
from .reconcilers.crdlifecycle import CRDLifecycleController
from .reconcilers.deployment import DeploymentSplitter
from .reconcilers.deployment.controller import is_root
from .store import LogicalStore
from .utils.device import resolve_device

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "contrib", "demo", "demo.result")
SCENARIOS = ("apiNegotiation", "kubecon")


async def eventually(pred, timeout=20.0, desc="condition"):
    loop = asyncio.get_running_loop()
    end = loop.time() + timeout
    last = None
    while loop.time() < end:
        try:
            last = pred()
            if last:
                return last
        except Exception as e:  # noqa: BLE001
            last = repr(e)
        await asyncio.sleep(0.02)
    raise RuntimeError(f"demo timed out waiting for {desc} (last={last!r})")


class ControlPlane:
    """One in-process control plane with all controllers running on one
    device (and mesh)."""

    def __init__(self, device=None, mesh=None):
        self.store = LogicalStore()
        self.client = MultiClusterClient(self.store)
        self.registry = PhysicalRegistry()
        self.negotiation = NegotiationController(
            self.client, auto_publish=True, device=device)
        self.lifecycle = CRDLifecycleController(self.client)
        self.clusters = ClusterController(
            self.client, self.registry, resources_to_sync=["deployments.apps"],
            mode=SyncerMode.PUSH, poll_interval=0.2, import_poll_interval=0.2,
            device=device, mesh=mesh,
        )
        self.splitter = DeploymentSplitter(self.client, device=device, mesh=mesh)
        self.agents: list[FakeClusterAgent] = []

    async def start(self):
        await self.negotiation.start()
        await self.lifecycle.start()
        await self.clusters.start()
        await self.splitter.start()

    async def add_physical(self, name: str) -> None:
        client = self.registry.resolve(f"fake://{name}")
        agent = FakeClusterAgent(client)
        await agent.start()
        self.agents.append(agent)

    async def stop(self):
        for a in self.agents:
            await a.stop()
        await self.splitter.stop()
        await self.clusters.stop()
        await self.lifecycle.stop()
        await self.negotiation.stop()


async def demo_api_negotiation(emit, device=None, mesh=None) -> None:
    emit("=== demo: apiNegotiation ===")
    cp = ControlPlane(device, mesh)
    await cp.start()
    await cp.add_physical("us-east1")
    t = cp.client.cluster_client("admin")

    emit("$ kubectl apply cluster us-east1")
    t.create(clusterapi.CLUSTERS, clusterapi.new_cluster("us-east1", "fake://us-east1"))
    await eventually(
        lambda: ar.is_compatible_and_available(
            t.get(ar.APIRESOURCEIMPORTS, "us-east1.deployments.v1.apps")),
        desc="us-east1 import compatible+available")
    emit("apiresourceimport us-east1.deployments.v1.apps: Compatible=True Available=True")
    await eventually(lambda: crdapi.is_established(t.get(crdapi.CRDS, "deployments.apps")),
                     desc="deployments CRD established")
    emit("crd deployments.apps: Established=True")
    await eventually(lambda: clusterapi.is_ready(t.get(clusterapi.CLUSTERS, "us-east1")),
                     desc="us-east1 Ready")
    emit("cluster us-east1: Ready=True syncedResources="
         + ",".join(clusterapi.synced_resources(t.get(clusterapi.CLUSTERS, "us-east1"))))

    emit("$ kubectl apply cluster us-west1 (narrower deployment schema)")
    # us-west1's fake cluster serves a deployments CRD whose spec.replicas
    # is a string -> incompatible with the negotiated integer schema
    west = cp.registry.resolve("fake://us-west1")
    bad = crdapi.new_crd("apps", "v1", "deployments", "Deployment", schema={
        "type": "object",
        "properties": {"spec": {"type": "object", "properties": {
            "replicas": {"type": "string"}}}},
    })
    west.create(crdapi.CRDS, bad)
    await cp.add_physical("us-west1")
    t.create(clusterapi.CLUSTERS, clusterapi.new_cluster("us-west1", "fake://us-west1"))

    imp = await eventually(
        lambda: (lambda o: cond.find_condition(o, ar.COMPATIBLE) is not None and o)(
            t.get(ar.APIRESOURCEIMPORTS, "us-west1.deployments.v1.apps")),
        desc="us-west1 import processed")
    c = cond.find_condition(imp, ar.COMPATIBLE)
    emit(f"apiresourceimport us-west1.deployments.v1.apps: Compatible={c['status']}"
         f" reason={c.get('reason', '')}")
    await cp.stop()


async def demo_kubecon(emit, device=None, mesh=None) -> None:
    emit("=== demo: kubecon ===")
    cp = ControlPlane(device, mesh)
    await cp.start()
    await cp.add_physical("east")
    await cp.add_physical("west")
    t = cp.client.cluster_client("kubecon")

    emit("$ kubectl apply cluster east west")
    t.create(clusterapi.CLUSTERS, clusterapi.new_cluster("east", "fake://east"))
    t.create(clusterapi.CLUSTERS, clusterapi.new_cluster("west", "fake://west"))
    await eventually(lambda: clusterapi.is_ready(t.get(clusterapi.CLUSTERS, "east"))
                     and clusterapi.is_ready(t.get(clusterapi.CLUSTERS, "west")),
                     desc="both clusters ready")
    emit("cluster east: Ready=True")
    emit("cluster west: Ready=True")

    emit("$ kubectl apply deployment demo replicas=10")
    t.create("deployments.apps", {
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": "demo", "namespace": "default"},
        "spec": {"replicas": 10,
                 "selector": {"matchLabels": {"app": "demo"}},
                 "template": {"metadata": {"labels": {"app": "demo"}},
                              "spec": {"containers": [{"name": "demo", "image": "x"}]}}},
    })
    east = cp.registry.resolve("fake://east")
    west = cp.registry.resolve("fake://west")
    await eventually(lambda: east.get("deployments.apps", "demo--east", "default"),
                     desc="east physical deployment")
    await eventually(lambda: west.get("deployments.apps", "demo--west", "default"),
                     desc="west physical deployment")
    e = east.get("deployments.apps", "demo--east", "default")["spec"]["replicas"]
    w = west.get("deployments.apps", "demo--west", "default")["spec"]["replicas"]
    emit(f"deployment demo--east synced to east with replicas={e}")
    emit(f"deployment demo--west synced to west with replicas={w}")
    await eventually(
        lambda: t.get("deployments.apps", "demo", "default")
        .get("status", {}).get("readyReplicas") == 10,
        desc="root status aggregation")
    st = t.get("deployments.apps", "demo", "default")["status"]
    emit(f"deployment demo status: replicas={st['replicas']} ready={st['readyReplicas']}"
         f" available={st['availableReplicas']}")
    await cp.stop()


def _tick_phase_totals() -> dict[str, float]:
    """Seconds spent so far in each tick phase of the fused core (the
    ``fused_<phase>_seconds`` histograms)."""
    from .utils.trace import REGISTRY

    return {k[6:-8]: v["count"] * v["mean"] for k, v in REGISTRY.snapshot().items()
            if k.startswith("fused_") and k.endswith("_seconds") and isinstance(v, dict)}


def _seeded_roots(seed: int, n_logical: int, n_physical: int, roots: int):
    """Seeded replicas in 1..100, [n_logical, roots], and the CPU split
    every leaf must carry when every logical cluster registers all
    ``n_physical`` clusters, [n_logical, roots, n_physical]."""
    import numpy as np

    from .ops.placement import split_replicas

    rng = np.random.default_rng(seed)
    replicas = rng.integers(1, 101, (n_logical, roots)).astype(np.int32)
    want = split_replicas(torch.from_numpy(replicas.reshape(-1)),
                          torch.ones(n_logical * roots, n_physical, dtype=torch.bool)
                          ).numpy().reshape(n_logical, roots, n_physical)
    return replicas, want


def _root(k: int, replicas: int) -> dict:
    return {"apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": f"app-{k}", "namespace": "default"},
            "spec": {"replicas": replicas,
                     "selector": {"matchLabels": {"app": f"app-{k}"}},
                     "template": {"metadata": {"labels": {"app": f"app-{k}"}},
                                  "spec": {"containers": [{"name": "app", "image": "x"}]}}}}


def _check_leaves(leaves: dict, lcs: list, pcs: list, want, roots: int) -> None:
    """``leaves[pc]``: {name: replicas} read from physical cluster ``pc``;
    each must equal the CPU split."""
    for j, pc in enumerate(pcs):
        got = leaves[pc]
        for i, lc in enumerate(lcs):
            for k in range(roots):
                name = f"app-{k}--{lc}-{pc}"
                if got.get(name) != int(want[i, k, j]):
                    raise RuntimeError(
                        f"leaf {name} on {pc}: replicas {got.get(name)}, "
                        f"the split says {int(want[i, k, j])}")


async def controller_plane_load(device=None, mesh=None, n_logical: int = 16,
                                n_physical: int = 4, roots: int = 256, seed: int = 0,
                                timeout: float = 300.0) -> dict:
    """The demo's control plane at a platform team's size: ``n_physical``
    fake physical clusters, each registered by every one of ``n_logical``
    logical clusters (one push syncer per registration, all on the loop's
    one ``FusedCore``), and ``roots`` root Deployments per logical cluster
    with seeded replicas in 1..100.

    Each logical cluster names its registration of physical cluster ``j``
    ``<lc>-pc-<j>``. A push syncer owns, downstream, the objects labelled
    with its Cluster's name, so two logical clusters that gave a shared
    physical cluster the same Cluster name would delete each other's
    leaves (the reference does the same).

    Checks every import Compatible and Available, every cluster Ready,
    every leaf downstream with the replicas of ``ops/placement.
    split_replicas`` on the CPU, every root's aggregated readyReplicas
    equal to its replicas, every root placed through the fused lane, and
    no row quarantined; raises RuntimeError on the first that fails.
    Returns the readings, among them the window from the first root
    created to the last root aggregated: its fleet ticks, the seconds the
    core spent in each tick phase, and the process's CPU seconds."""
    import time

    from .utils.trace import REGISTRY

    lcs = [f"lc-{i:02d}" for i in range(n_logical)]
    pcs = [f"pc-{j}" for j in range(n_physical)]  # fake://pc-j, shared by every lc
    replicas, want = _seeded_roots(seed, n_logical, n_physical, roots)
    quarantined0 = REGISTRY.counter("quarantined_rows").value
    cp = ControlPlane(device, mesh)
    await cp.start()
    try:
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        for pc in pcs:
            await cp.add_physical(pc)
        scoped = {lc: cp.client.cluster_client(lc) for lc in lcs}
        for lc in lcs:
            for pc in pcs:
                scoped[lc].create(clusterapi.CLUSTERS,
                                  clusterapi.new_cluster(f"{lc}-{pc}", f"fake://{pc}"))

        def all_imports():
            return all(ar.is_compatible_and_available(
                scoped[lc].get(ar.APIRESOURCEIMPORTS, f"{lc}-{pc}.deployments.v1.apps"))
                for lc in lcs for pc in pcs)

        def all_ready():
            return (len(cp.clusters.syncers) == n_logical * n_physical
                    and all("deployments.apps" in clusterapi.synced_resources(c)
                            and clusterapi.is_ready(c)
                            for lc in lcs for c in scoped[lc].list(clusterapi.CLUSTERS)[0]))

        await eventually(all_imports, timeout, "every import Compatible and Available")
        await eventually(all_ready, timeout, "every cluster Ready with its push syncer")
        core = cp.splitter.core
        if any(e.core is not core for s in cp.clusters.syncers.values() for e in s.engines):
            raise RuntimeError("a push syncer runs on another FusedCore than the splitter's")
        t1 = loop.time()
        cpu1, phases1 = time.process_time(), _tick_phase_totals()
        ticks0 = core._fleet.stats["ticks"] if core._fleet is not None else 0
        for i, lc in enumerate(lcs):
            for k in range(roots):
                scoped[lc].create("deployments.apps", _root(k, int(replicas[i, k])))
        phys = {pc: cp.registry.resolve(f"fake://{pc}") for pc in pcs}
        n_leaves = n_logical * roots * n_physical

        def downstream() -> int:
            return sum(len(c.list("deployments.apps")[0]) for c in phys.values())

        await eventually(lambda: downstream() == n_leaves, timeout, "every leaf downstream")
        t_leaves = loop.time()

        def aggregated() -> bool:
            for lc in lcs:
                for o in scoped[lc].list("deployments.apps")[0]:
                    if not is_root(o):
                        continue
                    if (o.get("status") or {}).get("readyReplicas") != o["spec"]["replicas"]:
                        return False
            return True

        await eventually(aggregated, timeout, "every root's readyReplicas aggregated")
        t_agg = loop.time()
        cpu_s = time.process_time() - cpu1
        phases = {k: v - phases1.get(k, 0.0) for k, v in _tick_phase_totals().items()}
        ticks = (core._fleet.stats["ticks"] if core._fleet is not None else 0) - ticks0

        _check_leaves({pc: {o["metadata"]["name"]: o["spec"]["replicas"]
                            for o in phys[pc].list("deployments.apps")[0]} for pc in pcs},
                      lcs, pcs, want, roots)
        stats = dict(cp.splitter.stats)
        if stats["fused_placements"] < n_logical * roots or stats["host_placements"]:
            raise RuntimeError(f"placements: {stats}")
        quarantined = REGISTRY.counter("quarantined_rows").value - quarantined0
        if quarantined:
            raise RuntimeError(f"{quarantined} rows quarantined")
        return dict(logical=n_logical, physical=n_physical, roots=n_logical * roots,
                    leaves=n_leaves, syncers=n_logical * n_physical,
                    ready_s=t1 - t0, leaves_s=t_leaves - t1, aggregated_s=t_agg - t1,
                    ticks=ticks, cpu_s=cpu_s,
                    tick_phases_s={k: v for k, v in phases.items() if v > 0},
                    fused_placements=stats["fused_placements"],
                    aggregations=stats["aggregations"])
    finally:
        await cp.stop()


def _until(pred, timeout: float, what: str, interval: float = 0.2):
    """Poll ``pred`` from a plain thread until it holds; its last value."""
    import time

    end = time.monotonic() + timeout
    last = None
    while time.monotonic() < end:
        try:
            last = pred()
            if last:
                return last
        except Exception as e:  # noqa: BLE001 — a read racing the server
            last = repr(e)
        time.sleep(interval)
    raise RuntimeError(f"timed out waiting for {what} (last={last!r})")


def _front_door_server(device, pcs: list, timeout: float, **config):
    """``kcp start``'s ``Server`` in a ``ServerThread`` (in memory, TLS
    off, clusters and imports polled every 0.2 s, APIs published
    automatically, controllers on ``device``) and a ``FakeClusterAgent``
    for each fake physical cluster of ``pcs``: (the thread, {pc: its
    store}, the agents). Stop both with ``_stop_front_door``."""
    from .server import Config
    from .server.threaded import ServerThread

    registry = PhysicalRegistry()
    st = ServerThread(Config(durable=False, tls=False, poll_interval=0.2,
                             import_poll_interval=0.2, auto_publish_apis=True,
                             device=device, **config), registry=registry).start(timeout)
    phys = {pc: registry.resolve(f"fake://{pc}") for pc in pcs}
    agents: list[FakeClusterAgent] = []

    async def start_agents():
        for pc in pcs:
            agent = FakeClusterAgent(phys[pc])
            await agent.start()
            agents.append(agent)

    try:
        st.submit(start_agents())
    except BaseException:
        _stop_front_door(st, agents)
        raise
    return st, phys, agents


def _stop_front_door(st, agents) -> None:
    if st.server is not None and agents:
        st.submit(_stop_agents(agents))
    st.stop()


def _wait_registered(st, scoped: dict, lcs: list, pcs: list, timeout: float) -> None:
    """Until every logical cluster's ``<lc>-<pc>`` registrations have push
    syncers, Compatible+Available Deployment imports, and are Ready."""
    clusters = next(c for c in st.server._controllers if isinstance(c, ClusterController))

    def ready() -> bool:
        return (st.call(lambda: len(clusters.syncers)) == len(lcs) * len(pcs)
                and all(ar.is_compatible_and_available(scoped[lc].get(
                    ar.APIRESOURCEIMPORTS, f"{lc}-{pc}.deployments.v1.apps"))
                    for lc in lcs for pc in pcs)
                and all("deployments.apps" in clusterapi.synced_resources(c)
                        and clusterapi.is_ready(c)
                        for lc in lcs for c in scoped[lc].list(clusterapi.CLUSTERS)[0]))

    _until(ready, timeout, "every import Compatible+Available, every cluster Ready")


def _ticks_launches(core) -> tuple[int, int, int]:
    """The fleet batch's ticks and ticks without rows, and the kernel's
    launches; read on the server loop, where a tick's launch and its
    count happen in one synchronous step."""
    from .ops.cuda_kernels import decide_and_match

    stats = core._fleet.stats if core._fleet is not None else {}
    return stats.get("ticks", 0), stats.get("empty_ticks", 0), decide_and_match.launches


def front_door_load(device=None, n_logical: int = 16, n_physical: int = 4,
                    roots: int = 256, seed: int = 0, timeout: float = 300.0,
                    trace_dir: str | None = None) -> dict:
    """``controller_plane_load`` through ``kcp start``'s server: a
    ``Server`` in a ``ServerThread`` (in memory, TLS off, controllers on
    ``device``, clusters and imports polled every 0.2 s, APIs published
    automatically) over ``n_physical`` fake physical clusters with a
    ``FakeClusterAgent`` each, driven from this thread over HTTP by a
    ``MultiClusterRestClient``: every logical cluster registers every
    physical cluster as ``<lc>-pc-<j>`` and creates ``roots`` root
    Deployments with seeded replicas in 1..100.

    Checks, raising RuntimeError on the first that fails: every import
    Compatible and Available and every cluster Ready (read over REST);
    every leaf downstream with the CPU split's replicas; every root's
    readyReplicas, read over REST, equal to its replicas; on a card,
    ``decide_and_match`` launched at least once per fleet tick of the
    window that had synced rows (a tick of the placement lanes alone has
    nothing to decide); the quota ledger's device lane fed by the fleet batch
    (``fused_fleet_ledger_updates_total`` rose, each logical cluster's
    Deployments count equal to the leaves its push syncers hold,
    ``quota_usage_device`` on ``/metrics`` equal to all leaves); nothing
    quarantined; and, when ``trace_dir`` is given, ``/debug/trace``
    started and wrote its trace there, twice (``_traced_call``: each
    call's stall of the serving loop is under ``trace_calls``, the first
    call under ``trace``). Returns the readings of the window
    from the first root POST: to the last leaf downstream and to the last
    root aggregated, the creates' client-side latencies, the server's
    admission and tick-phase seconds, the process's CPU seconds, fleet
    ticks and kernel launches."""
    import json
    import time
    import urllib.request

    import numpy as np

    from .apis.cluster import new_cluster
    from .server import MultiClusterRestClient
    from .utils.trace import REGISTRY

    dev = resolve_device(device)
    lcs = [f"lc-{i:02d}" for i in range(n_logical)]
    pcs = [f"pc-{j}" for j in range(n_physical)]
    replicas, want = _seeded_roots(seed, n_logical, n_physical, roots)
    n_leaves = n_logical * roots * n_physical
    st, phys, agents = _front_door_server(device, pcs, timeout)

    def counter(name: str) -> float:
        return REGISTRY.counter(name).value

    def histogram_s(name: str) -> tuple[int, float]:
        h = REGISTRY.snapshot().get(name) or {"count": 0, "mean": 0.0}
        return h["count"], h["count"] * h["mean"]

    try:
        mc = MultiClusterRestClient(st.address)
        scoped = {lc: mc.cluster_client(lc) for lc in lcs}
        quarantined0 = counter("quarantined_rows")
        t0 = time.perf_counter()
        for lc in lcs:
            for pc in pcs:
                scoped[lc].create(clusterapi.CLUSTERS, new_cluster(f"{lc}-{pc}", f"fake://{pc}"))
        _wait_registered(st, scoped, lcs, pcs, timeout)
        ready_s = time.perf_counter() - t0
        splitter = next(c for c in st.server._controllers
                        if isinstance(c, DeploymentSplitter))
        core = splitter.core
        ledger = st.server.handler.admission.ledger

        start = st.call(_ticks_launches, core)
        updates0 = counter("fused_fleet_ledger_updates_total")
        adm0, phases0 = histogram_s("admission_seconds"), _tick_phase_totals()
        cpu0 = time.process_time()
        t1 = time.perf_counter()
        latencies = []
        for i, lc in enumerate(lcs):
            for k in range(roots):
                c0 = time.perf_counter()
                scoped[lc].create("deployments.apps", _root(k, int(replicas[i, k])))
                latencies.append(time.perf_counter() - c0)
        posted_s = time.perf_counter() - t1

        def downstream() -> bool:
            return st.call(lambda: sum(len(c.list("deployments.apps")[0])
                                       for c in phys.values())) == n_leaves

        _until(downstream, timeout, "every leaf downstream", 0.05)
        leaves_s = time.perf_counter() - t1

        def aggregated() -> bool:
            for lc in lcs:
                items = scoped[lc].list("deployments.apps")[0]
                if sum(1 for o in items if is_root(o)) != roots:
                    return False
                for o in items:
                    if is_root(o) and (o.get("status") or {}).get(
                            "readyReplicas") != o["spec"]["replicas"]:
                        return False
            return True

        _until(aggregated, timeout, "every root's readyReplicas aggregated over REST", 0.05)
        aggregated_s = time.perf_counter() - t1
        cpu_s = time.process_time() - cpu0
        adm1 = histogram_s("admission_seconds")
        phases = {k: v - phases0.get(k, 0.0) for k, v in _tick_phase_totals().items()}
        ticks, empty_ticks, launches = (
            a - b for a, b in zip(st.call(_ticks_launches, core), start))

        _check_leaves(st.call(lambda: {pc: {o["metadata"]["name"]: o["spec"]["replicas"]
                                            for o in phys[pc].list("deployments.apps")[0]}
                                       for pc in pcs}), lcs, pcs, want, roots)
        if dev.type == "cuda" and launches < ticks - empty_ticks:
            raise RuntimeError(f"decide_and_match launched {launches} times in "
                               f"{ticks} fleet ticks, {empty_ticks} of them without rows")
        per_lc = roots * n_physical

        def lane() -> dict:
            return {lc: ledger.device_usage_of(lc, "deployments.apps") for lc in lcs}

        _until(lambda: set(lane().values()) == {per_lc}, 30.0,
               f"the ledger's device lane at {per_lc} Deployments per logical cluster")
        device_lane = lane()
        updates = counter("fused_fleet_ledger_updates_total") - updates0
        if updates <= 0:
            raise RuntimeError("the fleet batch forwarded no counts to the ledger")
        with urllib.request.urlopen(f"{st.address}/metrics", timeout=30) as r:
            metrics = r.read().decode()
        usage = [float(line.split()[-1]) for line in metrics.splitlines()
                 if line.startswith("quota_usage_device ")]
        if usage != [float(n_leaves)]:
            raise RuntimeError(f"quota_usage_device on /metrics: {usage}, want {n_leaves}")
        trace, trace_calls = None, []
        if trace_dir is not None:
            # a first and a second call, each timed against the loop
            for i in range(2):
                call = _traced_call(st, scoped[lcs[0]], os.path.join(trace_dir, f"call-{i}"),
                                    0.5, f"traced-{i}")
                if not call.get("started") or not os.path.exists(call.get("trace", "")):
                    raise RuntimeError(f"/debug/trace: {call}")
                trace_calls.append(call)
            trace = trace_calls[0]
        quarantined = counter("quarantined_rows") - quarantined0
        if quarantined:
            raise RuntimeError(f"{quarantined} rows quarantined")
        lat = np.array(latencies)
        return dict(logical=n_logical, physical=n_physical, roots=n_logical * roots,
                    leaves=n_leaves, syncers=n_logical * n_physical, ready_s=ready_s,
                    posted_s=posted_s, leaves_s=leaves_s, aggregated_s=aggregated_s,
                    create_p50_ms=float(np.percentile(lat, 50) * 1e3),
                    create_p99_ms=float(np.percentile(lat, 99) * 1e3),
                    admissions=adm1[0] - adm0[0], admission_s=adm1[1] - adm0[1],
                    tick_phases_s={k: v for k, v in phases.items() if v > 0},
                    cpu_s=cpu_s, ticks=ticks, empty_ticks=empty_ticks, launches=launches,
                    ledger_updates=updates, device_lane=device_lane, usage_device=usage[0],
                    trace=trace, trace_calls=trace_calls)
    finally:
        _stop_front_door(st, agents)


def _traced_call(st, client, trace_dir: str, seconds: float, root: str) -> dict:
    """One ``/debug/trace?seconds=`` call to ``st``'s server, timed against
    its serving loop: another thread round-trips ``/healthz`` every 20 ms
    meanwhile, a root Deployment named ``<root>-<k>`` is created through
    ``client`` every ``seconds / 4`` until the call returns (so the loop
    runs device work inside the trace), and the loop watchdog's stalls
    (over its 1 s threshold) are read before and after. Adds to the
    handler's reply: the call's wall seconds, the /healthz round trips
    (count, slowest ms), the watchdog's new stalls, and, from the trace
    file, the CPU op events on the loop's thread and the device kernels."""
    import json
    import threading
    import time
    import urllib.request

    stop, rtts = threading.Event(), []

    def ping():
        while not stop.is_set():
            t = time.perf_counter()
            with urllib.request.urlopen(f"{st.address}/healthz", timeout=120) as r:
                r.read()
            rtts.append(time.perf_counter() - t)
            stop.wait(0.02)

    def create():
        for k in range(1000):
            if stop.wait(seconds / 4):
                return
            client.create("deployments.apps", _root(0, 1) | {"metadata": {
                "name": f"{root}-{k}", "namespace": "default"}})

    watchdog = st.server._watchdog
    n0 = len(watchdog.stalls)
    threads = [threading.Thread(target=ping, daemon=True),
               threading.Thread(target=create, daemon=True)]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    url = f"{st.address}/debug/trace?seconds={seconds}&dir={trace_dir}"
    with urllib.request.urlopen(url, timeout=120) as r:
        body = json.loads(r.read())
    body["wall_s"] = time.perf_counter() - t0
    stop.set()
    for t in threads:
        t.join(120)
    body.update(healthz=len(rtts), healthz_max_ms=max(rtts, default=0.0) * 1e3,
                stalls_s=list(watchdog.stalls[n0:]), loop_cpu_ops=0, device_kernels=0)
    if os.path.exists(body.get("trace", "")):
        loop_tid = st._thread.native_id
        for e in json.load(open(body["trace"])).get("traceEvents", []):
            if e.get("cat") == "cpu_op" and e.get("tid") == loop_tid:
                body["loop_cpu_ops"] += 1
            elif e.get("cat") == "kernel":
                body["device_kernels"] += 1
    return body


def fleet_front_door_load(device=None, n_logical: int = 16, n_physical: int = 4,
                          roots: int = 64, seed: int = 0, timeout: float = 300.0) -> dict:
    """``kcp start`` with fleet placement (``Config(fleet=True)``): the
    front door's layout and cadence (a ``Server`` in a ``ServerThread``,
    in memory, TLS off, 0.2 s polls, ``n_physical`` fake physical
    clusters registered by every logical cluster as ``<lc>-pc-<j>``),
    where each registration carries a seeded capacity
    (``apis/cluster.set_capacity``, lognormal as the placement benchmark's)
    and its physical cluster's region label, and ``roots`` root
    Deployments per logical cluster carry seeded replicas in 1..100 and
    seeded ``fleet.kcp.dev/region`` labels (some none), POSTed over REST.
    ``KCP_FLEET_SPREAD`` is 2 while the server starts (the placement
    benchmark's spread).

    Checks, raising RuntimeError on the first that fails: every leaf (read
    over REST) carries the replicas ``fleet.solver.solve_host`` gives on
    the clusters and roots read back over REST, and every leaf reaches its
    physical cluster; on a card, ``decide_and_match`` launched at least
    once per fleet tick with rows. Then ``lc-00-pc-0``'s
    ``status.allocatable`` changes over REST: the first solve after it
    re-solves exactly that logical cluster's ``roots`` rows, every solve
    after it only rows of that logical cluster, and the leaves again equal
    ``solve_host``. Returns the readings: the window from the first root
    POST to the last leaf placed, the re-placement after the change, the
    scheduler's and the solver's stats, ``fleet_solve_seconds``, fleet
    ticks and kernel launches."""
    import time

    import numpy as np

    from .apis.cluster import new_cluster, set_capacity
    from .fleet.scheduler import FleetScheduler
    from .fleet.solver import solve_host
    from .server import MultiClusterRestClient
    from .syncer.core import FusedCore
    from .utils.errors import ConflictError
    from .utils.trace import REGISTRY

    dev = resolve_device(device)
    spread = 2
    lcs = [f"lc-{i:02d}" for i in range(n_logical)]
    pcs = [f"pc-{j}" for j in range(n_physical)]
    regions = [f"region-{j}" for j in range(4)]
    rng = np.random.default_rng(seed)
    replicas = rng.integers(1, 101, (n_logical, roots)).astype(np.int32)
    home = rng.integers(-1, len(regions), (n_logical, roots))  # -1: no label
    caps = np.clip(rng.lognormal(3.0, 1.2, (n_logical, n_physical)), 1, 30000).astype(int)
    saved = os.environ.get("KCP_FLEET_SPREAD")
    os.environ["KCP_FLEET_SPREAD"] = str(spread)
    try:
        st, phys, agents = _front_door_server(device, pcs, timeout, fleet=True)
    finally:
        if saved is None:
            os.environ.pop("KCP_FLEET_SPREAD")
        else:
            os.environ["KCP_FLEET_SPREAD"] = saved

    def expected(scoped) -> dict:
        """{lc: {leaf name: replicas}} from solve_host on what REST holds."""
        rid = {"": 0, **{r: i + 1 for i, r in enumerate(regions)}}
        out = {}
        for lc in lcs:
            cl = {c["metadata"]["name"]: c for c in scoped[lc].list(clusterapi.CLUSTERS)[0]}
            cols = [cl[f"{lc}-{pc}"] for pc in pcs]
            rs = sorted((o for o in scoped[lc].list("deployments.apps")[0] if is_root(o)),
                        key=lambda o: int(o["metadata"]["name"].split("-")[1]))
            counts = solve_host(
                [o["spec"]["replicas"] for o in rs], np.ones((len(rs), len(cols)), bool),
                [clusterapi.allocatable_of(c) for c in cols],
                [rid.get(clusterapi.region_of(c), -1) for c in cols],
                [rid.get((o["metadata"].get("labels") or {}).get(clusterapi.REGION_LABEL, ""), -1)
                 for o in rs], spread)
            out[lc] = {f"{o['metadata']['name']}--{lc}-{pc}": int(counts[k, j])
                       for k, o in enumerate(rs) for j, pc in enumerate(pcs) if counts[k, j]}
        return out

    def leaves(scoped) -> dict:
        return {lc: {o["metadata"]["name"]: o["spec"]["replicas"]
                     for o in scoped[lc].list("deployments.apps")[0] if not is_root(o)}
                for lc in lcs}

    def solve_s() -> tuple[int, float]:
        h = REGISTRY.snapshot().get("fleet_solve_seconds") or {"count": 0, "mean": 0.0}
        return h["count"], h["count"] * h["mean"]

    try:
        mc = MultiClusterRestClient(st.address)
        scoped = {lc: mc.cluster_client(lc) for lc in lcs}
        for i, lc in enumerate(lcs):
            for j, pc in enumerate(pcs):
                obj = new_cluster(f"{lc}-{pc}", f"fake://{pc}")
                set_capacity(obj, int(caps[i, j]), region=regions[j % len(regions)])
                scoped[lc].create(clusterapi.CLUSTERS, obj)
        _wait_registered(st, scoped, lcs, pcs, timeout)
        sched = next(c for c in st.server._controllers if isinstance(c, FleetScheduler))
        # the loop's core, which the push syncers share (the splitter
        # joins none: the scheduler took its placement lanes' decision)
        core = st.call(lambda: FusedCore.for_current_loop(device=dev))
        solved: list = []

        def record():
            # every solve's row set, recorded on the server loop
            solve = sched.solver.solve

            def recording(*args, rows=None, **kw):
                solved.append(None if rows is None else list(rows))
                return solve(*args, rows=rows, **kw)
            sched.solver.solve = recording

        st.call(record)

        start, solve0 = st.call(_ticks_launches, core), solve_s()
        t1 = time.perf_counter()
        for i, lc in enumerate(lcs):
            for k in range(roots):
                root = _root(k, int(replicas[i, k]))
                if home[i, k] >= 0:
                    root["metadata"]["labels"] = {clusterapi.REGION_LABEL: regions[home[i, k]]}
                scoped[lc].create("deployments.apps", root)
        posted_s = time.perf_counter() - t1
        want = expected(scoped)
        _until(lambda: leaves(scoped) == want, timeout, "every leaf equal to solve_host", 0.1)
        placed_s = time.perf_counter() - t1
        n_leaves = sum(len(v) for v in want.values())
        _until(lambda: st.call(lambda: sum(len(c.list("deployments.apps")[0])
                                           for c in phys.values())) == n_leaves,
               timeout, "every leaf downstream", 0.05)
        downstream_s = time.perf_counter() - t1
        ticks, empty_ticks, launches = (
            a - b for a, b in zip(st.call(_ticks_launches, core), start))
        if dev.type == "cuda" and launches < ticks - empty_ticks:
            raise RuntimeError(f"decide_and_match launched {launches} times in "
                               f"{ticks} fleet ticks, {empty_ticks} of them without rows")
        solves = solve_s()
        solves = (solves[0] - solve0[0], solves[1] - solve0[1])

        # settle: no solve for a second, then move one registration's capacity
        def settled() -> bool:
            n = len(solved)
            time.sleep(1.0)
            return len(solved) == n
        _until(settled, timeout, "the scheduler to settle", 0.0)
        first = len(solved)
        stats0 = st.call(lambda: dict(sched.solver.stats))
        rows0 = stats0["rows_solved"]
        target = f"{lcs[0]}-{pcs[0]}"
        t2 = time.perf_counter()
        for _ in range(50):
            obj = scoped[lcs[0]].get(clusterapi.CLUSTERS, target)
            new_alloc = clusterapi.allocatable_of(obj) * 4 + 1000
            obj["status"]["allocatable"] = {clusterapi.CAPACITY_KEY: new_alloc}
            try:
                scoped[lcs[0]].update_status(clusterapi.CLUSTERS, obj)
                break
            except ConflictError:
                time.sleep(0.05)
        want2 = expected(scoped)
        _until(lambda: leaves(scoped) == want2, timeout,
               "every leaf equal to solve_host after the capacity change", 0.1)
        replaced_s = time.perf_counter() - t2
        _until(settled, timeout, "the scheduler to settle", 0.0)
        after = [r for r in solved[first:]]
        keys = st.call(lambda: list(sched._row_keys))
        ours = {r for r, key in enumerate(keys) if key[0] == lcs[0]}
        if not after or after[0] is None or set(after[0]) != ours:
            raise RuntimeError(f"the capacity change's solve took rows {after[:1]}, "
                               f"want the {len(ours)} rows of {lcs[0]}")
        stray = sorted({r for rows in after for r in (rows or range(len(keys)))} - ours)
        if stray:
            raise RuntimeError(f"rows outside {lcs[0]} re-solved after the change: {stray[:8]}")
        stats1 = st.call(lambda: dict(sched.solver.stats))
        return dict(logical=n_logical, physical=n_physical, roots=n_logical * roots,
                    leaves=n_leaves, spread=spread, posted_s=posted_s,
                    placed_s=placed_s, downstream_s=downstream_s, ticks=ticks,
                    empty_ticks=empty_ticks, launches=launches,
                    fleet_solves=solves[0], fleet_solve_s=solves[1],
                    scheduler=st.call(lambda: dict(sched.stats)), solver=stats1,
                    capacity_change=dict(
                        registration=target, allocatable=new_alloc, replaced_s=replaced_s,
                        solves=len(after), first_solve_rows=len(after[0]),
                        rows_solved=stats1["rows_solved"] - rows0,
                        leaves_changed=sum(want[lc] != want2[lc] for lc in lcs)))
    finally:
        _stop_front_door(st, agents)


class _OnLoop(Client):
    """A client of a store that lives on another server's loop: every
    call runs on that loop's thread, and a watch's events are forwarded
    to the caller's loop. A store is not safe across threads; the fake
    physical clusters of a sharded fleet are each pushed to by every
    shard's loop, so each stays on a loop of its own, reached the way a
    physical cluster in another process is, without the wire."""

    def __init__(self, owner, cluster: str = "default"):
        super().__init__(owner.server.store, cluster, owner.server.scheme)
        self._owner = owner

    def _run(self, fn, *args):
        if threading.get_ident() == self._owner._thread.ident:
            return fn(*args)
        return self._owner.call(fn, *args)

    def scoped(self, cluster: str) -> "Client":
        return _OnLoop(self._owner, cluster)

    def get(self, *args, **kw):
        return self._run(lambda: Client.get(self, *args, **kw))

    def list(self, *args, **kw):
        return self._run(lambda: Client.list(self, *args, **kw))

    def create(self, *args, **kw):
        return self._run(lambda: Client.create(self, *args, **kw))

    def update(self, *args, **kw):
        return self._run(lambda: Client.update(self, *args, **kw))

    def update_status(self, *args, **kw):
        return self._run(lambda: Client.update_status(self, *args, **kw))

    def delete(self, *args, **kw):
        return self._run(lambda: Client.delete(self, *args, **kw))

    def resources(self):
        return self._run(lambda: Client.resources(self))

    def openapi_v2(self):
        return self._run(lambda: Client.openapi_v2(self))

    def watch(self, *args, **kw):
        if threading.get_ident() == self._owner._thread.ident:
            return Client.watch(self, *args, **kw)
        return _ForwardedWatch(self._owner, lambda: Client.watch(self, *args, **kw))


class _ForwardedWatch:
    """A store watch opened and read on its owner's loop, its events
    handed to the loop that opened this one (the store ``Watch``'s
    surface that informers use: ``async for`` and ``close``)."""

    def __init__(self, owner, open_watch):
        self._owner = owner
        self._caller = asyncio.get_running_loop()
        self._events: deque = deque()
        self._wakeup = asyncio.Event()
        self._closed = False
        self._real = owner.call(open_watch)  # raises as the store's watch does
        self.resource = self._real.resource

        async def start():
            self._pump = asyncio.ensure_future(self._forward())

        owner.submit(start())

    async def _forward(self) -> None:  # on the owner's loop
        try:
            while not self._real.closed:
                batch = await self._real.next_batch(0.2)
                if batch:
                    self._caller.call_soon_threadsafe(self._deliver, batch, False)
        finally:
            with contextlib.suppress(RuntimeError):  # the caller's loop has closed
                self._caller.call_soon_threadsafe(self._deliver, [], True)

    def _deliver(self, batch: list, ended: bool) -> None:
        self._events.extend(batch)
        self._closed = self._closed or ended
        self._wakeup.set()

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            with contextlib.suppress(RuntimeError):  # the owner's loop has closed
                self._owner._loop.call_soon_threadsafe(self._real.close)
            self._wakeup.set()

    def __aiter__(self):
        return self

    async def __anext__(self):
        while True:
            if self._events:
                return self._events.popleft()
            if self._closed:
                raise StopAsyncIteration
            self._wakeup.clear()
            await self._wakeup.wait()


def _watch_reader(url: str, path: str, ring):
    """A merged watch read on a thread of its own: (the thread, its events
    in arrival order as (shard index, type, cluster, name, rv, is_root),
    a list that takes a terminal ERROR's Status, a stop event). The
    thread ends at the stream's end or at the first line after ``stop``
    is set."""
    import http.client
    import json
    import threading
    from urllib.parse import urlsplit

    host, port = urlsplit(url).netloc.split(":")
    events: list = []
    errors: list = []
    stop = threading.Event()
    conn = http.client.HTTPConnection(host, int(port), timeout=600)
    conn.request("GET", path)
    resp = conn.getresponse()
    if resp.status != 200:
        conn.close()
        raise RuntimeError(f"merged watch {path}: HTTP {resp.status}")

    def read():
        try:
            while not stop.is_set():
                line = resp.readline()
                if not line:
                    return
                ev = json.loads(line)
                if ev["type"] == "ERROR":
                    errors.append(ev["object"])
                    return
                if ev["type"] == "BOOKMARK":
                    continue
                meta = ev["object"]["metadata"]
                events.append((ring.owner_index(meta["clusterName"]), ev["type"],
                               meta["clusterName"], meta["name"],
                               int(meta["resourceVersion"]), is_root(ev["object"])))
        finally:
            conn.close()

    t = threading.Thread(target=read, daemon=True, name="merged-watch")
    t.start()
    return t, events, errors, stop


def _hist_window(name: str, before: list) -> tuple[int, float, float]:
    """A histogram's observations since ``before`` (its bucket counts
    then): their count and p50/p99 as bucket upper edges (seconds)."""
    from .utils.trace import REGISTRY

    h = REGISTRY.histogram(name)
    counts = [a - b for a, b in zip(h.counts, before)]
    n = sum(counts)

    def q(frac):
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if n and seen >= frac * n:
                return h.buckets[i] if i < len(h.buckets) else float("inf")
        return 0.0

    return n, q(0.5), q(0.99)


def sharded_front_door_load(device=None, n_logical: int = 16, n_physical: int = 4,
                            roots: int = 64, n_shards: int = 4, seed: int = 0,
                            timeout: float = 300.0) -> dict:
    """The front door's controller plane spread over a sharded control
    plane: ``n_shards`` durable shard servers (``ServerThread``s, one loop
    and hence one ``FusedCore`` each, a WAL each under a temporary root,
    ``shard_name="s<i>"``, ``ring_names`` every shard, ring epoch 1,
    controllers on ``device``, TLS off, 0.2 s polls, APIs published
    automatically) behind a ``role="router"`` server. Every logical
    cluster's controllers run on the shard HRW names for it.

    The ``n_physical`` fake physical clusters are stores of in-memory
    servers of their own, each with a ``FakeClusterAgent`` on its loop:
    one ``PhysicalRegistry`` is shared by every shard, and it resolves a
    ``loop://pc-<j>`` kubeconfig to a client that runs each call on that
    server's loop (``_OnLoop``: every shard pushes to every physical
    cluster, and a store is not safe across threads).

    Driven from this thread through the router: every logical cluster
    registers every physical cluster as ``<lc>-pc-<j>``; a merged wildcard
    watch on deployments opens; ``roots`` root Deployments per logical
    cluster (seeded replicas in 1..100) are POSTed, the even-index logical
    clusters' direct with a ``SmartRestClient``, the odd ones' routed with
    a ``RestClient``. Checks, raising RuntimeError on the first that
    fails: every import Compatible and Available and every cluster Ready
    (read through the router); ``smart_client_direct_total`` rose by at
    least the direct POSTs and ``smart_client_fallback_total`` not at
    all; every leaf downstream equal to the CPU split; each logical
    cluster's roots and leaves on its HRW shard's store and on no other;
    every root's readyReplicas (read through the router) equal to its
    replicas; the merged watch saw each root's ADDED once, and a second
    watch resumed from the vector RV of the event seen halfway yields
    exactly the rest of each shard's stream; the router's wildcard list
    holds each shard's items byte for byte; on each shard's core, on a
    card, at least one ``decide_and_match`` launch per fleet tick with
    synced rows and more than none in all; nothing quarantined. Returns
    the readings of the window from the first root POST (the router's
    scatter fan-out over the whole phase)."""
    import json
    import shutil
    import tempfile
    import time

    import numpy as np

    from .apis.cluster import new_cluster
    from .client.smart import SmartRestClient
    from .ops.cuda_kernels import decide_and_match
    from .server import Config, MultiClusterRestClient, RestClient
    from .server.threaded import ServerThread
    from .sharding import ShardRing, decode_rvmap, encode_rvmap
    from .utils.trace import REGISTRY

    dev = resolve_device(device)
    lcs = [f"lc-{i:02d}" for i in range(n_logical)]
    pcs = [f"pc-{j}" for j in range(n_physical)]
    replicas, want = _seeded_roots(seed, n_logical, n_physical, roots)
    n_leaves = n_logical * roots * n_physical
    deployments = "/apis/apps/v1/deployments"
    registry = PhysicalRegistry()
    registry.register_factory("loop", lambda url: _OnLoop(physical[url[len("loop://"):]]))
    root_dir = tempfile.mkdtemp(prefix="kcp-sharded-front-door-")
    physical: dict = {}
    agents: list = []
    shards: list = []
    router = watch = None

    def counter(name: str) -> float:
        return REGISTRY.counter(name).value

    def items_of(st, cluster: str = "*") -> dict:
        """A server's wildcard (or one cluster's) deployments, raw bytes
        per (cluster, name)."""
        status, _h, body = RestClient(st.address, cluster=cluster).request_raw(
            "GET", f"/clusters/{cluster}{deployments}")
        if status != 200:
            raise RuntimeError(f"{st.address}: list deployments HTTP {status}")
        doc = json.loads(body)
        return {(o["metadata"]["clusterName"], o["metadata"]["name"]): json.dumps(o)
                for o in doc["items"]}

    try:
        for pc in pcs:
            st = ServerThread(Config(durable=False, tls=False, install_controllers=False)
                              ).start(timeout)
            physical[pc] = st

            async def start_agent(store=st.server.store):
                agent = FakeClusterAgent(Client(store, "default"))
                await agent.start()
                return agent

            agents.append((st, st.submit(start_agent())))
        names = ",".join(f"s{i}" for i in range(n_shards))
        for i in range(n_shards):
            shards.append(ServerThread(Config(
                durable=True, root_dir=os.path.join(root_dir, f"shard{i}"), tls=False,
                poll_interval=0.2, import_poll_interval=0.2, auto_publish_apis=True,
                device=device, shard_name=f"s{i}", ring_names=names, ring_epoch=1),
                registry=registry).start(timeout))
        spec = ",".join(f"s{i}={t.address}" for i, t in enumerate(shards))
        router = ServerThread(Config(role="router", shards=spec, durable=False,
                                     tls=False)).start(timeout)
        ring = ShardRing.from_spec(spec)
        owner = {lc: ring.owner_index(lc) for lc in lcs}
        owned = [[lc for lc in lcs if owner[lc] == i] for i in range(n_shards)]
        mc = MultiClusterRestClient(router.address)
        scoped = {lc: mc.cluster_client(lc) for lc in lcs}
        quarantined0 = counter("quarantined_rows")
        fanout0 = list(REGISTRY.histogram("router_scatter_fanout").counts)

        # 1. registrations through the router
        t0 = time.perf_counter()
        for lc in lcs:
            for pc in pcs:
                scoped[lc].create(clusterapi.CLUSTERS,
                                  new_cluster(f"{lc}-{pc}", f"loop://{pc}"))

        def syncers(st) -> int:
            clusters = next(c for c in st.server._controllers
                            if isinstance(c, ClusterController))
            return len(clusters.syncers)

        def registered() -> bool:
            return (all(st.call(syncers, st) == len(owned[i]) * n_physical
                        for i, st in enumerate(shards))
                    and all(ar.is_compatible_and_available(scoped[lc].get(
                        ar.APIRESOURCEIMPORTS, f"{lc}-{pc}.deployments.v1.apps"))
                        for lc in lcs for pc in pcs)
                    and all("deployments.apps" in clusterapi.synced_resources(c)
                            and clusterapi.is_ready(c)
                            for lc in lcs for c in scoped[lc].list(clusterapi.CLUSTERS)[0]))

        _until(registered, timeout,
               "every import Compatible+Available, every cluster Ready (through the router)")
        ready_s = time.perf_counter() - t0
        cores = []
        for st in shards:
            splitter = next(c for c in st.server._controllers
                            if isinstance(c, DeploymentSplitter))
            cores.append(splitter.core)

        def core_reading(core):
            # on the shard's loop: its fleet ticks and the launches made
            # from its thread
            import threading

            stats = core._fleet.stats if core._fleet is not None else {}
            return (stats.get("ticks", 0), stats.get("empty_ticks", 0),
                    decide_and_match.by_thread.get(threading.get_ident(), 0),
                    stats.get("quarantined", 0))

        # 2. the merged watch, from the vector RV of a wildcard list
        start_vector = mc._request("GET", f"/clusters/*{deployments}")[
            "metadata"]["resourceVersion"]
        watch = _watch_reader(router.address, f"/clusters/*{deployments}?watch=true"
                              f"&resourceVersion={start_vector}", ring)

        # 3. the roots: even logical clusters direct, odd ones routed
        clients = {lc: (SmartRestClient(router.address, cluster=lc) if i % 2 == 0
                        else RestClient(router.address, cluster=lc))
                   for i, lc in enumerate(lcs)}
        for i, lc in enumerate(lcs):
            if i % 2 == 0 and clients[lc]._ring_snapshot()[0] is None:
                raise RuntimeError("the smart client found no ring at the router")
        before = [st.call(core_reading, core) for st, core in zip(shards, cores)]
        direct0, fallback0 = (counter("smart_client_direct_total"),
                              counter("smart_client_fallback_total"))
        proxy0 = list(REGISTRY.histogram("router_proxy_seconds").counts)
        cpu0 = time.process_time()
        t1 = time.perf_counter()
        latencies = {"direct": [], "routed": []}
        for i, lc in enumerate(lcs):
            kind = "direct" if i % 2 == 0 else "routed"
            for k in range(roots):
                c0 = time.perf_counter()
                clients[lc].create("deployments.apps", _root(k, int(replicas[i, k])))
                latencies[kind].append(time.perf_counter() - c0)
        posted_s = time.perf_counter() - t1
        proxied = _hist_window("router_proxy_seconds", proxy0)
        direct = counter("smart_client_direct_total") - direct0
        fallback = counter("smart_client_fallback_total") - fallback0
        if direct < len(latencies["direct"]) or fallback:
            raise RuntimeError(f"smart clients: {direct:.0f} direct requests for "
                               f"{len(latencies['direct'])} direct POSTs, {fallback:.0f} "
                               f"fallbacks through the router")

        # 4. every leaf downstream, equal to the CPU split
        def leaves() -> dict:
            return {pc: physical[pc].call(lambda st=physical[pc]: {
                o["metadata"]["name"]: o["spec"]["replicas"]
                for o in Client(st.server.store, "default").list("deployments.apps")[0]})
                for pc in pcs}

        _until(lambda: sum(map(len, leaves().values())) == n_leaves, timeout,
               "every leaf downstream", 0.05)
        leaves_s = time.perf_counter() - t1

        # 5. every root aggregated, read through the router
        def aggregated() -> bool:
            for lc in lcs:
                items = scoped[lc].list("deployments.apps")[0]
                got = [o for o in items if is_root(o)]
                if len(got) != roots or any((o.get("status") or {}).get(
                        "readyReplicas") != o["spec"]["replicas"] for o in got):
                    return False
            return True

        _until(aggregated, timeout, "every root's readyReplicas aggregated through the router",
               0.05)
        aggregated_s = time.perf_counter() - t1
        cpu_s = time.process_time() - cpu0
        after = [st.call(core_reading, core) for st, core in zip(shards, cores)]
        _check_leaves(leaves(), lcs, pcs, want, roots)
        per_lc = roots * (1 + n_physical)  # roots and their leaves in the tenant
        for i, st in enumerate(shards):
            by_lc: dict = {}
            for lc, _name in items_of(st):
                by_lc[lc] = by_lc.get(lc, 0) + 1
            if by_lc != {lc: per_lc for lc in owned[i]}:
                raise RuntimeError(f"shard s{i} holds deployments {by_lc}; HRW gives it "
                                   f"{owned[i]} with {per_lc} each")

        # 6. the merged watch, and a resume from its midpoint's vector RV
        tips = [max((int(json.loads(raw)["metadata"]["resourceVersion"])
                     for raw in items_of(st).values()), default=0) for st in shards]

        def caught_up(reader) -> bool:
            _t, got, errs, _stop = reader
            if errs:
                raise RuntimeError(f"merged watch ended: {errs}")
            last = [0] * n_shards
            for e in list(got):
                last[e[0]] = max(last[e[0]], e[4])
            return all(a >= b for a, b in zip(last, tips))

        _until(lambda: caught_up(watch), timeout, "the merged watch at every shard's tip")
        watch[3].set()
        seen = list(watch[1])
        added: dict = {}
        for _i, etype, lc, name, _rv, root in seen:
            if root and etype == "ADDED":
                added[(lc, name)] = added.get((lc, name), 0) + 1
        if len(added) != n_logical * roots or set(added.values()) != {1}:
            raise RuntimeError(f"the merged watch saw {len(added)} roots ADDED "
                               f"(want {n_logical * roots}), counts {set(added.values())}")
        # the client's vector after the event seen halfway: each shard's RV
        # at its last event among the first half of the arrivals (a DELETED
        # event carries its object's last RV, not a stream position)
        start = decode_rvmap(int(start_vector), n_shards)
        mid, rest = list(start), {i: [] for i in range(n_shards)}
        for k, e in enumerate(seen):
            if k < len(seen) // 2 and e[1] != "DELETED":
                mid[e[0]] = e[4]
                rest[e[0]] = []
            else:
                rest[e[0]].append(e)
        resumed = _watch_reader(router.address, f"/clusters/*{deployments}?watch=true"
                                f"&resourceVersion={encode_rvmap(mid)}", ring)
        try:
            _until(lambda: caught_up(resumed), timeout,
                   "the resumed watch at every shard's tip")
        finally:
            resumed[3].set()
        for i in range(n_shards):
            got = [e for e in resumed[1] if e[0] == i]
            if got != rest[i]:
                raise RuntimeError(f"the watch resumed from the midpoint's vector RV "
                                   f"differs on shard s{i}: {len(got)} events, "
                                   f"{len(rest[i])} expected")

        # 7. the router's wildcard list against the shards' own
        def lists_equal() -> bool:
            merged = items_of(router)
            union: dict = {}
            for st in shards:
                union.update(items_of(st))
            return merged == union and len(merged) == n_logical * per_lc

        _until(lists_equal, 60.0, "the router's wildcard list equal to the shards'")
        fanout = _hist_window("router_scatter_fanout", fanout0)

        # 8. each shard's core
        per_shard = []
        for i, (b, a) in enumerate(zip(before, after)):
            ticks, empty, launches, quarantined = (x - y for x, y in zip(a, b))
            if dev.type == "cuda" and (launches < ticks - empty or launches <= 0):
                raise RuntimeError(f"shard s{i}: decide_and_match launched {launches} "
                                   f"times in {ticks} fleet ticks, {empty} without rows")
            if quarantined:
                raise RuntimeError(f"shard s{i}: {quarantined} rows quarantined")
            per_shard.append(dict(shard=f"s{i}", logical=owned[i], ticks=ticks,
                                  empty_ticks=empty, launches=launches,
                                  leaves=len(owned[i]) * roots * n_physical))
        quarantined = counter("quarantined_rows") - quarantined0
        if quarantined:
            raise RuntimeError(f"{quarantined} rows quarantined")
        for c in clients.values():
            c.close()
        ms = {k: np.array(v) * 1e3 for k, v in latencies.items()}
        return dict(
            shards=n_shards, logical=n_logical, physical=n_physical,
            roots=n_logical * roots, leaves=n_leaves, ready_s=ready_s, posted_s=posted_s,
            leaves_s=leaves_s, aggregated_s=aggregated_s, cpu_s=cpu_s,
            create_ms={k: (len(v), float(np.percentile(v, 50)), float(np.percentile(v, 99)))
                       for k, v in ms.items()},
            smart_direct=direct, smart_fallback=fallback,
            router_proxy=proxied, router_fanout=fanout,
            watch_events=len(seen), resumed_events=sum(map(len, rest.values())),
            ring_spread={f"s{i}": len(o) for i, o in enumerate(owned)},
            per_shard=per_shard)
    finally:
        if watch is not None:
            watch[3].set()
        if router is not None:
            router.stop()
        for st in shards:
            st.stop()
        for st, agent in agents:
            st.submit(_stop_agents([agent]))
        for st in physical.values():
            st.stop()
        shutil.rmtree(root_dir, ignore_errors=True)


async def _stop_agents(agents) -> None:
    for agent in agents:
        await agent.stop()


def demo_mesh(spec: str, device) -> "object | None":
    """A mesh of ``spec``'s shape over copies of one device (None for an
    empty spec)."""
    if not spec:
        return None
    n = math.prod(int(x) for x in spec.split("x"))
    return mesh_from_spec(spec, devices=[resolve_device(device)] * n)


async def run(which: str = "all", device=None, mesh=None, echo=False) -> list[str]:
    """Run the named scenario (or both) and return its transcript."""
    lines: list[str] = []

    def emit(line: str) -> None:
        lines.append(line)
        if echo:
            print(line, flush=True)

    if which in ("apiNegotiation", "all"):
        await demo_api_negotiation(emit, device, mesh)
    if which in ("kubecon", "all"):
        await demo_kubecon(emit, device, mesh)
    return lines


def golden() -> list[str]:
    with open(GOLDEN, encoding="utf-8") as f:
        return f.read().splitlines()


def diff(want: list[str], got: list[str]) -> list[str]:
    """``-``/``+`` line pairs where the transcripts differ."""
    pad = [""] * max(len(want), len(got))
    return [f"- {w}\n+ {g}" for w, g in zip(want + pad, got + pad) if w != g]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m kcp_tpu_torch.demo")
    ap.add_argument("which", nargs="?", default="all", choices=(*SCENARIOS, "all"))
    ap.add_argument("--check", action="store_true",
                    help="compare the transcript with contrib/demo/demo.result")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--mesh", default="", help='shard the core, e.g. "4" or "4x2"')
    args = ap.parse_args(argv)
    if args.check and args.which != "all":
        print("--check requires running all scenarios", file=sys.stderr)
        return 2
    if args.device == "cpu":
        torch.set_num_threads(1)  # these tiny ops only lose to the thread pool
    mesh = demo_mesh(args.mesh, args.device)
    got = asyncio.run(run(args.which, args.device, mesh, echo=True))
    if args.check:
        bad = diff(golden(), got)
        if bad:
            print("GOLDEN MISMATCH", file=sys.stderr)
            print("\n".join(bad), file=sys.stderr)
            return 1
        print("golden check: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
