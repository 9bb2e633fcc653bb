"""The port's multi-cluster controller plane against the JAX package's,
on the CPU.

- The reference's own cases of ``test_conditions.py``,
  ``test_schemacompat.py``, ``test_lcd_properties.py``,
  ``test_negotiation.py``, ``test_namespace.py``, ``test_splitter.py`` and
  ``test_full_loop.py``, run against the port (``port_module``: the
  source read with ``kcp_tpu`` as ``kcp_tpu_torch``, the controllers that
  default to the card bound to ``device="cpu"``).
- Splitter parity: seeded roots over seeded cluster sets (one logical
  cluster wider than the placement lanes' floor of 8) go through the
  port's fused lane and through the JAX ``DeploymentSplitter`` with
  ``backend="tpu"``; the leaf replica counts and the aggregated root
  statuses are equal.
- The demo CLI: ``python -m kcp_tpu_torch.demo all --check`` on the
  CPU, without a mesh and on a ``4x2`` mesh, equals
  ``contrib/demo/demo.result``.
- No fallback hides the card: a fused controller built with
  ``device=None`` raises without one, and the loop's one ``FusedCore``
  refuses a caller asking for another device or mesh.

Every comparison is exact equality.
"""

import asyncio
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_engine import _cases, port_module, run_mirrored

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MIRRORED = (
    _cases("test_conditions.py")
    + _cases("test_schemacompat.py")
    + _cases("test_lcd_properties.py")
    + _cases("test_negotiation.py")
    + _cases("test_namespace.py")
    + _cases("test_splitter.py")
    + _cases("test_full_loop.py")
)


@pytest.mark.parametrize("ref_file,name,kwargs", MIRRORED)
def test_reference_controller_case_against_the_port(ref_file, name, kwargs, request):
    run_mirrored(ref_file, name, kwargs, request)


def test_mirrored_controllers_are_the_ports_on_the_cpu():
    from kcp_tpu_torch.reconcilers.deployment import DeploymentSplitter

    split = port_module("test_splitter.py").DeploymentSplitter
    assert split.func is DeploymentSplitter and split.keywords == {"device": "cpu"}
    loop = port_module("test_full_loop.py")
    for name in ("NegotiationController", "ClusterController", "DeploymentSplitter"):
        bound = getattr(loop, name)
        assert bound.func.__module__.startswith("kcp_tpu_torch.")
        assert bound.keywords == {"device": "cpu"}
    # 3 + 20 + 3 + 6 + 7 + 8 + 3 test functions, before parametrisation
    names = {(p.values[0], p.values[1]) for p in MIRRORED}
    assert len(names) == 50


# ------------------------------------------------------- splitter parity


def _splitter_scenario(seed: int) -> tuple[dict, dict]:
    """Seeded logical clusters, cluster sets and roots: ``{lc: [cluster
    names]}`` and ``{lc: [(root, replicas)]}``. One logical cluster has
    no clusters, one has more than 8."""
    rng = np.random.default_rng(seed)
    widths = [0, 1, 3, int(rng.integers(9, 13))]
    clusters = {f"lc-{i}": sorted(f"pc-{j:02d}" for j in rng.choice(40, n, replace=False))
                for i, n in enumerate(widths)}
    roots = {lc: [(f"r{k}", int(rng.integers(0, 101))) for k in range(int(rng.integers(4, 9)))]
             for lc in clusters}
    return clusters, roots


def _drive_splitter(pkg: str, clusters: dict, roots: dict, seed: int,
                    zero_placed: bool = True, **kw) -> tuple[dict, dict, dict]:
    """Run one package's splitter over the scenario: split, then give every
    leaf a seeded status and wait for the fan-in. Returns the leaf replica
    counts, the root statuses and the splitter's stats.
    ``zero_placed=False`` expects no leaves for roots of 0 replicas."""
    capi = importlib.import_module(f"{pkg}.apis.cluster")
    client_mod = importlib.import_module(f"{pkg}.client")
    dep = importlib.import_module(f"{pkg}.reconcilers.deployment.controller")
    store_mod = importlib.import_module(f"{pkg}.store")

    async def until(pred, timeout=60.0):
        end = asyncio.get_running_loop().time() + timeout
        while not pred():
            assert asyncio.get_running_loop().time() < end, "splitter did not converge"
            await asyncio.sleep(0.01)

    async def main():
        mc = client_mod.MultiClusterClient(store_mod.LogicalStore())
        for lc, names in clusters.items():
            for name in names:
                mc.cluster_client(lc).create(capi.CLUSTERS, capi.new_cluster(name))
        splitter = dep.DeploymentSplitter(mc, **kw)
        await splitter.start()
        for lc, rs in roots.items():
            for name, replicas in rs:
                mc.cluster_client(lc).create(dep.DEPLOYMENTS, {
                    "apiVersion": "apps/v1", "kind": "Deployment",
                    "metadata": {"name": name, "namespace": "default"},
                    "spec": {"replicas": replicas}})

        def leaves():
            items, _ = mc.list(dep.DEPLOYMENTS)
            return [o for o in items if not dep.is_root(o)]

        want = sum(len(clusters[lc]) for lc, rs in roots.items()
                   for _, replicas in rs if replicas or zero_placed)
        await until(lambda: len(leaves()) == want)
        await asyncio.sleep(0.05)  # a stray leaf would show by now
        assert len(leaves()) == want
        counts = {(o["metadata"]["clusterName"], o["metadata"]["name"]): o["spec"]["replicas"]
                  for o in leaves()}
        rng = np.random.default_rng(seed)
        expect = {}
        for (lc, name), replicas in sorted(counts.items()):
            ready = int(rng.integers(0, replicas + 1))
            scoped = mc.cluster_client(lc)
            leaf = scoped.get(dep.DEPLOYMENTS, name, "default")
            leaf["status"] = {"replicas": replicas, "updatedReplicas": replicas,
                              "readyReplicas": ready, "availableReplicas": ready,
                              "unavailableReplicas": replicas - ready}
            scoped.update_status(dep.DEPLOYMENTS, leaf)
            root = (lc, name.split("--")[0])
            expect[root] = expect.get(root, 0) + ready

        def statuses():
            out = {}
            for lc, rs in roots.items():
                for name, _ in rs:
                    out[(lc, name)] = mc.cluster_client(lc).get(
                        dep.DEPLOYMENTS, name, "default").get("status", {})
            return out

        await until(lambda: all(statuses()[k].get("readyReplicas", 0) == v
                                for k, v in expect.items()))
        await splitter.stop()
        return counts, statuses(), dict(splitter.stats)

    return asyncio.run(main())


@pytest.mark.parametrize("seed", [5, 17])
def test_fused_splitter_equals_the_reference(seed):
    """The port's fused lane against the JAX splitter's fused lane and
    host lane. The JAX fused lane never places a root of 0 replicas (its
    all-zero split equals the device row's initial ``current``, so the row
    never turns dirty); the port applies that split on the host, as both
    host lanes do. So roots of 1 or more replicas are held against the
    JAX fused lane, and every root against the JAX host lane."""
    clusters, roots = _splitter_scenario(seed)
    counts, status, stats = _drive_splitter("kcp_tpu_torch", clusters, roots, seed,
                                            backend="fused", device="cpu")
    ref_counts, ref_status, _ = _drive_splitter("kcp_tpu", clusters, roots, seed,
                                                zero_placed=False, backend="tpu")
    host_counts, host_status, _ = _drive_splitter("kcp_tpu", clusters, roots, seed,
                                                  backend="host")
    assert counts == host_counts
    assert status == host_status
    replicas = {(lc, name): r for lc, rs in roots.items() for name, r in rs}
    placed = {k: v for k, v in counts.items()
              if replicas[(k[0], k[1].split("--")[0])] > 0}
    assert placed == ref_counts
    assert {k: v for k, v in status.items() if replicas[k] > 0} == \
        {k: v for k, v in ref_status.items() if replicas[k] > 0}
    # every root of 1 or more replicas with a cluster went through the
    # fused lane; zero-replica roots through the host split
    n_zero = sum(1 for lc, rs in roots.items() for _, r in rs if clusters[lc] and not r)
    n_placed = sum(len(rs) for lc, rs in roots.items() if clusters[lc])
    assert stats["fused_placements"] == n_placed - n_zero
    assert stats["host_placements"] == n_zero
    assert max(len(c) for c in clusters.values()) > 8


def test_fused_splitter_equals_the_host_lane():
    clusters, roots = _splitter_scenario(23)
    fused = _drive_splitter("kcp_tpu_torch", clusters, roots, 23, device="cpu")
    host = _drive_splitter("kcp_tpu_torch", clusters, roots, 23, backend="host")
    assert fused[:2] == host[:2]
    assert host[2]["fused_placements"] == 0


# ------------------------------------------------------------------ demo


@pytest.mark.parametrize("mesh", ["", "4x2"])
def test_demo_cli_matches_the_golden_transcript(mesh):
    cmd = [sys.executable, "-m", "kcp_tpu_torch.demo", "all", "--check", "--device", "cpu"]
    if mesh:
        cmd += ["--mesh", mesh]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=180, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[-1] == "golden check: OK"
    with open(os.path.join(REPO, "contrib", "demo", "demo.result")) as f:
        assert lines[:-1] == f.read().splitlines()


def test_demo_scenarios_in_process_match_the_golden_transcript():
    """The port's scenario functions, called as chip_smoke does, give the
    golden transcript; a kubecon run on a mesh goes through the sharded
    step."""
    from kcp_tpu_torch import demo

    async def main():
        return await demo.run("all", device="cpu")

    assert asyncio.run(main()) == demo.golden()
    mesh = demo.demo_mesh("4", "cpu")
    assert len(mesh.grid) == 4
    assert asyncio.run(demo.run("kubecon", "cpu", mesh)) == demo.golden()[7:]


def test_controller_plane_load_checks_hold_on_the_cpu():
    """chip_smoke's phase 7 at a small size: every check of the load
    passes, every root rides the fused lanes, one core serves all."""
    from kcp_tpu_torch import demo

    out = asyncio.run(demo.controller_plane_load("cpu", None, n_logical=3,
                                                 n_physical=3, roots=16, seed=1))
    assert out["syncers"] == 9 and out["physical"] == 3
    assert out["roots"] == 48 and out["leaves"] == 144
    assert out["fused_placements"] == 48 and out["ticks"] > 0


@pytest.mark.parametrize("pkg", ["kcp_tpu_torch", "kcp_tpu"])
def test_crd_establishment_reaches_other_informers_as_a_change(pkg):
    """The CRD lifecycle controller establishes a copy of the CRD: another
    informer's MODIFIED event carries the old object without the
    condition. The reference sets it on its informer's object, which is
    the store's shared snapshot, so every other informer's old object
    already has it; the negotiation controller then reads the event as
    no change, and a resource whose CRD it saw before the establishment
    is never marked Published."""
    crdapi = importlib.import_module(f"{pkg}.apis.crd")
    client_mod = importlib.import_module(f"{pkg}.client")
    lifecycle = importlib.import_module(f"{pkg}.reconcilers.crdlifecycle")
    store_mod = importlib.import_module(f"{pkg}.store")

    async def main():
        mc = client_mod.MultiClusterClient(store_mod.LogicalStore())
        seen = []
        inf = client_mod.Informer(mc, crdapi.CRDS)
        inf.add_handler(lambda etype, old, new: seen.append(
            (etype, bool(old) and crdapi.is_established(old), crdapi.is_established(new))))
        await inf.start()
        life = lifecycle.CRDLifecycleController(mc)
        await life.start()
        mc.cluster_client("t").create(
            crdapi.CRDS, crdapi.new_crd("example.dev", "v1", "widgets", "Widget"))
        for _ in range(500):
            if any(est for _, _, est in seen):
                break
            await asyncio.sleep(0.01)
        await life.stop()
        await inf.stop()
        return seen

    seen = asyncio.run(main())
    assert seen[0] == ("ADDED", False, False)
    assert seen[-1] == ("MODIFIED", pkg == "kcp_tpu", True)


def test_each_cluster_starts_its_push_syncer_once(monkeypatch):
    """The cluster controller decides a restart against the stored
    Cluster: the informer's copy may not show the status its previous
    reconcile wrote, and the reference restarts the syncer it has just
    started (the restart pops it from ``syncers`` while it stops, which
    ``test_full_loop.test_cluster_deletion_cleanup`` can catch)."""
    from kcp_tpu_torch import demo
    from kcp_tpu_torch.reconcilers.cluster import controller as cc

    restarts = []
    real = cc.ClusterController._restart_syncer

    async def counted(self, key, cluster, scoped, physical, synced):
        restarts.append((key, tuple(synced)))
        return await real(self, key, cluster, scoped, physical, synced)

    monkeypatch.setattr(cc.ClusterController, "_restart_syncer", counted)
    out = asyncio.run(demo.controller_plane_load("cpu", None, n_logical=2,
                                                 n_physical=3, roots=4, seed=2))
    assert out["syncers"] == 6
    assert sorted(restarts) == sorted(
        ((lc, f"{lc}-pc-{j}"), ("deployments.apps",)) for lc in ("lc-00", "lc-01")
        for j in range(3))


def _share_one_physical_cluster(pkg: str, same_name: bool) -> tuple[set, list, dict, set]:
    """Logical clusters ``a`` and ``b`` both register the fake physical
    cluster ``fake://shared`` (as ``shared`` in both, or as ``a-shared``
    and ``b-shared``), and each creates one root Deployment. Returns the
    leaf names placed downstream (each seen at least once: under a shared
    name the two may never stand there at the same instant), the leaf
    names seen every 10 ms for 3 s after that, and the roots' final
    readyReplicas."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    capi, cl = mod("apis.cluster"), mod("reconcilers.cluster")
    kw = {"device": "cpu"} if pkg == "kcp_tpu_torch" else {}
    roots = {"a": ("alpha", 3), "b": ("beta", 5)}
    names = {lc: "shared" if same_name else f"{lc}-shared" for lc in roots}
    leaves = {f"{root}--{names[lc]}" for lc, (root, _) in roots.items()}

    async def main():
        mc = mod("client").MultiClusterClient(mod("store").LogicalStore())
        registry = mod("physical").PhysicalRegistry()
        controllers = [
            mod("reconcilers.apiresource").NegotiationController(mc, auto_publish=True, **kw),
            mod("reconcilers.crdlifecycle").CRDLifecycleController(mc),
            cl.ClusterController(mc, registry, resources_to_sync=["deployments.apps"],
                                 mode=cl.SyncerMode.PUSH, poll_interval=0.2,
                                 import_poll_interval=0.2, **kw),
            mod("reconcilers.deployment").DeploymentSplitter(mc, **kw)]
        for c in controllers:
            await c.start()
        phys = registry.resolve("fake://shared")
        agent = mod("physical").FakeClusterAgent(phys)
        await agent.start()
        for lc, (root, replicas) in roots.items():
            scoped = mc.cluster_client(lc)
            scoped.create(capi.CLUSTERS, capi.new_cluster(names[lc], "fake://shared"))
            scoped.create("deployments.apps", {
                "apiVersion": "apps/v1", "kind": "Deployment",
                "metadata": {"name": root, "namespace": "default"},
                "spec": {"replicas": replicas, "selector": {"matchLabels": {"app": root}},
                         "template": {"metadata": {"labels": {"app": root}},
                                      "spec": {"containers": [{"name": "c", "image": "x"}]}}}})

        def downstream():
            return {o["metadata"]["name"] for o in phys.list("deployments.apps")[0]}

        placed = set()
        for _ in range(3000):
            placed |= downstream()
            if placed == leaves:
                break
            await asyncio.sleep(0.01)
        seen = []
        for _ in range(300):
            seen.append(downstream())
            await asyncio.sleep(0.01)
        ready = {lc: mc.cluster_client(lc).get("deployments.apps", root, "default")
                 .get("status", {}).get("readyReplicas") for lc, (root, _) in roots.items()}
        await agent.stop()
        for c in reversed(controllers):
            await c.stop()
        return placed, seen, ready, leaves

    return asyncio.run(main())


@pytest.mark.parametrize("pkg", ["kcp_tpu_torch", "kcp_tpu"])
@pytest.mark.parametrize("same_name", [False, True])
def test_logical_clusters_sharing_a_physical_cluster(pkg, same_name):
    """Two logical clusters on one physical cluster, in both packages. A
    push syncer owns, downstream, every object labelled with its Cluster's
    name and deletes those its own logical cluster does not hold. Under
    distinct Cluster names both tenants' leaves stay and report ready.
    Under one name each tenant's syncer deletes the other's leaf, again
    and again: a limitation of the reference that the port keeps."""
    placed, seen, ready, leaves = _share_one_physical_cluster(pkg, same_name)
    assert placed == leaves  # both leaves were placed
    if same_name:
        assert any(s != leaves for s in seen), "no leaf was deleted under a shared name"
    else:
        assert all(s == leaves for s in seen)
        assert ready == {"a": 3, "b": 5}


# ------------------------------------------------------ device contract


def test_fused_controllers_refuse_a_missing_card(monkeypatch):
    from kcp_tpu_torch.client import MultiClusterClient
    from kcp_tpu_torch.physical import PhysicalRegistry
    from kcp_tpu_torch.reconcilers.apiresource import NegotiationController
    from kcp_tpu_torch.reconcilers.cluster import ClusterController, SyncerMode
    from kcp_tpu_torch.reconcilers.deployment import DeploymentSplitter
    from kcp_tpu_torch.store import LogicalStore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mc = MultiClusterClient(LogicalStore())
    for make in (lambda: NegotiationController(mc),
                 lambda: ClusterController(mc, PhysicalRegistry()),
                 lambda: DeploymentSplitter(mc)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    # the lanes that run no device code need none
    assert DeploymentSplitter(mc, backend="host").device is None
    assert ClusterController(mc, PhysicalRegistry(), mode=SyncerMode.PULL).device is None
    for cls in (NegotiationController, DeploymentSplitter):
        with pytest.raises(ValueError, match="fused"):
            cls(mc, backend="tpu")


def test_one_core_per_loop_refuses_another_device_or_mesh(monkeypatch):
    from kcp_tpu_torch.parallel import mesh_from_spec
    from kcp_tpu_torch.syncer.core import FusedCore

    mesh = mesh_from_spec("2", devices=[torch.device("cpu")] * 2)

    async def main():
        core = FusedCore.for_current_loop(device="cpu")
        await core.start()
        try:
            assert FusedCore.for_current_loop(device=torch.device("cpu")) is core
            with pytest.raises(ValueError, match="mesh"):
                FusedCore.for_current_loop(mesh=mesh)
            with pytest.raises(RuntimeError, match="CUDA"):
                FusedCore.for_current_loop()  # None is the card: none here
        finally:
            await core.stop()
        sharded = FusedCore.for_current_loop(mesh=mesh)
        assert sharded is not core and sharded.mesh == mesh
        await sharded.start()
        try:
            assert FusedCore.for_current_loop(mesh=mesh, device="cpu") is sharded
            with pytest.raises(ValueError, match="mesh"):
                FusedCore.for_current_loop(device="cpu")
        finally:
            await sharded.stop()

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    asyncio.run(main())
