"""Deployment splitter: multi-cluster workload placement, batched.

The reference controller (pkg/reconciler/deployment/) splits a root
Deployment's replicas across registered Clusters into labeled leaf
Deployments and aggregates leaf status back into the root, one object per
goroutine wakeup. Here, with ``backend="fused"``, every root of every
logical cluster rides the placement lanes of the loop's ``FusedCore``:
the same device step that serves the push syncers computes the split,
and the status fan-in sums leaf counters with
``ops/placement.aggregate_status`` on the splitter's device.
``backend="host"`` keeps both lanes in numpy.

Behavior parity (pkg/reconciler/deployment/deployment.go):
- a deployment without the ``kcp.dev/cluster`` label is a *root*; with it,
  a *leaf* (deployment.go:24)
- leafs are named ``<root>--<cluster>``, labeled with cluster + owned-by,
  owner-referenced to the root (deployment.go:127-157)
- replicas: even split; the whole remainder lands on the first cluster
  (deployment.go:127-145); no registered clusters -> Progressing=False
  with reason NoRegisteredClusters (deployment.go:110-123)
- leafs are only created when none exist yet (deployment.go:35-39);
  ``rebalance=True`` opts into re-splitting on root/cluster changes (an
  improvement over the reference, off by default for golden parity)
- status: sum the 5 replica counters over leafs; conditions copied from
  the first leaf; conflicts requeue (deployment.go:71-103)
"""

from __future__ import annotations

import copy
import logging
from typing import Sequence

import numpy as np
import torch

from ...apis.cluster import CLUSTERS
from ...apis.scheme import GVR
from ...client import Client, Informer
from ...fleet.inventory import ClusterInventory
from ...ops.encode import pad_pow2
from ...ops.placement import aggregate_status
from ...reconciler.controller import BatchController
from ...utils import errors
from ...utils.device import resolve_device
from ...utils.trace import REGISTRY

log = logging.getLogger(__name__)

CLUSTER_LABEL = "kcp.dev/cluster"
OWNED_BY_LABEL = "kcp.dev/owned-by"

DEPLOYMENTS = GVR("apps", "v1", "deployments")

_COUNTERS = ("replicas", "updatedReplicas", "readyReplicas",
             "availableReplicas", "unavailableReplicas")

# health-gated evacuation: a cluster must hold NotReady for this long
# before its leaf deployments drain — a Ready->NotReady->Ready flap
# inside the window causes ZERO placement churn (hysteresis)
DEFAULT_EVAC_HYSTERESIS = 5.0


def _labels(obj: dict) -> dict:
    return (obj.get("metadata") or {}).get("labels") or {}


def is_root(obj: dict) -> bool:
    return not _labels(obj).get(CLUSTER_LABEL)


def leaf_name(root_name: str, cluster_name: str) -> str:
    return f"{root_name}--{cluster_name}"


class DeploymentSplitter:
    """Batched root-splitting + status fan-in over all logical clusters."""

    def __init__(
        self,
        client: Client,
        backend: str = "fused",
        rebalance: bool = False,
        max_pclusters: int = 8,
        core=None,
        evac_hysteresis: float = DEFAULT_EVAC_HYSTERESIS,
        place: bool = True,
        inventory: ClusterInventory | None = None,
        device=None,
        mesh=None,
    ):
        if backend not in ("fused", "host"):
            raise ValueError(f"backend must be 'fused' or 'host', got {backend!r}")
        self.client = client
        self.backend = backend
        self.fused = backend == "fused"
        # the fused lane's device (the CUDA card unless the caller names
        # the CPU; on a mesh, its lead) and the mesh of the core it joins
        self.mesh = mesh
        self.device = resolve_device(device, mesh) if self.fused else None
        self.core = core  # FusedCore (fused backend; lazily bound at start)
        self._pbucket = None
        self.rebalance = rebalance
        self.max_pclusters = max_pclusters
        # health-gated evacuation now lives in the shared fleet inventory
        # (fleet/inventory.py): Ready flips arm its hysteresis FSM, and
        # the same instance feeds the FleetScheduler when one is driving.
        # `place=False` hands the placement *decision* to that scheduler
        # while this controller keeps informers, status fan-in and drains.
        self.evac_hysteresis = evac_hysteresis
        self.inventory = (inventory if inventory is not None
                          else ClusterInventory(evac_hysteresis=evac_hysteresis))
        self.place = place
        self.replan_sink = None  # FleetScheduler's evac/readmit intake
        self._force_replan: set[tuple[str, str, str]] = set()
        self.informer = Informer(client, DEPLOYMENTS)
        self.cluster_informer = Informer(client, CLUSTERS)
        self.informer.add_indexer("owned_by", self._owned_by_index)
        self.informer.add_indexer("by_workspace", self._by_workspace_index)
        self.controller = BatchController(
            "deployment-splitter", self._process_batch,
            # item = ("root"|"leaf", (clusterName, ns, name)): fairness is
            # per logical cluster
            tenant_of=lambda item: item[1][0],
        )
        self.informer.add_handler(self._on_event)
        self.cluster_informer.add_handler(self._on_cluster_event)
        # fused bookkeeping: staged cluster-count per root (stale-apply
        # detection) and device counts awaiting a successful apply
        self._staged_n: dict[tuple[str, str, str], int] = {}
        self._retry_counts: dict[tuple[str, str, str], np.ndarray] = {}
        # applier pool: placement_apply is called from the core's tick
        # loop and must not block it (the SectionOwner contract)
        self._apply_q: "asyncio.Queue | None" = None
        self._apply_tasks: list = []
        # fused_placements: roots placed from device counts;
        # host_placements: roots placed by a host split (the host lane,
        # and zero-replica roots on the fused lane)
        self.stats = {"ticks": 0, "splits": 0, "aggregations": 0,
                      "fused_placements": 0, "host_placements": 0}

    @staticmethod
    def _owned_by_index(obj: dict) -> list[str]:
        owner = _labels(obj).get(OWNED_BY_LABEL)
        m = obj["metadata"]
        if not owner:
            return []
        return [f'{m.get("clusterName", "")}/{m.get("namespace", "")}/{owner}']

    @staticmethod
    def _by_workspace_index(obj: dict) -> list[str]:
        """Roots keyed by logical cluster — replans look up ONE workspace
        instead of scanning every object of every tenant."""
        if not is_root(obj):
            return []
        return [obj["metadata"].get("clusterName", "")]

    @property
    def _evacuated(self) -> frozenset:
        """(workspace, cluster) pairs currently evacuated (a read-only
        view over the shared inventory; kept for tests/introspection)."""
        return self.inventory.evacuated_pairs

    # ------------------------------------------------------------ events

    def _on_event(self, etype: str, old: dict | None, new: dict | None) -> None:
        obj = new or old
        m = obj["metadata"]
        key = (m.get("clusterName", ""), m.get("namespace", ""), m["name"])
        if is_root(obj):
            self.controller.enqueue(("root", key))
        else:
            owner = _labels(obj).get(OWNED_BY_LABEL)
            root_key = (m.get("clusterName", ""), m.get("namespace", ""), owner)
            self.controller.enqueue(("leaf", root_key))

    def _on_cluster_event(self, etype: str, old: dict | None, new: dict | None) -> None:
        obj = new or old
        lc = obj["metadata"].get("clusterName", "")
        name = obj["metadata"]["name"]
        ckey = (lc, name)
        # health gate: the cluster reconciler's Ready flips feed the
        # shared fleet inventory's hysteresis FSM. NotReady arms the
        # clock (a delayed "health" item decides); Ready inside the
        # window disarms it with ZERO churn; Ready after evacuation
        # readmits the cluster and re-splits its workspace's roots
        d = self.inventory.observe(lc, obj, etype)
        if d.notready_started:
            self.controller.enqueue_after(
                ("health", ckey), self.evac_hysteresis)
        if d.readmitted:
            log.info("deployment-splitter: cluster %s/%s Ready again; "
                     "readmitting and re-splitting its roots", lc, name)
            self._replan_roots(lc)
        # the cluster set changed: with rebalancing on, every root in that
        # logical cluster gets re-planned (indexed — no fleet-wide scan)
        if not self.rebalance:
            return
        for obj in self.informer.index("by_workspace", lc):
            m = obj["metadata"]
            self.controller.enqueue(
                ("root", (lc, m.get("namespace", ""), m["name"]))
            )

    # --------------------------------------------- health-gated evacuation

    def _replan_roots(self, lc: str) -> None:
        """Force every root in a logical cluster through a fresh split
        (drain or readmit must move replicas even without `rebalance`).
        Routed through the by_workspace index — a Ready flip touches ONE
        workspace's roots, never a fleet-wide rescan. With the placement
        decision delegated (`place=False`) the keys flow to the fleet
        scheduler's sink instead."""
        rkeys = []
        for obj in self.informer.index("by_workspace", lc):
            m = obj["metadata"]
            rkeys.append((lc, m.get("namespace", ""), m["name"]))
        if not self.place:
            if self.replan_sink is not None:
                self.replan_sink(lc, rkeys)
            return
        for rkey in rkeys:
            self._force_replan.add(rkey)
            self.controller.enqueue(("root", rkey))

    def _check_health(self, ckey: tuple[str, str]) -> None:
        """The delayed hysteresis decision: evacuate only if the cluster
        is STILL explicitly NotReady a full window after the flip (the
        inventory re-checks its event-fed state and bumps its version
        only on the pending->evacuated transition)."""
        lc, name = ckey
        if self.inventory.check_evacuate(lc, name):
            log.warning("deployment-splitter: evacuating cluster %s/%s "
                        "after sustained NotReady (> %.1fs)", lc, name,
                        self.evac_hysteresis)
            self._replan_roots(lc)

    # -------------------------------------------------------------- tick

    async def _process_batch(self, items: Sequence) -> list[tuple[object, Exception]]:
        self.stats["ticks"] += 1
        roots: dict[tuple[str, str, str], None] = {}
        aggregates: dict[tuple[str, str, str], None] = {}
        for kind, key in items:
            if kind == "health":
                self._check_health(key)
            elif kind == "root":
                if self.place:  # else the FleetScheduler decides
                    roots[key] = None
            else:
                aggregates[key] = None

        failed: list[tuple[object, Exception]] = []
        failed_keys = set()

        # ---- placement lane
        plan_rows = []
        for key in roots:
            root = self.informer.cache.get(key)
            if root is None or not is_root(root):
                if self.fused and self._pbucket is not None:
                    # root gone: retire its placement row
                    self._pbucket.free_pl_row(key)
                    self._staged_n.pop(key, None)
                    self._retry_counts.pop(key, None)
                continue
            leafs = self.informer.index("owned_by", "/".join(key))
            if leafs and not self.rebalance and key not in self._force_replan:
                continue  # reference behavior: only split once
            clusters = self._clusters_for(key[0])
            plan_rows.append((key, root, clusters, leafs))

        if plan_rows and self.fused and self._pbucket is not None:
            # SERVED path: roots ride the FusedCore's placement lanes —
            # the same fused step that serves the sync sections computes
            # the split, and dirty rows come back via placement_apply.
            # Under fleet dispatch (KCP_FLEET_BATCH, the default) the
            # kick wakes the whole-fleet ragged batch: placement rows
            # from every bucket concatenate into ONE device program's
            # placement lanes, and the FleetBatch scatters the dirty
            # roots back to this bucket's placement_apply on collect —
            # so ONE kick per drained batch stays the right granularity
            kicked = False
            for key, root, clusters, leafs in plan_rows:
                if not clusters:
                    # NoRegisteredClusters is pure host-side status
                    try:
                        self._apply_placement(key, root, clusters, leafs, None)
                    except Exception as err:  # noqa: BLE001
                        failed_keys.add(("root", key))
                        failed.append((("root", key), err))
                    continue
                retry = self._retry_counts.pop(key, None)
                if (retry is not None
                        and len(clusters) == self._staged_n.get(key)
                        and not self._counts_stale(root, retry)):
                    # a device-computed split failed to apply earlier;
                    # re-apply from the cached counts (re-staging the
                    # same inputs would not re-dirty the device row).
                    # Stale cache (spec changed since) falls through to
                    # a fresh staging instead.
                    try:
                        self._apply_placement(key, root, clusters, leafs, retry)
                    except Exception as err:  # noqa: BLE001
                        self._retry_counts[key] = retry
                        failed_keys.add(("root", key))
                        failed.append((("root", key), err))
                    continue
                replicas = int(root.get("spec", {}).get("replicas", 0) or 0)
                self._pbucket.stage_placement(key, replicas, len(clusters))
                self._staged_n[key] = len(clusters)
                kicked = True
                if replicas == 0:
                    # the all-zero split equals a fresh row's resident
                    # `current`, so the device never reports it dirty:
                    # apply it here (staged all the same, so the row's
                    # `current` follows the root)
                    try:
                        self._apply_placement(key, root, clusters, leafs,
                                              np.zeros(len(clusters), np.int32))
                        self.stats["host_placements"] += 1
                    except Exception as err:  # noqa: BLE001
                        failed_keys.add(("root", key))
                        failed.append((("root", key), err))
            if kicked:
                self.core.kick(self._pbucket)
        elif plan_rows:
            reps = np.array(
                [r[1].get("spec", {}).get("replicas", 0) or 0 for r in plan_rows],
                dtype=np.int32,
            )
            # width follows the widest row (padded pow2 for shape stability);
            # max_pclusters is only the padding floor, never a silent cap
            width = pad_pow2(
                max((len(r[2]) for r in plan_rows), default=1), floor=self.max_pclusters
            )
            avail = np.zeros((len(plan_rows), width), dtype=bool)
            for i, (_, _, clusters, _) in enumerate(plan_rows):
                avail[i, : len(clusters)] = True
            leaf_counts = self._host_split(reps, avail)
            for i, (key, root, clusters, leafs) in enumerate(plan_rows):
                try:
                    self._apply_placement(key, root, clusters, leafs, leaf_counts[i])
                    self.stats["host_placements"] += 1
                except Exception as err:  # noqa: BLE001
                    failed_keys.add(("root", key))
                    failed.append((("root", key), err))

        # ---- aggregation lane: batch all status fan-ins
        agg_rows = []
        for key in aggregates:
            root = self.informer.cache.get(key)
            if root is None:
                continue
            leafs = self.informer.index("owned_by", "/".join(key))
            if leafs:
                agg_rows.append((key, root, leafs))
        if agg_rows:
            width = pad_pow2(
                max((len(r[2]) for r in agg_rows), default=1), floor=self.max_pclusters
            )
            counters = np.zeros((len(agg_rows), width, len(_COUNTERS)), np.int32)
            mask = np.zeros((len(agg_rows), width), bool)
            for i, (_, _, leafs) in enumerate(agg_rows):
                for j, leaf in enumerate(leafs):
                    st = leaf.get("status") or {}
                    mask[i, j] = True
                    for c, field in enumerate(_COUNTERS):
                        counters[i, j, c] = st.get(field, 0) or 0
            if self.fused:
                sums = aggregate_status(
                    torch.from_numpy(counters).to(self.device),
                    torch.from_numpy(mask).to(self.device)).cpu().numpy()
            else:
                sums = (counters * mask[..., None]).sum(axis=1)
            for i, (key, root, leafs) in enumerate(agg_rows):
                try:
                    self._apply_aggregation(key, root, leafs, sums[i])
                except errors.ConflictError as err:
                    # conflicts requeue (deployment.go:93-103)
                    failed_keys.add(("leaf", key))
                    failed.append((("leaf", key), err))
                except Exception as err:  # noqa: BLE001
                    failed_keys.add(("leaf", key))
                    failed.append((("leaf", key), err))
        return failed

    # ------------------------------------------------- fused-core seam

    def placement_apply(self, applies: list[tuple[tuple[str, str, str], np.ndarray]]) -> None:
        """Dirty placement rows from a collected fused tick: hand off to
        the applier pool — this runs on the core's tick loop and must not
        block it (the SectionOwner contract, syncer/core.py)."""
        for entry in applies:
            self._apply_q.put_nowait(entry)

    def _counts_stale(self, root: dict, counts: np.ndarray) -> bool:
        """Device counts are provably for THESE inputs only when their
        sum equals the root's current replicas (the split preserves the
        sum). A mismatch means the row was re-used or the spec changed
        while the wire was in flight — restage, never apply."""
        want = int(root.get("spec", {}).get("replicas", 0) or 0)
        return int(np.sum(counts)) != want

    async def _apply_worker(self) -> None:
        while True:
            key, counts = await self._apply_q.get()
            try:
                self._apply_one_fused(key, counts)
            except Exception:  # noqa: BLE001 — worker must survive
                log.exception("deployment-splitter: fused apply crashed")
            finally:
                self._apply_q.task_done()

    def _apply_one_fused(self, key, counts: np.ndarray) -> None:
        root = self.informer.cache.get(key)
        if root is None or not is_root(root):
            return
        clusters = self._clusters_for(key[0])
        if len(clusters) != self._staged_n.get(key) or self._counts_stale(root, counts):
            # the cluster set / spec / row assignment changed while the
            # tick was in flight: restage with current inputs instead of
            # applying stale counts. The device's `current` has already
            # advanced past the rejected split, so force the placement
            # rows to re-emit — identical re-staged inputs would never
            # re-dirty otherwise
            if self._pbucket is not None:
                self._pbucket.invalidate_placement()
            self.controller.enqueue(("root", key))
            return
        leafs = self.informer.index("owned_by", "/".join(key))
        if leafs and not self.rebalance and key not in self._force_replan:
            return
        try:
            self._apply_placement(key, root, clusters, leafs, counts)
            self.stats["fused_placements"] += 1
        except Exception as err:  # noqa: BLE001
            log.info("deployment-splitter: fused placement apply for %r "
                     "failed (%s); requeued", key, err)
            self._retry_counts[key] = np.asarray(counts)
            self.controller.queue.add_rate_limited(("root", key))

    @staticmethod
    def _host_split(reps: np.ndarray, avail: np.ndarray) -> np.ndarray:
        out = np.zeros_like(avail, dtype=np.int32)
        for i in range(len(reps)):
            idxs = np.nonzero(avail[i])[0]
            if len(idxs) == 0:
                continue
            base, rem = divmod(int(reps[i]), len(idxs))
            for rank, j in enumerate(idxs):
                out[i, j] = base + (rem if rank == 0 else 0)
        return out

    # ------------------------------------------------------------- apply

    def _clusters_for(self, logical_cluster: str) -> list[dict]:
        """Placement-eligible clusters: evacuated (sustained-NotReady)
        clusters are excluded, so every split — host or fused lane —
        routes replicas only onto healthy capacity."""
        return sorted(
            (c for c in self.cluster_informer.list()
             if c["metadata"].get("clusterName", "") == logical_cluster
             and not self.inventory.is_evacuated(
                 logical_cluster, c["metadata"]["name"])),
            key=lambda c: c["metadata"]["name"],
        )

    def _apply_placement(
        self,
        key: tuple[str, str, str],
        root: dict,
        clusters: list[dict],
        existing_leafs: list[dict],
        counts: np.ndarray,
    ) -> None:
        lc, ns, name = key
        # forced replans (evacuation drain / readmission) move replicas
        # between existing leafs even when `rebalance` is off
        forced = key in self._force_replan
        scoped = self.client.scoped(lc)
        # churn = replica-moving writes AFTER initial placement (updates,
        # drains, late creates on readmission) — the bounded-migration
        # number the fleet scenarios assert on. Initial splits are free.
        had_leafs = bool(existing_leafs)
        churn = 0
        REGISTRY.counter(
            "placement_resolves_total",
            "root placements solved and applied (initial or re-solve)").inc()
        if not clusters:
            if forced:
                # every cluster is evacuated: drain ALL placed leafs
                for stale in existing_leafs:
                    churn += self._drain_leaf(scoped, lc, ns, stale)
            fresh = scoped.get(DEPLOYMENTS, name, ns)
            conds = [{
                "type": "Progressing",
                "status": "False",
                "reason": "NoRegisteredClusters",
                "message": "kcp has no clusters registered to receive Deployments",
            }]
            # idempotent: a re-applied no-candidate placement must not
            # rewrite identical status — the write bumps the root's RV,
            # which re-enqueues the root and re-solves it forever
            if (fresh.get("status") or {}).get("conditions") != conds:
                fresh.setdefault("status", {})["conditions"] = conds
                scoped.update_status(DEPLOYMENTS, fresh, namespace=ns)
            self._force_replan.discard(key)
            self._count_churn(churn)
            return
        by_name = {leaf["metadata"]["name"]: leaf for leaf in existing_leafs}
        for j, cl in enumerate(clusters):
            cl_name = cl["metadata"]["name"]
            lname = leaf_name(name, cl_name)
            desired_replicas = int(counts[j])
            existing = by_name.pop(lname, None)
            if existing is None:
                leaf = copy.deepcopy(root)
                m = leaf["metadata"]
                m["name"] = lname
                for f in ("resourceVersion", "uid", "creationTimestamp", "generation"):
                    m.pop(f, None)
                labels = m.setdefault("labels", {})
                labels[CLUSTER_LABEL] = cl_name
                labels[OWNED_BY_LABEL] = name
                m["ownerReferences"] = [{
                    "apiVersion": "apps/v1",
                    "kind": "Deployment",
                    "uid": root["metadata"].get("uid"),
                    "name": name,
                }]
                leaf.pop("status", None)
                leaf.setdefault("spec", {})["replicas"] = desired_replicas
                scoped.create(DEPLOYMENTS, leaf, namespace=ns)
                self.stats["splits"] += 1
                if had_leafs:
                    churn += 1
            elif ((self.rebalance or forced)
                  and existing.get("spec", {}).get("replicas") != desired_replicas):
                fresh = scoped.get(DEPLOYMENTS, lname, ns)
                fresh["spec"]["replicas"] = desired_replicas
                scoped.update(DEPLOYMENTS, fresh, namespace=ns)
                self.stats["splits"] += 1
                churn += 1
        # rebalance/forced: drop leafs for clusters that no longer exist
        # or were evacuated
        if self.rebalance or forced:
            for stale in by_name.values():
                churn += self._drain_leaf(scoped, lc, ns, stale)
        self._force_replan.discard(key)
        self._count_churn(churn)

    @staticmethod
    def _count_churn(churn: int) -> None:
        if churn:
            REGISTRY.counter(
                "placement_churn_total",
                "replica-moving leaf writes after initial placement "
                "(updates, drains, readmission creates)").inc(churn)

    def _drain_leaf(self, scoped: Client, lc: str, ns: str, leaf: dict) -> int:
        try:
            scoped.delete(DEPLOYMENTS, leaf["metadata"]["name"], ns)
        except errors.NotFoundError:
            return 0
        if self.inventory.is_evacuated(lc, _labels(leaf).get(CLUSTER_LABEL, "")):
            REGISTRY.counter(
                "evacuations_total",
                "leaf deployments drained off evacuated "
                "(sustained-NotReady) clusters").inc()
        return 1

    def _apply_aggregation(
        self, key: tuple[str, str, str], root: dict, leafs: list[dict], sums: np.ndarray
    ) -> None:
        lc, ns, name = key
        scoped = self.client.scoped(lc)
        fresh = scoped.get(DEPLOYMENTS, name, ns)
        status = fresh.setdefault("status", {})
        changed = False
        for c, field in enumerate(_COUNTERS):
            if status.get(field, 0) != int(sums[c]):
                status[field] = int(sums[c])
                changed = True
        leaf_conds = (leafs[0].get("status") or {}).get("conditions")
        if leaf_conds and status.get("conditions") != leaf_conds:
            # reference "cheat": root conditions := first leaf's
            status["conditions"] = copy.deepcopy(leaf_conds)
            changed = True
        if changed:
            scoped.update_status(DEPLOYMENTS, fresh, namespace=ns)
            self.stats["aggregations"] += 1

    # ---------------------------------------------------------- lifecycle

    async def start(self) -> None:
        import asyncio

        if self.fused and self.place:
            if self.core is None:
                from ...syncer.core import FusedCore

                self.core = FusedCore.for_current_loop(
                    mesh=self.mesh, device=self.device)
            self._pbucket = self.core.register_placement(
                self, p=self.max_pclusters)
            self._apply_q = asyncio.Queue()
            for _ in range(2):
                self._apply_tasks.append(
                    asyncio.create_task(self._apply_worker()))
            await self.core.start()
        await self.cluster_informer.start()
        await self.informer.start()
        await self.controller.start()

    async def stop(self) -> None:
        import asyncio

        await self.controller.stop()
        if self.fused and self.place and self.core is not None:
            await self.core.stop()
            # the core's shutdown drain may have enqueued final applies
            if self._apply_q is not None:
                try:
                    await asyncio.wait_for(self._apply_q.join(), timeout=5.0)
                except asyncio.TimeoutError:
                    log.warning("deployment-splitter: applier queue not "
                                "drained at stop")
            for t in self._apply_tasks:
                t.cancel()
            for t in self._apply_tasks:
                try:
                    await t
                except asyncio.CancelledError:
                    pass
            self._apply_tasks.clear()
            if self._pbucket is not None:
                for key in list(self._pbucket.pl_rows):
                    self._pbucket.free_pl_row(key)
                if self._pbucket.placement_owner is self:
                    self._pbucket.placement_owner = None
                self._pbucket = None
        await self.informer.stop()
        await self.cluster_informer.stop()
