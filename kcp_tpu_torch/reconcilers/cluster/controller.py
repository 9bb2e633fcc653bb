"""Cluster controller: connect physical clusters to the control plane.

Behavioral parity with the reference (pkg/reconciler/cluster/
{controller,cluster}.go):

- a ``Cluster`` CR names a physical cluster via ``spec.kubeconfig``;
  invalid kubeconfigs set Ready=False and deliberately do NOT retry
  (cluster.go:32-47 "return nil // Don't retry")
- per cluster, an :class:`APIImporter` polls the physical cluster's
  schemas into APIResourceImport objects (cluster.go:49-59)
- the synced resource set = imports with Compatible AND Available
  conditions (via the location index) plus built-in control-plane
  resources that intersect resources_to_sync (cluster.go:61-92)
- when the set changes, the syncer is (re)started: push mode runs
  :class:`kcp_tpu_torch.syncer.Syncer` in-process on the controller's
  device (and mesh), every push syncer's engines sharing the loop's one
  ``FusedCore``; pull mode installs the syncer workload into the physical
  cluster (cluster.go:94-165)
- pull mode health is re-checked every reconcile; failure flips Ready
  (cluster.go:175-194)
- the cluster re-reconciles itself every poll interval (cluster.go:196-202)
- deletion stops the importer and syncer and uninstalls (cluster.go:206-239)
"""

from __future__ import annotations

import asyncio
import logging
from enum import Enum

from ...apis import apiresource as ar
from ...apis import cluster as clusterapi
from ...client import Client, Informer
from ...reconciler.controller import Controller
from ...syncer import Syncer
from ...utils import errors
from ...utils.device import resolve_device
from ..cluster.apiimporter import APIImporter
from . import installer
from .installer import DEFAULT_SYNCER_IMAGE

log = logging.getLogger(__name__)


class SyncerMode(Enum):
    PUSH = "push"
    PULL = "pull"
    NONE = "none"


DEFAULT_POLL_INTERVAL = 60.0  # reference: cluster.go:22


class ClusterController:
    def __init__(
        self,
        client: Client,  # wildcard multi-cluster client to the control plane
        registry,  # PhysicalRegistry
        resources_to_sync: list[str] | None = None,
        mode: SyncerMode = SyncerMode.PUSH,
        backend: str = "fused",
        poll_interval: float = DEFAULT_POLL_INTERVAL,
        import_poll_interval: float | None = None,
        kcp_kubeconfig: str = "",
        syncer_image: str = DEFAULT_SYNCER_IMAGE,
        mesh=None,
        mesh_spec: str = "",
        device=None,
    ):
        if backend not in ("fused", "host"):
            raise ValueError(f"backend must be 'fused' or 'host', got {backend!r}")
        self.client = client
        self.registry = registry
        self.resources_to_sync = resources_to_sync or ["deployments.apps"]
        self.mode = mode
        self.backend = backend
        self.mesh = mesh  # sharding for push-mode syncers' fused core
        # the push syncers' device: the CUDA card unless the caller names
        # the CPU; on a mesh, the mesh's lead device
        self.device = (resolve_device(device, mesh)
                       if mode == SyncerMode.PUSH and backend == "fused" else None)
        # pull mode ships the sharding as a CLI spec in the pod manifest
        # (a live Mesh object cannot cross the process boundary)
        self.mesh_spec = mesh_spec
        self.poll_interval = poll_interval
        self.import_poll_interval = (
            import_poll_interval if import_poll_interval is not None else poll_interval
        )
        self.kcp_kubeconfig = kcp_kubeconfig
        self.syncer_image = syncer_image

        self.informer = Informer(client, clusterapi.CLUSTERS)
        self.import_informer = Informer(client, ar.APIRESOURCEIMPORTS)
        # LocationInLogicalCluster index (reference controller.go:134-149)
        self.import_informer.add_indexer(
            "location",
            lambda o: [f'{o["metadata"].get("clusterName", "")}/{o["spec"].get("location", "")}'],
        )
        self.controller = Controller("cluster", self._process)
        self.informer.add_handler(self._on_event)
        self.import_informer.add_handler(self._on_import_event)

        self.importers: dict[tuple[str, str], APIImporter] = {}
        self.syncers: dict[tuple[str, str], Syncer] = {}
        self._deleted: dict[tuple[str, str], dict] = {}

    # ------------------------------------------------------------ events

    def _on_event(self, etype: str, old: dict | None, new: dict | None) -> None:
        obj = new or old
        key = (obj["metadata"].get("clusterName", ""), obj["metadata"]["name"])
        if etype == "DELETED":
            self._deleted[key] = obj
        self.controller.enqueue(key)

    def _on_import_event(self, etype: str, old: dict | None, new: dict | None) -> None:
        # condition changes on imports re-trigger their cluster
        obj = new or old
        lc = obj["metadata"].get("clusterName", "")
        location = obj.get("spec", {}).get("location", "")
        if location:
            self.controller.enqueue((lc, location))

    # ----------------------------------------------------------- process

    async def _process(self, key) -> None:
        lc, name = key
        cluster = self.informer.get(lc, name)
        if cluster is None:
            await self._cleanup(key)
            return
        await self._reconcile(key, cluster)

    async def _reconcile(self, key, cluster: dict) -> None:
        lc, name = key
        scoped = self.client.scoped(lc)

        # 1. resolve the physical cluster (invalid => Ready=False, no retry)
        kubeconfig = cluster.get("spec", {}).get("kubeconfig", "")
        try:
            physical = self.registry.resolve(kubeconfig)
        except ValueError as err:
            self._set_status(scoped, cluster, ready=False,
                             reason=clusterapi.REASON_INVALID_KUBECONFIG, message=str(err))
            return  # don't retry (cluster.go:38)

        # 2. one importer per cluster (cluster.go:49-59)
        if key not in self.importers:
            imp = APIImporter(
                scoped, physical, name, self.resources_to_sync,
                poll_interval=self.import_poll_interval,
            )
            imp.start()
            self.importers[key] = imp

        # 3. synced resources = compatible∧available imports + builtins
        #    (cluster.go:61-92)
        ready_imports = [
            o for o in self.import_informer.index("location", f"{lc}/{name}")
            if ar.is_compatible_and_available(o)
        ]
        synced = {str(ar.gvr_of(o)) for o in ready_imports}
        builtin = {i.gvr.storage_name for i in self.client.scheme.all()}
        from ...apis.scheme import GVR
        synced |= {GVR.parse(r).storage_name for r in self.resources_to_sync
                   if GVR.parse(r).storage_name in builtin}

        # compare with the stored Cluster, not the informer's copy: that
        # can predate the status this controller wrote in its previous
        # reconcile (the event not delivered yet), and would restart the
        # syncer it just started
        try:
            cluster = scoped.get(clusterapi.CLUSTERS, name)
        except errors.NotFoundError:
            return  # deleted meanwhile: its DELETED event tears down
        if sorted(synced) != clusterapi.synced_resources(cluster):
            await self._restart_syncer(key, cluster, scoped, physical, sorted(synced))
            cluster = scoped.get(clusterapi.CLUSTERS, name)

        # 4. pull-mode health check (cluster.go:175-194). `cluster.health`
        #    is a KCP_FAULTS injection point: an injected error reads as
        #    an unhealthy syncer, so chaos schedules can flap a cluster's
        #    Ready condition deterministically (the flip feeds the
        #    deployment splitter's health-gated evacuation)
        if self.mode == SyncerMode.PULL and clusterapi.synced_resources(cluster):
            healthy, msg = installer.healthcheck_syncer(physical)
            try:
                from ... import faults

                faults.maybe_fail("cluster.health")
            except Exception as err:  # noqa: BLE001 — injected unhealth
                healthy, msg = False, f"injected fault: {err}"
            if not healthy:
                self._set_status(scoped, cluster, ready=False,
                                 reason=clusterapi.REASON_SYNCER_NOT_READY, message=msg)
            else:
                self._set_status(scoped, cluster, ready=True)

        # 5. periodic self-requeue (cluster.go:196-202)
        self.controller.enqueue_after(key, self.poll_interval)

    async def _restart_syncer(
        self, key, cluster: dict, scoped: Client, physical: Client, synced: list[str]
    ) -> None:
        lc, name = key
        old = self.syncers.pop(key, None)
        if old is not None:
            await old.stop()
        if not synced:
            self._set_status(scoped, cluster, ready=True, synced=synced)
            return
        if self.mode == SyncerMode.PUSH:
            try:
                syncer = Syncer(scoped, physical, synced, name,
                                backend=self.backend, mesh=self.mesh,
                                device=self.device)
                await syncer.start()
                self.syncers[key] = syncer
            except Exception as err:  # noqa: BLE001
                self._set_status(scoped, cluster, ready=False,
                                 reason=clusterapi.REASON_ERROR_STARTING_SYNCER,
                                 message=str(err))
                raise
            self._set_status(scoped, cluster, ready=True, synced=synced)
        elif self.mode == SyncerMode.PULL:
            try:
                installer.install_syncer(
                    physical, name, self.kcp_kubeconfig, synced,
                    self.syncer_image, mesh_spec=self.mesh_spec,
                )
            except Exception as err:  # noqa: BLE001
                self._set_status(scoped, cluster, ready=False,
                                 reason=clusterapi.REASON_ERROR_INSTALLING_SYNCER,
                                 message=str(err))
                raise
            self._set_status(scoped, cluster, ready=None, synced=synced)
        else:  # SyncerMode.NONE: mark ready without syncing (cluster.go:166-171)
            self._set_status(scoped, cluster, ready=True, synced=synced)

    def _set_status(
        self, scoped: Client, cluster: dict, ready: bool | None,
        reason: str = "", message: str = "", synced: list[str] | None = None,
    ) -> None:
        name = cluster["metadata"]["name"]
        fresh = scoped.get(clusterapi.CLUSTERS, name)
        if synced is not None:
            clusterapi.set_synced_resources(fresh, synced)
        was_ready = clusterapi.is_ready(fresh)
        if ready is True:
            clusterapi.set_ready(fresh, reason, message)
        elif ready is False:
            clusterapi.set_not_ready(fresh, reason, message)
        if ready is not None and ready != was_ready:
            # flip telemetry: the evacuation runbook's flap-rate signal
            from ...utils.trace import REGISTRY

            REGISTRY.counter(
                "cluster_ready_transitions_total",
                "Ready condition flips written by the cluster reconciler",
            ).inc()
        try:
            scoped.update_status(clusterapi.CLUSTERS, fresh)
        except errors.ConflictError:
            self.controller.enqueue((cluster["metadata"].get("clusterName", ""), name))

    async def _cleanup(self, key) -> None:
        """Deletion teardown (cluster.go:206-239)."""
        imp = self.importers.pop(key, None)
        if imp is not None:
            imp.stop()
        syncer = self.syncers.pop(key, None)
        if syncer is not None:
            await syncer.stop()
        if self.mode == SyncerMode.PULL:
            deleted = self._deleted.pop(key, None)
            if deleted is not None:
                try:
                    physical = self.registry.resolve(
                        deleted.get("spec", {}).get("kubeconfig", "")
                    )
                    installer.uninstall_syncer(physical)
                except ValueError:
                    pass
        self._deleted.pop(key, None)

    # ---------------------------------------------------------- lifecycle

    async def start(self, num_workers: int = 2) -> None:
        await self.informer.start()
        await self.import_informer.start()
        await self.controller.start(num_workers)

    async def stop(self) -> None:
        await self.controller.stop()
        for imp in self.importers.values():
            imp.stop()
        await asyncio.gather(*(s.stop() for s in self.syncers.values()))
        self.importers.clear()
        self.syncers.clear()
        await self.informer.stop()
        await self.import_informer.stop()
