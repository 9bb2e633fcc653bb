"""APIImporter: periodic schema import from a physical cluster.

Behavioral parity with the reference's per-cluster import loop
(pkg/reconciler/cluster/apiimporter.go:29-207): every ``poll_interval``
the puller re-reads the physical cluster's view of the resources to sync
and reconciles ``APIResourceImport`` objects in the logical cluster —
create on first sight, update when the pulled schema changed, delete when
the physical cluster stops serving the resource.
"""

from __future__ import annotations

import asyncio
import logging

from ...apis import apiresource as ar
from ...apis import crd as crdapi
from ...client import Client
from ...crdpuller import SchemaPuller
from ...utils import errors

log = logging.getLogger(__name__)

DEFAULT_POLL_INTERVAL = 60.0  # reference: apiimporter.go:37


class APIImporter:
    def __init__(
        self,
        kcp: Client,  # scoped to the logical cluster
        physical: Client,
        location: str,  # Cluster object name
        resources_to_sync: list[str],
        poll_interval: float = DEFAULT_POLL_INTERVAL,
    ):
        self.kcp = kcp
        self.puller = SchemaPuller(physical)
        self.location = location
        self.resources_to_sync = list(resources_to_sync)
        self.poll_interval = poll_interval
        self._task: asyncio.Task | None = None
        self.done_event = asyncio.Event()  # set after each import pass

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._loop())

    async def _loop(self) -> None:
        while True:
            try:
                self.import_apis()
            except Exception:  # noqa: BLE001 — import is retried next tick
                log.exception("api import for %s failed", self.location)
            self.done_event.set()
            await asyncio.sleep(self.poll_interval)

    def import_apis(self) -> None:
        """One import pass (reference: ImportAPIs, apiimporter.go:77-207)."""
        pulled = self.puller.pull_crds(self.resources_to_sync)
        for resource, crd in pulled.items():
            if crd is None:
                self._delete_import_if_exists(resource)
                continue
            for version in crd["spec"].get("versions", []):
                spec = ar.common_spec(
                    group=crd["spec"]["group"],
                    version=version["name"],
                    plural=crd["spec"]["names"]["plural"],
                    kind=crd["spec"]["names"]["kind"],
                    scope=crd["spec"].get("scope", "Namespaced"),
                    schema=(version.get("schema") or {}).get("openAPIV3Schema"),
                    sub_resources=(
                        ["status"] if "status" in (version.get("subresources") or {}) else []
                    ),
                )
                obj = ar.new_api_resource_import(self.location, spec)
                name = obj["metadata"]["name"]
                try:
                    existing = self.kcp.get(ar.APIRESOURCEIMPORTS, name)
                except errors.NotFoundError:
                    self.kcp.create(ar.APIRESOURCEIMPORTS, obj)
                    log.info("created APIResourceImport %s", name)
                    continue
                if existing["spec"].get("openAPIV3Schema") != spec["openAPIV3Schema"]:
                    existing["spec"]["openAPIV3Schema"] = spec["openAPIV3Schema"]
                    self.kcp.update(ar.APIRESOURCEIMPORTS, existing)
                    log.info("updated APIResourceImport %s", name)

    def _delete_import_if_exists(self, resource: str) -> None:
        """Delete every import this location holds for the resource.

        Deletion goes by listing actual imports (matching location +
        plural + group), not by reconstructing names: the pulled CRD may
        have served any version(s), so a name rebuilt from the requested
        resource string would miss non-default-version imports.
        """
        from ...apis.scheme import GVR

        gvr = GVR.parse(resource)
        items, _ = self.kcp.list(ar.APIRESOURCEIMPORTS)
        for obj in items:
            spec = obj.get("spec", {})
            gv = spec.get("groupVersion", {})
            if (spec.get("location") == self.location
                    and spec.get("plural") == gvr.resource
                    and gv.get("group", "") == gvr.group):
                try:
                    self.kcp.delete(ar.APIRESOURCEIMPORTS, obj["metadata"]["name"])
                    log.info("deleted APIResourceImport %s (resource gone)",
                             obj["metadata"]["name"])
                except errors.NotFoundError:
                    pass

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None


__all__ = ["APIImporter", "DEFAULT_POLL_INTERVAL", "crdapi"]
