"""Clients: cluster-scoped and multi-cluster dynamic access to a store.

The analog of the reference's generated clientsets + dynamic client
(pkg/client/**) plus the fork's multi-cluster routing
(``clientutils.EnableMultiCluster``, reference: pkg/server/server.go:230):
a wildcard client reads/watches across all logical clusters and routes
writes to the logical cluster named in ``metadata.clusterName``.

One dynamic client serves all types — the framework is unstructured
end-to-end, so generated per-type clients would be pure boilerplate. The
same interface is implemented by :class:`kcp_tpu.server.rest.RestClient`
over HTTP, so controllers run equally in-process or remote.
"""

from __future__ import annotations

from ..apis.scheme import GVR, Scheme, default_scheme
from ..store.selectors import LabelSelector
from ..store.store import WILDCARD, LogicalStore, Watch
from ..utils.errors import InvalidError
from ..utils.routing import resolve_write_cluster


def _resource(gvr: GVR | str) -> str:
    return gvr.storage_name if isinstance(gvr, GVR) else gvr


class Client:
    """A view of one logical cluster (or the wildcard) over a LogicalStore."""

    def __init__(self, store: LogicalStore, cluster: str, scheme: Scheme | None = None):
        self._store = store
        self.cluster = cluster
        self.scheme = scheme if scheme is not None else default_scheme()

    def scoped(self, cluster: str) -> "Client":
        return Client(self._store, cluster, self.scheme)

    # -- reads ---------------------------------------------------------

    def get(self, gvr: GVR | str, name: str, namespace: str = "") -> dict:
        return self._store.get(_resource(gvr), self.cluster, name, namespace)

    def list(
        self,
        gvr: GVR | str,
        namespace: str | None = None,
        selector: LabelSelector | None = None,
    ) -> tuple[list[dict], int]:
        return self._store.list(_resource(gvr), self.cluster, namespace, selector)

    def watch(
        self,
        gvr: GVR | str,
        namespace: str | None = None,
        selector: LabelSelector | None = None,
        since_rv: int | None = None,
    ) -> Watch:
        return self._store.watch(_resource(gvr), self.cluster, namespace, selector, since_rv)

    # -- writes --------------------------------------------------------

    def _write_cluster(self, obj: dict) -> str:
        return resolve_write_cluster(self.cluster, obj)

    def create(self, gvr: GVR | str, obj: dict, namespace: str = "") -> dict:
        return self._store.create(_resource(gvr), self._write_cluster(obj), obj, namespace)

    def update(self, gvr: GVR | str, obj: dict, namespace: str = "") -> dict:
        return self._store.update(_resource(gvr), self._write_cluster(obj), obj, namespace)

    def update_status(self, gvr: GVR | str, obj: dict, namespace: str = "") -> dict:
        return self._store.update_status(
            _resource(gvr), self._write_cluster(obj), obj, namespace
        )

    def delete(self, gvr: GVR | str, name: str, namespace: str = "", cluster: str | None = None) -> None:
        target = cluster or self.cluster
        if target == WILDCARD:
            raise InvalidError("wildcard delete requires an explicit cluster")
        self._store.delete(_resource(gvr), target, name, namespace)

    # -- discovery -----------------------------------------------------

    def resources(self) -> list[str]:
        """Served resource names: the scheme's registry (built-ins +
        registered CRDs) plus anything already present in the store."""
        served = {i.gvr.storage_name for i in self.scheme.all()}
        served.update(self._store.resources())
        return sorted(served)

    def openapi_v2(self) -> dict | None:
        """The cluster's ``/openapi/v2`` swagger document (reference:
        the discovery client's OpenAPISchema fetch,
        pkg/crdpuller/discovery.go:60-66). Same resolution as the REST
        handler — attached document, else synthesized from the
        cluster's CRDs — so a puller sees identical schemas over either
        transport."""
        if self._store.openapi_doc is not None:
            return self._store.openapi_doc
        from ..apis import crd as crdapi
        from ..crdpuller.openapi import doc_from_crds

        try:
            crds, _ = self._store.list(crdapi.CRDS.storage_name, self.cluster)
        except Exception:  # noqa: BLE001 — no CRDs ⇒ empty document
            crds = []
        return doc_from_crds(crds) if crds else None


class MultiClusterClient(Client):
    """Wildcard client — list/watch across all tenants, routed writes.

    The fork's EnableMultiCluster behavior (SURVEY.md §2.3): reads span
    every logical cluster; each written object carries its destination in
    ``metadata.clusterName``.
    """

    def __init__(self, store: LogicalStore, scheme: Scheme | None = None):
        # accepts the SERVER's scheme so in-process controllers (CRD
        # lifecycle, negotiation) register dynamic resources into the
        # same registry the REST handler serves from — without it, a CRD
        # created over REST never becomes servable over REST
        super().__init__(store, WILDCARD, scheme)

    def cluster_client(self, cluster: str) -> Client:
        # share the scheme: CRD registrations must be visible to every view
        return Client(self._store, cluster, self.scheme)
