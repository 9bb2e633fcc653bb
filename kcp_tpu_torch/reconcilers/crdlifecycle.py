"""CRD lifecycle: establish CRDs and serve their resources.

The analog of the apiextensions-apiserver's establishing controller,
which the reference gets from its forked apiserver: a created CRD gains
NamesAccepted + Established conditions and its resource becomes servable.
The negotiation controller's Published condition keys off Established
(reference: negotiation.go:239-255), so without this nothing ever
publishes.

Name conflicts cannot happen within one scheme the way they can in a real
apiserver (the store keys resources by plural.group), so establishment is
immediate. Registration into the Scheme makes the resource discoverable
to clients (``Client.resources``) and to the syncer's retry-until-served
discovery loop.
"""

from __future__ import annotations

import logging

from ..apis import crd as crdapi
from ..apis.scheme import ResourceInfo
from ..client import Client, Informer
from ..reconciler.controller import Controller
from ..utils import errors

log = logging.getLogger(__name__)


class CRDLifecycleController:
    def __init__(self, client: Client):
        self.client = client
        self.informer = Informer(client, crdapi.CRDS)
        self.controller = Controller("crd-lifecycle", self._process)
        self.informer.add_handler(self._on_event)

    def _on_event(self, etype: str, old: dict | None, new: dict | None) -> None:
        obj = new or old
        m = obj["metadata"]
        self.controller.enqueue((m.get("clusterName", ""), m["name"], etype == "DELETED"))

    async def _process(self, item) -> None:
        cluster, name, deleted = item
        if deleted:
            # serving teardown: the resource disappears from discovery when
            # no other logical cluster still defines it
            still_defined = any(
                c["metadata"]["name"] == name for c in self.informer.list()
            )
            if not still_defined:
                self.client.scheme.unregister(self._storage_name_from_crd_name(name))
            return
        crd = self.informer.get(cluster, name)
        if crd is None:
            return
        gvr = crdapi.gvr_of(crd)
        if self.client.scheme.by_resource(gvr.storage_name) is None:
            names = crd["spec"]["names"]
            self.client.scheme.register(
                ResourceInfo(
                    gvr=gvr,
                    kind=names["kind"],
                    list_kind=names.get("listKind", names["kind"] + "List"),
                    singular=names.get("singular", names["kind"].lower()),
                    namespaced=crd["spec"].get("scope", "Namespaced") == "Namespaced",
                )
            )
        if not crdapi.is_established(crd):
            # establish a fresh copy, never the informer's object: that is
            # the store's shared snapshot, and a status set on it in place
            # reaches every informer's cache before the write, so their
            # old/new comparison of the write's event sees no change (the
            # negotiation controller then never marks its resource
            # Published)
            scoped = self.client.scoped(cluster)
            fresh = scoped.get(crdapi.CRDS, name)
            crdapi.establish(fresh)
            try:
                scoped.update_status(crdapi.CRDS, fresh)
            except errors.ConflictError:
                self.controller.enqueue(item)

    @staticmethod
    def _storage_name_from_crd_name(crd_name: str) -> str:
        # CRD names are ``<plural>.<group>`` with ``core`` for the core group
        plural, _, group = crd_name.partition(".")
        return plural if group == "core" else crd_name

    async def start(self) -> None:
        await self.informer.start()
        await self.controller.start(1)

    async def stop(self) -> None:
        await self.controller.stop()
        await self.informer.stop()
