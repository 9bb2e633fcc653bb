"""Namespace lifecycle: finalize-and-sweep on deletion, per tenant.

The reference wires the upstream Kubernetes namespace controller into
kcp as a post-start hook with a per-logical-cluster discovery function
("start-namespace-controller", pkg/server/server.go:325-356). Its job:
a deleted Namespace first gains a deletionTimestamp while its
``kubernetes`` finalizer holds it; the controller then deletes every
namespaced object inside, and only once the namespace is empty does it
strip the finalizer so the namespace disappears.

This controller re-expresses that per-tenant sweep over the logical
store: it watches namespaces across ALL logical clusters at once (one
wildcard watch instead of one controller instance per tenant — the
cross-tenant fan-in idiom this framework uses everywhere), discovers
namespaced resources from the live Scheme (the per-cluster discovery
analog), and sweeps with plain client deletes so cascades (objects with
their own finalizers) settle level-triggered over repeated reconciles.

The ``kubernetes`` finalizer itself is stamped synchronously at create
by the store (admission-style, store.py) so a create+delete race can
never skip the sweep; a DELETED namespace still reconciles once more to
sweep any orphaned contents (e.g. after a manual finalizer removal).
"""

from __future__ import annotations

import logging

from ..client import Client, Informer
from ..reconciler.controller import Controller
from ..utils.errors import RetryableError

log = logging.getLogger(__name__)

FINALIZER = "kubernetes"  # upstream's namespace lifecycle finalizer name
NAMESPACES = "namespaces"


class NamespaceLifecycleController:
    """Finalizer management + content sweep for namespace deletion."""

    def __init__(self, client: Client):
        self.client = client
        self.informer = Informer(client, NAMESPACES)
        self.controller = Controller("namespace-lifecycle", self._process)
        self.informer.add_handler(self._on_event)

    def _on_event(self, etype: str, old: dict | None, new: dict | None) -> None:
        # DELETED included: a final reconcile sweeps contents orphaned by
        # out-of-band finalizer removal
        m = (new or old)["metadata"]
        self.controller.enqueue((m.get("clusterName", ""), m["name"]))

    def _namespaced_resources(self) -> list[str]:
        """Discovery: every namespaced resource the scheme serves now.

        Runs per reconcile so CRD-backed resources registered after
        startup are swept too (the reference's per-logical-cluster
        discoveryFn is rebuilt per call the same way, server.go:336-344).
        """
        return [
            info.gvr.storage_name
            for info in self.client.scheme.all()
            if info.namespaced
        ]

    def _sweep(self, scoped: Client, name: str) -> int:
        """Delete namespace contents; return how many objects remain."""
        remaining = 0
        for resource in self._namespaced_resources():
            if resource == NAMESPACES:
                continue
            objs, _ = scoped.list(resource, namespace=name)
            for obj in objs:
                remaining += 1
                if not obj["metadata"].get("deletionTimestamp"):
                    scoped.delete(resource, obj["metadata"]["name"], namespace=name)
        return remaining

    async def _process(self, item) -> None:
        cluster, name = item
        scoped = self.client.scoped(cluster)
        ns = self.informer.get(cluster, name)
        if ns is None:
            # namespace already gone (e.g. finalizer removed out of
            # band): sweep orphaned contents so nothing leaks
            if self._sweep(scoped, name):
                raise RetryableError(f"orphaned contents of {cluster}/{name} draining")
            return
        meta = ns["metadata"]
        finalizers = meta.get("finalizers") or []

        if not meta.get("deletionTimestamp"):
            # the store stamps the finalizer at create; repair it here if
            # something stripped it from a live namespace
            if FINALIZER not in finalizers:
                fresh = scoped.get(NAMESPACES, name)
                fins = fresh["metadata"].setdefault("finalizers", [])
                if FINALIZER not in fins:  # re-check: informer copy is stale
                    fins.append(FINALIZER)
                    scoped.update(NAMESPACES, fresh)
            return

        # terminating: sweep contents, then release the finalizer
        if self._sweep(scoped, name):
            # cascading deletes (finalizered contents) settle over time;
            # retryable -> the workqueue's exponential backoff paces the
            # re-list instead of a fixed-rate poll
            raise RetryableError(f"namespace {cluster}/{name} not yet empty")
        if FINALIZER in finalizers:
            fresh = scoped.get(NAMESPACES, name)
            fresh["metadata"]["finalizers"] = [
                f for f in fresh["metadata"].get("finalizers", []) if f != FINALIZER
            ]
            scoped.update(NAMESPACES, fresh)  # store removes it once empty

    async def start(self) -> None:
        await self.informer.start()
        await self.controller.start(2)

    async def stop(self) -> None:
        await self.controller.stop()
        await self.informer.stop()
