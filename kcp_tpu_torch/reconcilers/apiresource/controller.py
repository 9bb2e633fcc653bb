"""API-resource negotiation: the CRD <-> import <-> negotiated 3-way machine.

Behavioral port of the reference's richest controller
(pkg/reconciler/apiresource/{controller,negotiation}.go, ~1.3k LoC):

- every ``APIResourceImport`` (one physical cluster's view of one API)
  is folded into a per-(logical cluster, GVR) ``NegotiatedAPIResource``
  via the LCD engine (kcp_tpu_torch/schemacompat), stamping Compatible /
  Available conditions on the import (negotiation.go:460-585)
- a negotiated resource with ``spec.publish`` is published as a CRD
  (storage-version logic, owner reference, api-approved annotation for
  protected groups) and tracked with Submitted / Published conditions
  (negotiation.go:612-790)
- a manually created CRD (no NegotiatedAPIResource owner) *enforces* its
  schema: Enforced condition, negotiated schema overwritten, imports
  merely checked (negotiation.go:188-248)
- deletions cascade: orphaned negotiated resources are deleted, CRD
  versions pruned, conditions removed from imports
  (negotiation.go:109-123, 817-904)

Device angle: the expensive part at 5k-tenant scale is not the state
machine but repeated LCD tree-walks over identical schemas. Every
reconcile tick tokenizes the batch's distinct schemas and hashes them on
the controller's device in one call (ops/schemahash); LCD results are
memoized by (existing-hash, new-hash, narrow) so each distinct schema
pair walks the tree once per process lifetime.
"""

from __future__ import annotations

import copy
import logging
from typing import Sequence

import numpy as np
import torch

from ...apis import apiresource as ar
from ...apis import conditions as cond
from ...apis import crd as crdapi
from ...apis.scheme import GVR
from ...client import Client, Informer
from ...ops.hashing import canonical_json
from ...ops.schemahash import schema_hashes, tokenize_schema
from ...reconciler.controller import BatchController
from ...schemacompat import ensure_structural_schema_compatibility
from ...utils import errors
from ...utils.device import resolve_device
from .versions import compare_kube_aware

log = logging.getLogger(__name__)

NEGOTIATED_KIND = "NegotiatedAPIResource"
API_VERSION_ANNOTATION = "apiresource.kcp.dev/apiVersion"

# queue element actions (reference controller.go:150-183)
CREATED = "created"
SPEC_CHANGED = "specChanged"
STATUS_ONLY = "statusOnlyChanged"
DELETED_ACTION = "deleted"


def crd_name_for(gvr: GVR) -> str:
    """CRD object name; the reference maps the core group to ``.core``
    (negotiation.go:617-623)."""
    return f"{gvr.resource}.{gvr.group or 'core'}"


def is_protected_group(group: str) -> bool:
    return group.endswith(".k8s.io") or group.endswith(".kubernetes.io") or group in (
        "k8s.io", "kubernetes.io")


def _gvr_of_spec(obj: dict) -> GVR:
    spec = obj["spec"]
    gv = spec["groupVersion"]
    return GVR(gv.get("group", ""), gv["version"], spec["plural"])


def _crd_gvrs(crd: dict) -> list[GVR]:
    return [
        GVR(crd["spec"]["group"], v["name"], crd["spec"]["names"]["plural"])
        for v in crd["spec"].get("versions", [])
    ]


class NegotiationController:
    """Batched-tick negotiation controller over the wildcard client."""

    def __init__(self, client: Client, auto_publish: bool = False,
                 backend: str = "fused", device=None):
        if backend != "fused":
            raise ValueError(f"backend must be 'fused', got {backend!r}")
        self.client = client
        self.auto_publish = auto_publish
        self.backend = backend
        # schema hashes run here: the CUDA card unless the caller names the CPU
        self.device = resolve_device(device)
        self.import_informer = Informer(client, ar.APIRESOURCEIMPORTS)
        self.negotiated_informer = Informer(client, ar.NEGOTIATEDAPIRESOURCES)
        self.crd_informer = Informer(client, crdapi.CRDS)
        # clusterNameAndGVR indexers (reference controller.go:46-50)
        self.import_informer.add_indexer("cluster_gvr", self._cluster_gvr_index)
        self.negotiated_informer.add_indexer("cluster_gvr", self._cluster_gvr_index)
        self.controller = BatchController(
            "apiresource-negotiation", self._process_batch,
            # item = ((obj_type, clusterName, name), action): fairness is
            # per logical cluster, not per object
            tenant_of=lambda item: item[0][1],
        )
        self.import_informer.add_handler(self._make_handler("import"))
        self.negotiated_informer.add_handler(self._make_handler("negotiated"))
        self.crd_informer.add_handler(self._make_handler("crd"))
        # (ex-hash, new-hash, narrow) -> (ex-canon, new-canon, lcd, errors)
        self._lcd_memo: dict[tuple[int, int, bool], tuple[str, str, dict | None, tuple[str, ...]]] = {}
        self._hash_by_canon: dict[str, int] = {}
        self._deleted: dict[tuple, dict] = {}
        self.stats = {"ticks": 0, "lcd_walks": 0, "lcd_hits": 0}

    @staticmethod
    def _cluster_gvr_index(obj: dict) -> list[str]:
        gvr = _gvr_of_spec(obj)
        cl = obj["metadata"].get("clusterName", "")
        return [f"{cl}|{gvr.group}|{gvr.version}|{gvr.resource}"]

    # ------------------------------------------------------------ events

    def _make_handler(self, obj_type: str):
        def handler(etype: str, old: dict | None, new: dict | None) -> None:
            obj = new or old
            m = obj["metadata"]
            key = (obj_type, m.get("clusterName", ""), m["name"])
            # classify, as the reference's enqueue does (controller.go:238-295)
            if etype == "ADDED":
                action = CREATED
            elif etype == "DELETED":
                action = DELETED_ACTION
                self._deleted[key] = obj
            elif (old or {}).get("metadata", {}).get("generation") != m.get("generation"):
                action = SPEC_CHANGED
            elif (old or {}).get("status") != obj.get("status"):
                action = STATUS_ONLY
            else:
                return  # annotation-only changes are enqueued-then-ignored upstream
            self.controller.enqueue((key, action))

        return handler

    # -------------------------------------------------------------- tick

    async def _process_batch(self, items: Sequence) -> list[tuple[object, Exception]]:
        self.stats["ticks"] += 1
        self._prehash_batch_schemas(items)
        failed = []
        for item in items:
            try:
                self._process(item)
            except errors.ConflictError as err:
                failed.append((item, err))
            except Exception as err:  # noqa: BLE001
                failed.append((item, err))
        return failed

    def _prehash_batch_schemas(self, items: Sequence) -> None:
        """Hash every schema the batch will touch in one device call.

        This is the configs[3] device path: at 5k tenants most imports
        carry one of a handful of distinct schemas; hashing them as one
        [B, T] batch and memoizing LCD by hash pair means the LCD tree
        walks stay O(distinct), not O(imports). Hashes are keyed by the
        canonical JSON of the schema (exact), never by object identity.
        """
        pending: dict[str, np.ndarray] = {}
        for (obj_type, cluster, name), _action in items:
            obj = None
            if obj_type == "import":
                obj = self.import_informer.get(cluster, name)
            elif obj_type == "negotiated":
                obj = self.negotiated_informer.get(cluster, name)
            if obj is not None:
                schema = obj.get("spec", {}).get("openAPIV3Schema")
                if schema is not None:
                    key = canonical_json(schema)
                    if key not in self._hash_by_canon and key not in pending:
                        pending[key] = tokenize_schema(schema)
        if not pending:
            return
        keys = list(pending)
        hashes = self._hash_tokens(np.stack([pending[k] for k in keys]))
        for k, h in zip(keys, hashes):
            self._hash_by_canon[k] = int(h)

    def _hash_tokens(self, tokens: np.ndarray) -> np.ndarray:
        """uint32 hashes of ``[B, T]`` token rows, computed on the
        controller's device."""
        h = schema_hashes(torch.from_numpy(tokens).to(self.device))
        return h.cpu().numpy().astype(np.uint32)

    def _schema_hash(self, schema: dict) -> tuple[str, int]:
        """(canonical json, uint32 hash) of a schema; cached exactly."""
        key = canonical_json(schema)
        h = self._hash_by_canon.get(key)
        if h is None:
            h = int(self._hash_tokens(tokenize_schema(schema)[None, :])[0])
            self._hash_by_canon[key] = h
        return key, h

    def _lcd(self, existing: dict, new: dict, narrow: bool, kind: str):
        ex_canon, ex_h = self._schema_hash(existing)
        new_canon, new_h = self._schema_hash(new)
        key = (ex_h, new_h, narrow)
        hit = self._lcd_memo.get(key)
        if hit is not None:
            # host-side equality re-check: a 32-bit collision must never
            # serve another schema pair's verdict
            hit_ex_canon, hit_new_canon, lcd, errs = hit
            if hit_ex_canon == ex_canon and hit_new_canon == new_canon:
                self.stats["lcd_hits"] += 1
                return copy.deepcopy(lcd), list(errs)
        lcd, errs = ensure_structural_schema_compatibility(
            existing, new, narrow_existing=narrow, fld_path=kind
        )
        self.stats["lcd_walks"] += 1
        self._lcd_memo[key] = (ex_canon, new_canon, copy.deepcopy(lcd), tuple(errs))
        return lcd, errs

    # ----------------------------------------------------------- process

    def _process(self, item) -> None:
        (obj_type, cluster, name), action = item
        if obj_type == "crd":
            self._process_crd(cluster, name, action)
        elif obj_type == "import":
            self._process_import(cluster, name, action)
        else:
            self._process_negotiated(cluster, name, action)
        self._deleted.pop((obj_type, cluster, name), None)

    # -- CRD events (negotiation.go:43-80)

    def _process_crd(self, cluster: str, name: str, action: str) -> None:
        crd = self.crd_informer.get(cluster, name) or self._deleted.get(("crd", cluster, name))
        if crd is None:
            return
        if action in (CREATED, SPEC_CHANGED):
            if self._is_manually_created_crd(crd):
                self._enforce_crd(cluster, crd)
            self._update_publishing_status(cluster, crd)
        elif action == STATUS_ONLY:
            self._update_publishing_status(cluster, crd)
        elif action == DELETED_ACTION:
            if self._is_manually_created_crd(crd):
                for gvr in _crd_gvrs(crd):
                    neg = self._negotiated_for(cluster, gvr)
                    if neg is not None:
                        self._delete_negotiated(cluster, neg)
            else:
                self._update_publishing_status(cluster, crd, deleted=True)

    # -- import events (negotiation.go:82-125)

    def _process_import(self, cluster: str, name: str, action: str) -> None:
        imp = self.import_informer.get(cluster, name)
        if imp is None:
            imp = self._deleted.get(("import", cluster, name))
            if imp is None:
                return
            gvr = _gvr_of_spec(imp)
            if self._negotiated_is_orphan(cluster, gvr):
                neg = self._negotiated_for(cluster, gvr)
                if neg is not None:
                    self._delete_negotiated(cluster, neg)
                return
            self.ensure_api_resource_compatibility(
                cluster, gvr, None, override_strategy=ar.UPDATE_PUBLISHED
            )
            return
        gvr = _gvr_of_spec(imp)
        if action in (CREATED, SPEC_CHANGED):
            self.ensure_api_resource_compatibility(cluster, gvr, imp)
        elif action == STATUS_ONLY:
            if (cond.find_condition(imp, ar.COMPATIBLE) is None
                    and cond.find_condition(imp, ar.AVAILABLE) is None):
                self.ensure_api_resource_compatibility(cluster, gvr, imp)

    # -- negotiated events (negotiation.go:126-171)

    def _process_negotiated(self, cluster: str, name: str, action: str) -> None:
        neg = self.negotiated_informer.get(cluster, name)
        if neg is None:
            neg = self._deleted.get(("negotiated", cluster, name))
            if neg is None:
                return
            if action == DELETED_ACTION:
                self._cleanup_negotiated(cluster, neg)
            return
        gvr = _gvr_of_spec(neg)
        if action in (CREATED, SPEC_CHANGED):
            if cond.is_condition_true(neg, ar.ENFORCED):
                self.ensure_api_resource_compatibility(
                    cluster, gvr, None, override_strategy=ar.UPDATE_NEVER
                )
            if neg["spec"].get("publish") and not cond.is_condition_true(neg, ar.ENFORCED):
                self._publish_negotiated(cluster, gvr, neg)
                neg = self.negotiated_informer.get(cluster, name) or neg
            self._update_related_imports(cluster, gvr, neg)
        elif action == STATUS_ONLY:
            self._update_related_imports(cluster, gvr, neg)
        elif action == DELETED_ACTION:
            self._cleanup_negotiated(cluster, neg)

    # ------------------------------------------------------------ helpers

    def _scoped(self, cluster: str) -> Client:
        return self.client.scoped(cluster)

    def _negotiated_for(self, cluster: str, gvr: GVR) -> dict | None:
        objs = self.negotiated_informer.index(
            "cluster_gvr", f"{cluster}|{gvr.group}|{gvr.version}|{gvr.resource}"
        )
        return copy.deepcopy(objs[0]) if objs else None

    def _imports_for(self, cluster: str, gvr: GVR) -> list[dict]:
        return [
            copy.deepcopy(o)
            for o in self.import_informer.index(
                "cluster_gvr", f"{cluster}|{gvr.group}|{gvr.version}|{gvr.resource}"
            )
        ]

    def _is_manually_created_crd(self, crd: dict) -> bool:
        for ref in crd["metadata"].get("ownerReferences") or []:
            if (ref.get("apiVersion") == f"{ar.GROUP}/{ar.VERSION}"
                    and ref.get("kind") == NEGOTIATED_KIND):
                return False
        return True

    # -- enforcement (negotiation.go:200-236)

    def _enforce_crd(self, cluster: str, crd: dict) -> None:
        for gvr in _crd_gvrs(crd):
            neg = self._negotiated_for(cluster, gvr)
            if neg is None:
                continue
            scoped = self._scoped(cluster)
            cond.set_condition(neg, ar.ENFORCED, cond.TRUE)
            neg = scoped.update_status(ar.NEGOTIATEDAPIRESOURCES, neg)
            version = crdapi.version_entry(crd, gvr.version)
            schema = ((version or {}).get("schema") or {}).get("openAPIV3Schema")
            if schema is not None:
                neg["spec"]["openAPIV3Schema"] = copy.deepcopy(schema)
                scoped.update(ar.NEGOTIATEDAPIRESOURCES, neg)

    # -- publishing status propagation (negotiation.go:239-293)

    def _update_publishing_status(self, cluster: str, crd: dict, deleted: bool = False) -> None:
        manually = self._is_manually_created_crd(crd)
        for gvr in _crd_gvrs(crd):
            neg = self._negotiated_for(cluster, gvr)
            if neg is None:
                continue
            if deleted:
                cond.set_condition(neg, ar.PUBLISHED, cond.FALSE, "CRDDeleted")
            elif (crdapi.is_established(crd)
                  and cond.is_condition_true(crd, crdapi.NAMES_ACCEPTED)):
                cond.set_condition(neg, ar.PUBLISHED, cond.TRUE)
            elif (cond.is_condition_false(crd, crdapi.ESTABLISHED)
                  or cond.is_condition_false(crd, crdapi.NAMES_ACCEPTED)):
                cond.set_condition(neg, ar.PUBLISHED, cond.FALSE, "Refused")
            cond.set_condition(neg, ar.ENFORCED, cond.TRUE if manually else cond.FALSE)
            self._scoped(cluster).update_status(ar.NEGOTIATEDAPIRESOURCES, neg)

    # -- the LCD fold (negotiation.go:338-585)

    def ensure_api_resource_compatibility(
        self,
        cluster: str,
        gvr: GVR,
        api_import: dict | None,
        override_strategy: str | None = None,
    ) -> None:
        negotiated = self._negotiated_for(cluster, gvr)
        imports = [api_import] if api_import is not None else self._imports_for(cluster, gvr)
        if not imports:
            return

        scoped = self._scoped(cluster)
        new_negotiated: dict | None = negotiated if api_import is not None else None
        updated_schema = False
        negotiated_existed = negotiated is not None

        # a manually created CRD supersedes everything (negotiation.go:390-455)
        crd = self.crd_informer.get(cluster, crd_name_for(gvr))
        if crd is not None and self._is_manually_created_crd(crd):
            version = crdapi.version_entry(crd, gvr.version)
            if version is not None:
                spec = ar.common_spec(
                    gvr.group, gvr.version,
                    crd["spec"]["names"]["plural"], crd["spec"]["names"]["kind"],
                    scope=crd["spec"].get("scope", "Namespaced"),
                    schema=(version.get("schema") or {}).get("openAPIV3Schema"),
                    sub_resources=(["status"] if "status" in (version.get("subresources") or {})
                                   else []),
                )
                new_negotiated = ar.new_negotiated_api_resource(spec, publish=True)
                new_negotiated["metadata"]["clusterName"] = cluster
                new_negotiated["metadata"].setdefault("annotations", {})[
                    API_VERSION_ANNOTATION
                ] = f"{gvr.group}/{gvr.version}" if gvr.group else gvr.version
                cond.set_condition(new_negotiated, ar.PUBLISHED, cond.TRUE)
                cond.set_condition(new_negotiated, ar.ENFORCED, cond.TRUE)

        import_status_writes: list[dict] = []
        for imp in imports:
            if new_negotiated is None:
                # first import founds the negotiated resource
                # (negotiation.go:461-486)
                new_negotiated = ar.new_negotiated_api_resource(
                    copy.deepcopy(
                        {k: v for k, v in imp["spec"].items()
                         if k not in ("location", "schemaUpdateStrategy")}
                    ),
                    publish=self.auto_publish,
                )
                new_negotiated["metadata"]["clusterName"] = cluster
                new_negotiated["metadata"].setdefault("annotations", {})[
                    API_VERSION_ANNOTATION
                ] = f"{gvr.group}/{gvr.version}" if gvr.group else gvr.version
                if negotiated is not None:
                    new_negotiated["metadata"]["resourceVersion"] = negotiated[
                        "metadata"]["resourceVersion"]
                    new_negotiated["spec"]["publish"] = negotiated["spec"].get("publish", False)
                updated_schema = True
                ar.set_compatible(imp, True)
            else:
                published = cond.is_condition_true(new_negotiated, ar.PUBLISHED)
                enforced = cond.is_condition_true(new_negotiated, ar.ENFORCED)
                if override_strategy == ar.UPDATE_NEVER:
                    allow_update = False
                elif override_strategy == ar.UPDATE_PUBLISHED:
                    allow_update = not enforced
                else:
                    allow_update = not enforced and ar.can_update(imp, published)
                import_schema = imp["spec"].get("openAPIV3Schema") or {}
                negotiated_schema = new_negotiated["spec"].get("openAPIV3Schema") or {}
                lcd, errs = self._lcd(
                    negotiated_schema, import_schema, allow_update,
                    new_negotiated["spec"].get("kind", "Schema"),
                )
                if errs:
                    ar.set_compatible(imp, False, "IncompatibleSchema", "; ".join(errs))
                else:
                    ar.set_compatible(imp, True)
                    if published:
                        ar.set_available(imp, True)
                    if allow_update and lcd != negotiated_schema:
                        new_negotiated["spec"]["openAPIV3Schema"] = lcd
                        updated_schema = True
            import_status_writes.append(imp)

        assert new_negotiated is not None
        if not negotiated_existed:
            try:
                created = scoped.create(ar.NEGOTIATEDAPIRESOURCES, new_negotiated)
            except errors.AlreadyExistsError:
                created = scoped.get(
                    ar.NEGOTIATEDAPIRESOURCES, new_negotiated["metadata"]["name"]
                )
            if (new_negotiated.get("status") or {}).get("conditions"):
                created["status"] = new_negotiated["status"]
                scoped.update_status(ar.NEGOTIATEDAPIRESOURCES, created)
        elif updated_schema:
            scoped.update(ar.NEGOTIATEDAPIRESOURCES, new_negotiated)

        for imp in import_status_writes:
            fresh = scoped.get(ar.APIRESOURCEIMPORTS, imp["metadata"]["name"])
            fresh["status"] = imp.get("status", {})
            scoped.update_status(ar.APIRESOURCEIMPORTS, fresh)

    def _negotiated_is_orphan(self, cluster: str, gvr: GVR) -> bool:
        if self._imports_for(cluster, gvr):
            return False
        neg = self._negotiated_for(cluster, gvr)
        if neg is None:
            return False
        return not cond.is_condition_true(neg, ar.ENFORCED)

    # -- CRD publication (negotiation.go:612-790)

    def _publish_negotiated(self, cluster: str, gvr: GVR, neg: dict) -> None:
        scoped = self._scoped(cluster)
        name = crd_name_for(gvr)
        schema = neg["spec"].get("openAPIV3Schema") or {"type": "object"}
        subresources = {}
        for sub in neg["spec"].get("subResources") or []:
            if sub.get("name") == "status":
                subresources["status"] = {}
            if sub.get("name") == "scale":
                subresources["scale"] = {
                    "specReplicasPath": ".spec.replicas",
                    "statusReplicasPath": ".status.replicas",
                }
        version_entry = {
            "name": gvr.version,
            "served": True,
            "storage": True,
            "schema": {"openAPIV3Schema": copy.deepcopy(schema)},
        }
        if subresources:
            version_entry["subresources"] = subresources
        owner_ref = {
            "apiVersion": f"{ar.GROUP}/{ar.VERSION}",
            "kind": NEGOTIATED_KIND,
            "name": neg["metadata"]["name"],
            "uid": neg["metadata"].get("uid"),
        }
        crd = self.crd_informer.get(cluster, name)
        if crd is None:
            new_crd = {
                "apiVersion": f"{crdapi.GROUP}/{crdapi.VERSION}",
                "kind": "CustomResourceDefinition",
                "metadata": {
                    "name": name,
                    "clusterName": cluster,
                    "ownerReferences": [owner_ref],
                },
                "spec": {
                    "group": gvr.group,
                    "scope": neg["spec"].get("scope", "Namespaced"),
                    "names": {
                        "plural": neg["spec"]["plural"],
                        "singular": neg["spec"].get("singular", ""),
                        "kind": neg["spec"]["kind"],
                        "listKind": neg["spec"].get("listKind", neg["spec"]["kind"] + "List"),
                    },
                    "versions": [version_entry],
                },
            }
            if is_protected_group(gvr.group):
                new_crd["metadata"]["annotations"] = {
                    crdapi.API_APPROVED_ANNOTATION: "https://github.com/kcp-dev/kubernetes/pull/4"
                }
            try:
                scoped.create(crdapi.CRDS, new_crd)
            except errors.AlreadyExistsError:
                pass
        elif not self._is_manually_created_crd(crd):
            crd = copy.deepcopy(crd)
            versions = crd["spec"].setdefault("versions", [])
            new_is_latest = all(
                compare_kube_aware(v["name"], gvr.version) <= 0 for v in versions
            )
            if not new_is_latest:
                version_entry["storage"] = False
            else:
                for v in versions:
                    v["storage"] = False
            for i, v in enumerate(versions):
                if v["name"] == gvr.version:
                    versions[i] = version_entry
                    break
            else:
                versions.append(version_entry)
            refs = crd["metadata"].setdefault("ownerReferences", [])
            if not any(r.get("name") == owner_ref["name"] and r.get("uid") == owner_ref["uid"]
                       for r in refs):
                refs.append(owner_ref)
            scoped.update(crdapi.CRDS, crd)

        fresh = scoped.get(ar.NEGOTIATEDAPIRESOURCES, neg["metadata"]["name"])
        cond.set_condition(fresh, ar.SUBMITTED, cond.TRUE)
        scoped.update_status(ar.NEGOTIATEDAPIRESOURCES, fresh)

    # -- Available propagation (negotiation.go:793-814)

    def _update_related_imports(self, cluster: str, gvr: GVR, neg: dict) -> None:
        published = cond.find_condition(neg, ar.PUBLISHED)
        if published is None:
            return
        scoped = self._scoped(cluster)
        for imp in self._imports_for(cluster, gvr):
            fresh = scoped.get(ar.APIRESOURCEIMPORTS, imp["metadata"]["name"])
            if cond.set_condition(fresh, ar.AVAILABLE, published["status"]):
                scoped.update_status(ar.APIRESOURCEIMPORTS, fresh)

    # -- deletion cascades (negotiation.go:295-332, 817-904)

    def _delete_negotiated(self, cluster: str, neg: dict) -> None:
        try:
            self._scoped(cluster).delete(
                ar.NEGOTIATEDAPIRESOURCES, neg["metadata"]["name"]
            )
        except errors.NotFoundError:
            pass

    def _cleanup_negotiated(self, cluster: str, neg: dict) -> None:
        gvr = _gvr_of_spec(neg)
        scoped = self._scoped(cluster)
        for imp in self._imports_for(cluster, gvr):
            fresh = scoped.get(ar.APIRESOURCEIMPORTS, imp["metadata"]["name"])
            removed = cond.remove_condition(fresh, ar.AVAILABLE)
            removed |= cond.remove_condition(fresh, ar.COMPATIBLE)
            if removed:
                scoped.update_status(ar.APIRESOURCEIMPORTS, fresh)

        crd = self.crd_informer.get(cluster, crd_name_for(gvr))
        if crd is None:
            return
        refs = crd["metadata"].get("ownerReferences") or []
        kept_refs = [r for r in refs
                     if not (r.get("name") == neg["metadata"]["name"]
                             and r.get("uid") == neg["metadata"].get("uid"))]
        if len(kept_refs) == len(refs):
            return  # not owned by this negotiated resource
        kept_versions = [v for v in crd["spec"].get("versions", [])
                         if v["name"] != gvr.version]
        if len(kept_versions) == len(crd["spec"].get("versions", [])):
            return
        if not kept_versions:
            try:
                scoped.delete(crdapi.CRDS, crd["metadata"]["name"])
            except errors.NotFoundError:
                pass
        else:
            crd = copy.deepcopy(crd)
            crd["spec"]["versions"] = kept_versions
            crd["metadata"]["ownerReferences"] = kept_refs
            scoped.update(crdapi.CRDS, crd)

    # ---------------------------------------------------------- lifecycle

    async def start(self, num_workers: int = 2) -> None:
        await self.import_informer.start()
        await self.negotiated_informer.start()
        await self.crd_informer.start()
        await self.controller.start(num_workers)

    async def stop(self) -> None:
        await self.controller.stop()
        await self.import_informer.stop()
        await self.negotiated_informer.stop()
        await self.crd_informer.stop()
