"""APIResource API types (apiresource.kcp.dev/v1alpha1).

Behavioral parity with the reference's two negotiation types
(pkg/apis/apiresource/v1alpha1/):

- ``APIResourceImport`` — one physical cluster's view of one API resource
  (conditions ``Compatible``, ``Available``; update strategies
  ``UpdateNever`` / ``UpdateUnpublished`` / ``UpdatePublished``,
  apiresourceimport_types.go:56-93)
- ``NegotiatedAPIResource`` — the LCD schema negotiated across all imports
  (conditions ``Submitted``, ``Published``, ``Enforced``,
  negociatedapiresource_types.go:59-81)

Both share a ``CommonAPIResourceSpec``: groupVersion + names + scope +
a raw JSON openAPIV3Schema + subresources + column definitions
(common_types.go:124-163).
"""

from __future__ import annotations

from .conditions import FALSE, TRUE, find_condition, is_condition_true, set_condition
from .scheme import GVR

GROUP = "apiresource.kcp.dev"
VERSION = "v1alpha1"
APIRESOURCEIMPORTS = GVR(GROUP, VERSION, "apiresourceimports")
NEGOTIATEDAPIRESOURCES = GVR(GROUP, VERSION, "negotiatedapiresources")

# APIResourceImport conditions
COMPATIBLE = "Compatible"
AVAILABLE = "Available"

# NegotiatedAPIResource conditions
SUBMITTED = "Submitted"
PUBLISHED = "Published"
ENFORCED = "Enforced"

# Schema update strategies (apiresourceimport_types.go:56-81)
UPDATE_NEVER = "UpdateNever"
UPDATE_UNPUBLISHED = "UpdateUnpublished"
UPDATE_PUBLISHED = "UpdatePublished"


def common_spec(
    group: str,
    version: str,
    plural: str,
    kind: str,
    scope: str = "Namespaced",
    schema: dict | None = None,
    sub_resources: list[str] | None = None,
) -> dict:
    return {
        "groupVersion": {"group": group, "version": version},
        "scope": scope,
        "plural": plural,
        "singular": kind.lower(),
        "kind": kind,
        "listKind": kind + "List",
        "openAPIV3Schema": schema or {"type": "object"},
        "subResources": [{"name": n} for n in (sub_resources or [])],
    }


def import_name(plural: str, group: str, version: str, location: str) -> str:
    """Canonical APIResourceImport object name.

    Reference naming: ``<location>.<plural>.<version>.<group>``
    (pkg/reconciler/cluster/apiimporter.go constructs one import per
    (cluster location, resource)).
    """
    return f"{location}.{plural}.{version}.{group or 'core'}"


def negotiated_name(plural: str, group: str, version: str) -> str:
    return f"{plural}.{version}.{group or 'core'}"


def new_api_resource_import(
    location: str,
    spec: dict,
    strategy: str = UPDATE_PUBLISHED,
) -> dict:
    gv = spec["groupVersion"]
    return {
        "apiVersion": f"{GROUP}/{VERSION}",
        "kind": "APIResourceImport",
        "metadata": {
            "name": import_name(spec["plural"], gv["group"], gv["version"], location)
        },
        "spec": {
            **spec,
            "location": location,
            "schemaUpdateStrategy": strategy,
        },
    }


def new_negotiated_api_resource(spec: dict, publish: bool = False) -> dict:
    gv = spec["groupVersion"]
    return {
        "apiVersion": f"{GROUP}/{VERSION}",
        "kind": "NegotiatedAPIResource",
        "metadata": {"name": negotiated_name(spec["plural"], gv["group"], gv["version"])},
        "spec": {**spec, "publish": publish},
    }


def can_update(api_import: dict, negotiated_is_published: bool) -> bool:
    """Whether this import may update the negotiated schema.

    Reference: apiresourceimport_types.go:83-93 ``CanUpdate`` — UpdateNever
    never updates; UpdateUnpublished only while unpublished;
    UpdatePublished always.
    """
    strategy = api_import["spec"].get("schemaUpdateStrategy", UPDATE_PUBLISHED)
    if strategy == UPDATE_NEVER:
        return False
    if strategy == UPDATE_UNPUBLISHED:
        return not negotiated_is_published
    return True


def set_compatible(obj: dict, ok: bool, reason: str = "", message: str = "") -> None:
    set_condition(obj, COMPATIBLE, TRUE if ok else FALSE, reason, message)


def set_available(obj: dict, ok: bool, reason: str = "", message: str = "") -> None:
    set_condition(obj, AVAILABLE, TRUE if ok else FALSE, reason, message)


def is_compatible_and_available(obj: dict) -> bool:
    """The gate for adding a resource to a Cluster's SyncedResources
    (reference: pkg/reconciler/cluster/cluster.go:61-77)."""
    return is_condition_true(obj, COMPATIBLE) and is_condition_true(obj, AVAILABLE)


def gvr_of(obj: dict) -> GVR:
    spec = obj["spec"]
    gv = spec["groupVersion"]
    return GVR(gv.get("group", ""), gv["version"], spec["plural"])


__all__ = [
    "GROUP",
    "VERSION",
    "APIRESOURCEIMPORTS",
    "NEGOTIATEDAPIRESOURCES",
    "COMPATIBLE",
    "AVAILABLE",
    "SUBMITTED",
    "PUBLISHED",
    "ENFORCED",
    "UPDATE_NEVER",
    "UPDATE_UNPUBLISHED",
    "UPDATE_PUBLISHED",
    "common_spec",
    "import_name",
    "negotiated_name",
    "new_api_resource_import",
    "new_negotiated_api_resource",
    "can_update",
    "set_compatible",
    "set_available",
    "is_compatible_and_available",
    "gvr_of",
    "find_condition",
]
