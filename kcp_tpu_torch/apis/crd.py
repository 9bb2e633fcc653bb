"""CustomResourceDefinition — the minimal subset the framework serves.

Parity notes: the reference gets CRDs from the (un-vendored) apiextensions
apiserver; what this framework needs is the subset the negotiation
controller and API server touch (reference: pkg/reconciler/apiresource/
negotiation.go:612-790 publishNegotiatedResource — create/update CRD,
storage-version logic, api-approved annotation; conditions Established /
NamesAccepted).
"""

from __future__ import annotations

from .conditions import TRUE, is_condition_true, set_condition
from .scheme import GVR

GROUP = "apiextensions.k8s.io"
VERSION = "v1"
CRDS = GVR(GROUP, VERSION, "customresourcedefinitions")

ESTABLISHED = "Established"
NAMES_ACCEPTED = "NamesAccepted"

# Kubernetes requires this annotation for *.k8s.io / *.kubernetes.io groups;
# the reference stamps it when publishing (negotiation.go, api-approved).
API_APPROVED_ANNOTATION = "api-approved.kubernetes.io"


def crd_name(plural: str, group: str) -> str:
    return f"{plural}.{group}" if group else plural


def new_crd(
    group: str,
    version: str,
    plural: str,
    kind: str,
    scope: str = "Namespaced",
    schema: dict | None = None,
    subresources: dict | None = None,
    served: bool = True,
    storage: bool = True,
) -> dict:
    return {
        "apiVersion": f"{GROUP}/{VERSION}",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": crd_name(plural, group)},
        "spec": {
            "group": group,
            "scope": scope,
            "names": {
                "plural": plural,
                "singular": kind.lower(),
                "kind": kind,
                "listKind": kind + "List",
            },
            "versions": [
                {
                    "name": version,
                    "served": served,
                    "storage": storage,
                    "schema": {"openAPIV3Schema": schema or {"type": "object"}},
                    **({"subresources": subresources} if subresources else {}),
                }
            ],
        },
    }


def storage_version(crd: dict) -> str | None:
    for v in crd["spec"].get("versions", []):
        if v.get("storage"):
            return v["name"]
    return None


def served_versions(crd: dict) -> list[str]:
    return [v["name"] for v in crd["spec"].get("versions", []) if v.get("served")]


def version_entry(crd: dict, version: str) -> dict | None:
    for v in crd["spec"].get("versions", []):
        if v["name"] == version:
            return v
    return None


def is_established(crd: dict) -> bool:
    return is_condition_true(crd, ESTABLISHED)


def establish(crd: dict) -> None:
    """Mark the CRD Established/NamesAccepted (the API server does this on
    registration; the real apiextensions controller races name conflicts,
    which a single-scheme store cannot have)."""
    set_condition(crd, NAMES_ACCEPTED, TRUE, "NoConflicts")
    set_condition(crd, ESTABLISHED, TRUE, "InitialNamesAccepted")
    stored = crd.setdefault("status", {}).setdefault("storedVersions", [])
    sv = storage_version(crd)
    if sv and sv not in stored:
        stored.append(sv)


def gvr_of(crd: dict) -> GVR:
    sv = storage_version(crd) or (crd["spec"]["versions"][0]["name"] if crd["spec"].get("versions") else "v1")
    return GVR(crd["spec"]["group"], sv, crd["spec"]["names"]["plural"])
