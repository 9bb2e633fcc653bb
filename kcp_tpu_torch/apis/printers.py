"""Server-side Table rendering — the ``kubectl get -o wide`` surface.

The reference curates printer columns per type with kubebuilder
annotations (e.g. APIResourceImport's Location / Schema update strategy
/ API Version / API Resource / Compatible / Available columns,
pkg/apis/apiresource/v1alpha1/apiresourceimport_types.go:32-37; Cluster's
Location / Ready / Synced API resources,
pkg/apis/cluster/v1alpha1/cluster_types.go kubebuilder block) and the
apiserver renders them when a client sends
``Accept: application/json;as=Table;v=v1;g=meta.k8s.io``. This module is
that rendering: per-resource column definitions + cell extraction over
plain objects, with a generic Name/Age fallback.
"""

from __future__ import annotations

import calendar
import time
from typing import Callable


def _condition(obj: dict, ctype: str) -> str:
    for c in ((obj.get("status") or {}).get("conditions") or []):
        if c.get("type") == ctype:
            return c.get("status", "Unknown")
    return "Unknown"


def _age(obj: dict, now: float | None = None) -> str:
    ts = (obj.get("metadata") or {}).get("creationTimestamp")
    if not ts:
        return "<unknown>"
    try:
        # timegm, not mktime: the timestamp is UTC and must not shift
        # with local DST
        created = calendar.timegm(time.strptime(ts, "%Y-%m-%dT%H:%M:%SZ"))
    except ValueError:
        return "<unknown>"
    secs = max(0, int((now if now is not None else time.time()) - created))
    if secs < 120:
        return f"{secs}s"
    if secs < 7200:
        return f"{secs // 60}m"
    if secs < 172800:
        return f"{secs // 3600}h"
    return f"{secs // 86400}d"


def _name(obj: dict) -> str:
    return (obj.get("metadata") or {}).get("name", "")


Column = tuple[str, str, Callable[[dict], str]]  # (name, type, cell fn)

_GENERIC: list[Column] = [
    ("Name", "string", _name),
    ("Age", "string", _age),
]

# per storage-name column sets (reference kubebuilder printcolumn blocks)
_COLUMNS: dict[str, list[Column]] = {
    "clusters.cluster.example.dev": [
        ("Name", "string", _name),
        ("Location", "string", _name),  # reference: Location = .metadata.name
        ("Ready", "string", lambda o: _condition(o, "Ready")),
        ("Synced API resources", "string",
         lambda o: ",".join((o.get("status") or {}).get("syncedResources") or [])),
        ("Age", "string", _age),
    ],
    "apiresourceimports.apiresource.kcp.dev": [
        ("Name", "string", _name),
        ("Location", "string", lambda o: (o.get("spec") or {}).get("location", "")),
        ("Schema update strategy", "string",
         lambda o: (o.get("spec") or {}).get("schemaUpdateStrategy", "")),
        ("API Version", "string",
         lambda o: (o.get("spec") or {}).get("groupVersion", "")),
        ("API Resource", "string", lambda o: (o.get("spec") or {}).get("plural", "")),
        ("Compatible", "string", lambda o: _condition(o, "Compatible")),
        ("Available", "string", lambda o: _condition(o, "Available")),
        ("Age", "string", _age),
    ],
    "negotiatedapiresources.apiresource.kcp.dev": [
        ("Name", "string", _name),
        ("Publish", "string",
         lambda o: str((o.get("spec") or {}).get("publish", False)).lower()),
        ("API Version", "string",
         lambda o: (o.get("spec") or {}).get("groupVersion", "")),
        ("API Resource", "string", lambda o: (o.get("spec") or {}).get("plural", "")),
        ("Published", "string", lambda o: _condition(o, "Published")),
        ("Enforced", "string", lambda o: _condition(o, "Enforced")),
        ("Age", "string", _age),
    ],
    "deployments.apps": [
        ("Name", "string", _name),
        ("Ready", "string", lambda o: (
            f"{(o.get('status') or {}).get('readyReplicas', 0)}/"
            f"{(o.get('spec') or {}).get('replicas', 1)}")),  # k8s defaults replicas to 1
        ("Up-to-date", "string",
         lambda o: str((o.get("status") or {}).get("updatedReplicas", 0))),
        ("Available", "string",
         lambda o: str((o.get("status") or {}).get("availableReplicas", 0))),
        ("Age", "string", _age),
    ],
    "namespaces": [
        ("Name", "string", _name),
        ("Status", "string", lambda o: (
            "Terminating" if (o.get("metadata") or {}).get("deletionTimestamp")
            else "Active")),
        ("Age", "string", _age),
    ],
    "configmaps": [
        ("Name", "string", _name),
        ("Data", "string", lambda o: str(len(o.get("data") or {}))),
        ("Age", "string", _age),
    ],
}


def wants_table(accept: str) -> bool:
    """Does the Accept header ask for the meta.k8s.io Table encoding?"""
    return "as=table" in (accept or "").lower().replace(" ", "")


def render_table(storage_name: str, items: list[dict], list_rv: int | None = None) -> dict:
    """A meta.k8s.io/v1 Table for the given objects."""
    cols = _COLUMNS.get(storage_name, _GENERIC)
    return {
        "kind": "Table",
        "apiVersion": "meta.k8s.io/v1",
        "metadata": {"resourceVersion": str(list_rv)} if list_rv is not None else {},
        "columnDefinitions": [
            {"name": n, "type": t, "format": "", "description": "", "priority": 0}
            for n, t, _fn in cols
        ],
        "rows": [
            {"cells": [fn(obj) for _n, _t, fn in cols],
             "object": {"kind": "PartialObjectMetadata",
                        "apiVersion": "meta.k8s.io/v1",
                        "metadata": obj.get("metadata", {})}}
            for obj in items
        ],
    }
