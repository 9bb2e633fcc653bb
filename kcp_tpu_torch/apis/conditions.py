"""Condition helpers shared by all API types.

Conditions are the primary observable state surface of the framework, as in
the reference (Ready / Compatible / Available / Submitted / Published /
Enforced — reference: pkg/apis/cluster/v1alpha1/cluster_types.go:63-83,
pkg/apis/apiresource/v1alpha1/apiresourceimport_helpers.go:26-42).

A condition is ``{type, status, reason?, message?, lastTransitionTime}``;
``lastTransitionTime`` only moves when ``status`` flips.
"""

from __future__ import annotations

import time
from typing import Mapping

TRUE = "True"
FALSE = "False"
UNKNOWN = "Unknown"


def _now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def _conditions(obj: dict) -> list[dict]:
    return obj.setdefault("status", {}).setdefault("conditions", [])


def find_condition(obj: Mapping, ctype: str) -> dict | None:
    for c in (obj.get("status") or {}).get("conditions") or []:
        if c.get("type") == ctype:
            return c
    return None


def set_condition(
    obj: dict,
    ctype: str,
    status: str,
    reason: str = "",
    message: str = "",
) -> bool:
    """Upsert a condition; returns True when anything changed."""
    conds = _conditions(obj)
    for c in conds:
        if c.get("type") == ctype:
            changed = (
                c.get("status") != status
                or c.get("reason", "") != reason
                or c.get("message", "") != message
            )
            if c.get("status") != status:
                c["lastTransitionTime"] = _now()
            c["status"] = status
            c["reason"] = reason
            c["message"] = message
            return changed
    conds.append(
        {
            "type": ctype,
            "status": status,
            "reason": reason,
            "message": message,
            "lastTransitionTime": _now(),
        }
    )
    return True


def remove_condition(obj: dict, ctype: str) -> bool:
    conds = (obj.get("status") or {}).get("conditions")
    if not conds:
        return False
    kept = [c for c in conds if c.get("type") != ctype]
    if len(kept) == len(conds):
        return False
    obj["status"]["conditions"] = kept
    return True


def is_condition_true(obj: Mapping, ctype: str) -> bool:
    c = find_condition(obj, ctype)
    return bool(c) and c.get("status") == TRUE


def is_condition_false(obj: Mapping, ctype: str) -> bool:
    c = find_condition(obj, ctype)
    return bool(c) and c.get("status") == FALSE
