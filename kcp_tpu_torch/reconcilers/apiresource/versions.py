"""Kube-aware API version ordering (v2 > v1 > v1beta2 > v1beta1 > v1alpha1).

Needed by CRD publication to decide which version holds storage=true
(reference: negotiation.go:731-753 uses version.CompareKubeAwareVersionStrings).
"""

from __future__ import annotations

import re

_VERSION_RE = re.compile(r"^v(\d+)(?:(alpha|beta)(\d+)?)?$")

_STABILITY = {"alpha": 0, "beta": 1, None: 2}


def version_priority(v: str) -> tuple:
    """Sort key: higher tuple = newer/more stable version.

    Kube-style versions outrank everything else; among them stability wins
    (GA > beta > alpha), then major, then minor. Non-kube versions compare
    lexically among themselves.
    """
    m = _VERSION_RE.match(v)
    if not m:
        return (0, 0, 0, 0, v)
    major, stability, minor = m.groups()
    return (1, _STABILITY[stability], int(major), int(minor or 0), "")


def compare_kube_aware(a: str, b: str) -> int:
    """>0 if a outranks b, <0 if b outranks a, 0 if equal."""
    ka, kb = version_priority(a), version_priority(b)
    return (ka > kb) - (ka < kb)
