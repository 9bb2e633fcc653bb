"""Label selectors: parsing and matching.

The host-side reference semantics for the device-side label-match kernel
(kcp_tpu/ops/labelmatch.py). The reference relies on upstream Kubernetes
label selectors; the subset implemented here covers everything the
reference itself uses (plain equality, e.g. ``kcp.dev/cluster=<id>`` at
pkg/syncer/syncer.go:106-108) plus the standard set-based operators so the
framework is usable as a general control plane.

Grammar (comma = AND):
    key=value | key==value | key!=value
    key in (v1,v2) | key notin (v1,v2)
    key            (exists)
    !key           (not exists)
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Iterable, Mapping

_SET_RE = re.compile(r"^\s*(?P<key>[^!=\s]+)\s+(?P<op>in|notin)\s+\((?P<vals>[^)]*)\)\s*$")


@dataclass(frozen=True)
class Requirement:
    key: str
    op: str  # "=", "!=", "in", "notin", "exists", "!exists"
    values: tuple[str, ...] = ()

    def matches(self, labels: Mapping[str, str]) -> bool:
        present = self.key in labels
        if self.op == "exists":
            return present
        if self.op == "!exists":
            return not present
        if self.op == "=":
            return present and labels[self.key] == self.values[0]
        if self.op == "!=":
            # Kubernetes semantics: absent key satisfies !=
            return not present or labels[self.key] != self.values[0]
        if self.op == "in":
            return present and labels[self.key] in self.values
        if self.op == "notin":
            return not present or labels[self.key] not in self.values
        raise ValueError(f"unknown selector op {self.op!r}")


@dataclass(frozen=True)
class LabelSelector:
    requirements: tuple[Requirement, ...] = field(default_factory=tuple)

    def matches(self, labels: Mapping[str, str] | None) -> bool:
        labels = labels or {}
        return all(r.matches(labels) for r in self.requirements)

    @property
    def empty(self) -> bool:
        return not self.requirements

    @property
    def single_equality(self) -> tuple[str, str] | None:
        """(key, value) when this is exactly one ``=`` requirement — the
        dominant watch shape (the syncer registers one
        ``kcp.dev/cluster=<id>`` per cluster) and the one the batched
        fan-out can answer with a single pair-presence compare
        (ops/labelmatch.fanout_match)."""
        if len(self.requirements) == 1:
            r = self.requirements[0]
            if r.op == "=" and len(r.values) == 1:
                return (r.key, r.values[0])
        return None

    def __str__(self) -> str:
        parts = []
        for r in self.requirements:
            if r.op == "exists":
                parts.append(r.key)
            elif r.op == "!exists":
                parts.append(f"!{r.key}")
            elif r.op in ("in", "notin"):
                parts.append(f"{r.key} {r.op} ({','.join(r.values)})")
            else:
                parts.append(f"{r.key}{r.op}{r.values[0]}")
        return ",".join(parts)


def everything() -> LabelSelector:
    return LabelSelector(())


def parse_selector(spec: str | None) -> LabelSelector:
    """Parse a selector string. Empty/None selects everything."""
    if not spec or not spec.strip():
        return everything()
    reqs: list[Requirement] = []
    for raw in _split_top_level(spec):
        term = raw.strip()
        if not term:
            continue
        m = _SET_RE.match(term)
        if m:
            vals = tuple(v.strip() for v in m.group("vals").split(",") if v.strip())
            reqs.append(Requirement(m.group("key"), m.group("op"), vals))
        elif "!=" in term:
            key, _, val = term.partition("!=")
            reqs.append(Requirement(key.strip(), "!=", (val.strip(),)))
        elif "==" in term:
            key, _, val = term.partition("==")
            reqs.append(Requirement(key.strip(), "=", (val.strip(),)))
        elif "=" in term:
            key, _, val = term.partition("=")
            reqs.append(Requirement(key.strip(), "=", (val.strip(),)))
        elif term.startswith("!"):
            reqs.append(Requirement(term[1:].strip(), "!exists"))
        else:
            reqs.append(Requirement(term, "exists"))
    return LabelSelector(tuple(reqs))


def _split_top_level(spec: str) -> Iterable[str]:
    """Split on commas that are not inside ``in (...)`` value lists."""
    depth = 0
    start = 0
    for i, ch in enumerate(spec):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth = max(0, depth - 1)
        elif ch == "," and depth == 0:
            yield spec[start:i]
            start = i + 1
    yield spec[start:]


def selector_from_dict(sel: Mapping | None) -> LabelSelector:
    """Build a selector from the k8s ``{matchLabels, matchExpressions}`` form."""
    if not sel:
        return everything()
    reqs: list[Requirement] = []
    for k, v in (sel.get("matchLabels") or {}).items():
        reqs.append(Requirement(k, "=", (str(v),)))
    for expr in sel.get("matchExpressions") or []:
        op = expr.get("operator", "")
        key = expr["key"]
        vals = tuple(str(v) for v in expr.get("values") or ())
        if op == "In":
            reqs.append(Requirement(key, "in", vals))
        elif op == "NotIn":
            reqs.append(Requirement(key, "notin", vals))
        elif op == "Exists":
            reqs.append(Requirement(key, "exists"))
        elif op == "DoesNotExist":
            reqs.append(Requirement(key, "!exists"))
        else:
            raise ValueError(f"unknown matchExpressions operator {op!r}")
    return LabelSelector(tuple(reqs))
