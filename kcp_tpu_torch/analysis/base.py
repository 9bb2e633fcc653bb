"""Shared lint infrastructure: findings, waivers, checker protocol.

The analysis package is the ``go vet`` of this codebase: each checker
mechanically enforces one *cross-layer contract* that the runtime can
only catch after the damage is done (a mutated CoW snapshot corrupts
every informer cache sharing it; a blocking call inside ``async def``
stalls every watch stream on the loop). Checkers are pure-AST — no
imports of the checked code, no jax, safe to run anywhere python runs.

Waiver grammar (the only sanctioned way to silence a finding): append a
comment of the form ``kcp-lint: disable=cow-mutation -- <why this site
is a legitimate write boundary>`` to the flagged line. A waiver names
the rule(s) it silences and MUST carry a justification after ``--``; a
bare waiver is itself a finding (``waiver-syntax``) so exemptions stay
auditable. Waivers apply to findings anchored on their own line.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field

__all__ = [
    "Finding",
    "Waiver",
    "FileChecker",
    "RepoChecker",
    "SourceFile",
    "parse_waivers",
    "attr_chain",
    "call_name",
    "WAIVER_RE",
]

WAIVER_RE = re.compile(
    r"#\s*kcp-lint:\s*disable=([a-z0-9_,\- ]+?)\s*(?:--\s*(.*))?$"
)

#: a line only *claims* to be a waiver when the comment marker and the
#: disable keyword are both present — prose merely mentioning the tool
#: (docstrings, the regex above) must not parse as a malformed waiver
_WAIVER_CLAIM_RE = re.compile(r"#\s*kcp-lint\b")


@dataclass
class Finding:
    """One contract violation at one source location."""

    rule: str
    path: str
    line: int
    message: str
    waived: bool = False
    justification: str = ""

    def to_dict(self) -> dict[str, object]:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "waived": self.waived,
            "justification": self.justification,
        }

    def render(self) -> str:
        tag = " [waived]" if self.waived else ""
        return f"{self.path}:{self.line}: {self.rule}: {self.message}{tag}"


@dataclass
class Waiver:
    line: int
    rules: frozenset[str]
    justification: str
    used: bool = False


@dataclass
class SourceFile:
    """A parsed python file: path (repo-relative), source, tree, waivers."""

    path: str
    source: str
    tree: ast.Module
    waivers: dict[int, Waiver] = field(default_factory=dict)

    @property
    def lines(self) -> list[str]:
        return self.source.splitlines()


def parse_waivers(source: str, path: str) -> tuple[dict[int, Waiver], list[Finding]]:
    """Extract per-line waivers; malformed ones become findings."""
    waivers: dict[int, Waiver] = {}
    findings: list[Finding] = []
    for lineno, line in enumerate(source.splitlines(), start=1):
        if "kcp-lint" not in line or _WAIVER_CLAIM_RE.search(line) is None:
            continue
        m = WAIVER_RE.search(line)
        if m is None:
            findings.append(Finding(
                "waiver-syntax", path, lineno,
                "malformed waiver comment (expected "
                "'kcp-lint: disable=<rule>[,<rule>] -- <justification>')"))
            continue
        rules = frozenset(
            r.strip() for r in m.group(1).split(",") if r.strip())
        justification = (m.group(2) or "").strip()
        if not rules:
            findings.append(Finding(
                "waiver-syntax", path, lineno,
                "waiver names no rules"))
            continue
        if not justification:
            findings.append(Finding(
                "waiver-syntax", path, lineno,
                "waiver has no justification (add '-- <why this site is "
                "a legitimate exemption>')"))
            continue
        waivers[lineno] = Waiver(lineno, rules, justification)
    return waivers, findings


def attr_chain(node: ast.AST) -> str:
    """Dotted name of an attribute/name chain: ``self.store.list`` ->
    "self.store.list"; non-name bases contribute ``?`` (calls,
    subscripts), so ``self.stores[i].list`` -> "?.list"."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    else:
        parts.append("?")
    return ".".join(reversed(parts))


def expr_text(node: ast.AST) -> str:
    """Human-readable source text of an expression for finding messages
    (matching logic keeps using :func:`attr_chain`)."""
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - unparse covers all exprs
        return attr_chain(node)


def call_name(call: ast.Call) -> str:
    """Terminal callable name: ``copy.deepcopy(x)`` -> "deepcopy",
    ``store.get_snapshot(...)`` -> "get_snapshot", ``open(...)`` ->
    "open"."""
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


class FileChecker:
    """A checker that inspects one file at a time."""

    name = "file-checker"

    def check(self, f: SourceFile) -> list[Finding]:  # pragma: no cover
        raise NotImplementedError


class RepoChecker:
    """A checker needing the whole file set (graphs, registries, docs)."""

    name = "repo-checker"

    def check_repo(self, files: list[SourceFile],
                   repo_root: str) -> list[Finding]:  # pragma: no cover
        raise NotImplementedError
