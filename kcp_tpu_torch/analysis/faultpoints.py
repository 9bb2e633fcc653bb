"""fault-point-registry: every KCP_FAULTS point is declared, spelled
identically at every site, and exercised by at least one test.

The fault framework (kcp_tpu_torch/faults.py) is string-keyed: a typo'd point
name at an injection site silently never fires, and a chaos schedule
naming a point nothing injects is a test asserting nothing. The registry
(``faults.POINTS``) is the single spelling authority; this checker
cross-references it against (a) every literal point passed to
``maybe_fail`` / ``should_drop`` / ``_inject`` in the codebase and (b)
the ``point:action`` specs appearing in tests — an injection point no
test ever fires is a degraded-mode path with no drill.
"""

from __future__ import annotations

import ast
import os
import re

from .base import Finding, RepoChecker, SourceFile

FAULT_CALLS = frozenset({"maybe_fail", "should_drop", "_inject",
                         "link_cut", "link_delay"})


def _declared_points(files: list[SourceFile]
                     ) -> tuple[dict[str, tuple[str, int]], str | None]:
    """POINTS registry entries -> (path, line); also the faults.py path."""
    declared: dict[str, tuple[str, int]] = {}
    faults_path: str | None = None
    for f in files:
        if not f.path.endswith("faults.py"):
            continue
        faults_path = f.path
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Assign):
                continue
            if not any(isinstance(t, ast.Name) and t.id == "POINTS"
                       for t in node.targets):
                continue
            for c in ast.walk(node.value):
                if isinstance(c, ast.Constant) and isinstance(c.value, str):
                    declared[c.value] = (f.path, c.lineno)
    return declared, faults_path


def _used_points(files: list[SourceFile]) -> dict[str, list[tuple[str, int]]]:
    used: dict[str, list[tuple[str, int]]] = {}
    for f in files:
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else "")
            if name not in FAULT_CALLS:
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                used.setdefault(arg.value, []).append((f.path, node.lineno))
    return used


def _test_specs(repo_root: str) -> str:
    chunks: list[str] = []
    tests = os.path.join(repo_root, "tests")
    if os.path.isdir(tests):
        for name in sorted(os.listdir(tests)):
            if name.endswith(".py"):
                try:
                    with open(os.path.join(tests, name),
                              encoding="utf-8") as fh:
                        chunks.append(fh.read())
                except OSError:
                    continue
    return "\n".join(chunks)


class FaultPointChecker(RepoChecker):
    name = "fault-point-registry"

    def check_repo(self, files: list[SourceFile],
                   repo_root: str) -> list[Finding]:
        findings: list[Finding] = []
        declared, faults_path = _declared_points(files)
        used = _used_points(files)
        if faults_path is None:
            return findings  # fixture runs without a faults module
        if not declared:
            findings.append(Finding(
                self.name, faults_path, 1,
                "faults.py declares no POINTS registry — every injection "
                "point must be declared in faults.POINTS"))
            return findings

        for point, sites in sorted(used.items()):
            if point not in declared:
                path, line = sites[0]
                findings.append(Finding(
                    self.name, path, line,
                    f"fault point {point!r} is used here but not declared "
                    f"in faults.POINTS (typo, or add it to the registry)"))

        test_text = _test_specs(repo_root)
        for point, (path, line) in sorted(declared.items()):
            if point not in used:
                findings.append(Finding(
                    self.name, path, line,
                    f"fault point {point!r} is declared but no code site "
                    f"injects it — dead registry entry"))
                continue
            if not re.search(
                    re.escape(point)
                    + r":(error|raise|drop|latency|poison_row)",
                    test_text):
                findings.append(Finding(
                    self.name, path, line,
                    f"fault point {point!r} is never exercised by any "
                    f"test (no '{point}:<action>' spec under tests/) — "
                    f"a degraded-mode path with no drill"))
        return findings
