"""Lint orchestration: file discovery, checker execution, waivers,
reporting. ``python -m kcp_tpu_torch.analysis`` is the CLI face of
this module."""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, field

from .asyncdiscipline import AsyncDisciplineChecker
from .base import FileChecker, Finding, RepoChecker, SourceFile, parse_waivers
from .cow import CowChecker
from .faultpoints import FaultPointChecker
from .frozenbytes import FrozenBytesChecker
from .lockorder import LockOrderChecker
from .metricsdoc import MetricsDocChecker

#: the linted surface: the port's package (its bench harness included)
#: and the card smoke script. Tests are deliberately excluded — fixtures
#: violate contracts on purpose — but repo-level checkers still read
#: tests/ for evidence (fault drills).
DEFAULT_TARGETS = ("kcp_tpu_torch", "chip_smoke.py")

ALL_CHECKERS: tuple[FileChecker | RepoChecker, ...] = (
    CowChecker(),
    FrozenBytesChecker(),
    AsyncDisciplineChecker(),
    LockOrderChecker(),
    FaultPointChecker(),
    MetricsDocChecker(),
)

RULES = tuple(c.name for c in ALL_CHECKERS) + ("waiver-syntax",)


@dataclass
class LintReport:
    findings: list[Finding] = field(default_factory=list)  # active
    waived: list[Finding] = field(default_factory=list)
    unused_waivers: list[tuple[str, int, str]] = field(default_factory=list)
    files_checked: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict[str, object]:
        by_rule: dict[str, int] = {}
        for fi in self.findings:
            by_rule[fi.rule] = by_rule.get(fi.rule, 0) + 1
        return {
            "ok": self.ok,
            "files_checked": self.files_checked,
            "findings": [fi.to_dict() for fi in self.findings],
            "waived": [fi.to_dict() for fi in self.waived],
            "unused_waivers": [
                {"path": p, "line": ln, "rules": r}
                for p, ln, r in self.unused_waivers],
            "summary": {
                "active": len(self.findings),
                "waived": len(self.waived),
                "by_rule": by_rule,
            },
        }

    def render(self) -> str:
        out: list[str] = []
        for fi in self.findings:
            out.append(fi.render())
        for fi in self.waived:
            out.append(fi.render())
        for path, line, rules in self.unused_waivers:
            out.append(f"{path}:{line}: unused waiver for {rules} "
                       f"(nothing to silence — remove it)")
        out.append(
            f"kcp-lint: {len(self.findings)} finding(s), "
            f"{len(self.waived)} waived, {self.files_checked} files")
        return "\n".join(out)


def discover(repo_root: str, targets: tuple[str, ...] = DEFAULT_TARGETS
             ) -> list[str]:
    paths: list[str] = []
    for target in targets:
        abs_t = os.path.join(repo_root, target)
        if os.path.isfile(abs_t):
            paths.append(target)
        elif os.path.isdir(abs_t):
            for dirpath, dirnames, filenames in os.walk(abs_t):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__",)]
                for name in sorted(filenames):
                    if name.endswith(".py"):
                        paths.append(os.path.relpath(
                            os.path.join(dirpath, name), repo_root))
    return sorted(set(paths))


def load_files(repo_root: str, paths: list[str]
               ) -> tuple[list[SourceFile], list[Finding]]:
    files: list[SourceFile] = []
    findings: list[Finding] = []
    for rel in paths:
        try:
            with open(os.path.join(repo_root, rel), encoding="utf-8") as fh:
                src = fh.read()
        except OSError as err:
            findings.append(Finding("waiver-syntax", rel, 0,
                                    f"unreadable file: {err}"))
            continue
        try:
            tree = ast.parse(src, filename=rel)
        except SyntaxError as err:
            findings.append(Finding(
                "waiver-syntax", rel, err.lineno or 0,
                f"syntax error: {err.msg}"))
            continue
        waivers, wfindings = parse_waivers(src, rel)
        findings.extend(wfindings)
        files.append(SourceFile(rel, src, tree, waivers))
    return files, findings


def run_lint(repo_root: str,
             rules: tuple[str, ...] | None = None,
             targets: tuple[str, ...] = DEFAULT_TARGETS) -> LintReport:
    report = LintReport()
    files, raw = load_files(repo_root, discover(repo_root, targets))
    report.files_checked = len(files)
    by_path = {f.path: f for f in files}

    for checker in ALL_CHECKERS:
        if rules is not None and checker.name not in rules:
            continue
        if isinstance(checker, FileChecker):
            for f in files:
                raw.extend(checker.check(f))
        else:
            raw.extend(checker.check_repo(files, repo_root))

    for fi in raw:
        if rules is not None and fi.rule not in rules \
                and fi.rule != "waiver-syntax":
            continue
        f = by_path.get(fi.path)
        waiver = f.waivers.get(fi.line) if f is not None else None
        if waiver is not None and fi.rule in waiver.rules \
                and fi.rule != "waiver-syntax":
            waiver.used = True
            fi.waived = True
            fi.justification = waiver.justification
            report.waived.append(fi)
        else:
            report.findings.append(fi)

    for f in files:
        for waiver in f.waivers.values():
            if not waiver.used:
                report.unused_waivers.append(
                    (f.path, waiver.line, ",".join(sorted(waiver.rules))))

    report.findings.sort(key=lambda fi: (fi.path, fi.line, fi.rule))
    report.waived.sort(key=lambda fi: (fi.path, fi.line, fi.rule))
    return report


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m kcp_tpu_torch.analysis",
        description="contract-aware static analysis for the port "
                    "(CoW snapshots, encode-once bytes, async/lock "
                    "discipline, fault points, metrics docs)")
    parser.add_argument("--root", default=None,
                        help="repo root (default: auto from this file)")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule subset "
                             f"(all: {', '.join(RULES)})")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("targets", nargs="*",
                        help=f"files/dirs to lint (default: "
                             f"{' '.join(DEFAULT_TARGETS)})")
    args = parser.parse_args(argv)

    root = args.root or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    rules = tuple(r.strip() for r in args.rules.split(",")) \
        if args.rules else None
    targets = tuple(args.targets) if args.targets else DEFAULT_TARGETS
    report = run_lint(root, rules=rules, targets=targets)
    if args.format == "json":
        print(json.dumps(report.to_dict(), indent=2))
    else:
        print(report.render())
    return 0 if report.ok else 1
