"""metrics-doc-drift: code-registered metrics <-> docs/operations.md.

Operators alert on what the runbook documents; a metric registered in
code but absent from docs/operations.md is invisible telemetry, and a
documented metric nothing registers is a runbook that lies. This checker
extracts every ``REGISTRY.counter/gauge/histogram`` registration (literal
names exactly; f-string names as globs, e.g. ``fused_{name}_seconds`` ->
``fused_*_seconds``) plus ``span("x")`` sites (which register
``x_seconds``), and reconciles both directions against the backticked
tokens of docs/operations.md — ``<name>``/``*`` in doc tokens match glob
segments, so ``workqueue_depth_<name>`` documents the
``workqueue_depth_{queue}`` family.

Trace spans get the same discipline: every literal name at an
``obs.span(...)`` / ``obs.record_span(...)`` call site, and every phase
literal at an ``obs.phase(...)`` site (which records ``conv.<phase>``),
must appear as a backticked token inside the trace-span table region of
docs/operations.md (delimited by ``<!-- trace-spans:begin -->`` /
``<!-- trace-spans:end -->``), and every dotted token in that region
must be emitted by code — both directions, so the phase table an
operator reads while chasing a convergence regression can never drift
from what the tracer actually records.
"""

from __future__ import annotations

import ast
import fnmatch
import os
import re

from .base import Finding, RepoChecker, SourceFile, attr_chain

DOCS_REL = os.path.join("docs", "operations.md")

#: a doc token with one of these suffixes claims to be a metric name
METRIC_SUFFIXES = ("_total", "_seconds", "_bytes", "_size", "_depth",
                   "_rows", "_buckets", "_segments")

REGISTRY_METHODS = frozenset({"counter", "gauge", "histogram"})


def _name_args(node: ast.expr) -> tuple[list[str], list[str]]:
    """(literals, globs) a metric-name argument can evaluate to —
    conditional expressions contribute every literal branch."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value], []
    if isinstance(node, ast.IfExp):
        lit_a, glob_a = _name_args(node.body)
        lit_b, glob_b = _name_args(node.orelse)
        return lit_a + lit_b, glob_a + glob_b
    if isinstance(node, ast.JoinedStr):
        parts: list[str] = []
        for v in node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            else:
                parts.append("*")
        return [], ["".join(parts)]
    return [], []


def collect_code_metrics(files: list[SourceFile]
                         ) -> tuple[dict[str, tuple[str, int]],
                                    dict[str, tuple[str, int]]]:
    """(literal name -> site, glob -> site) across the file set."""
    literals: dict[str, tuple[str, int]] = {}
    globs: dict[str, tuple[str, int]] = {}
    for f in files:
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in REGISTRY_METHODS:
                recv = attr_chain(fn.value).lower()
                if not recv.endswith("registry"):
                    continue
                lits, gls = _name_args(node.args[0])
            elif isinstance(fn, ast.Name) and fn.id == "span":
                lits, gls = _name_args(node.args[0])
                lits = [s + "_seconds" for s in lits]
                gls = [g + "_seconds" for g in gls]
            else:
                continue
            for lit in lits:
                literals.setdefault(lit, (f.path, node.lineno))
            for glob in gls:
                if glob != "*":
                    globs.setdefault(glob, (f.path, node.lineno))
    return literals, globs


def collect_doc_tokens(docs_path: str) -> dict[str, int]:
    """Backticked identifier-ish tokens -> first line number."""
    tokens: dict[str, int] = {}
    try:
        with open(docs_path, encoding="utf-8") as fh:
            lines = fh.readlines()
    except OSError:
        return tokens
    for lineno, line in enumerate(lines, start=1):
        for span_text in re.findall(r"`([^`]+)`", line):
            # only whole-span tokens count as metric claims: a token
            # buried in a path/expression (`ops/foo.max_block_rows`,
            # `queues × queue_depth`) is prose, not a metric name
            tok = span_text.strip()
            if re.fullmatch(r"[a-z][a-z0-9_<>*]+", tok) and "_" in tok:
                tokens.setdefault(tok, lineno)
    return tokens


SPAN_BEGIN = "<!-- trace-spans:begin -->"
SPAN_END = "<!-- trace-spans:end -->"

#: obs call sites whose first literal argument names a span (phase
#: literals record as ``conv.<phase>``)
SPAN_METHODS = frozenset({"span", "record_span"})


def collect_code_spans(files: list[SourceFile]) -> dict[str, tuple[str, int]]:
    """Span name -> first call site, from literal ``obs.span``/
    ``obs.record_span``/``obs.phase`` arguments across the file set."""
    spans: dict[str, tuple[str, int]] = {}
    for f in files:
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fn = node.func
            if not isinstance(fn, ast.Attribute):
                continue
            if fn.attr not in SPAN_METHODS and fn.attr != "phase":
                continue
            recv = attr_chain(fn.value)
            if not recv.endswith("obs"):
                continue
            arg = node.args[0]
            if not (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                continue
            name = arg.value if fn.attr != "phase" else "conv." + arg.value
            spans.setdefault(name, (f.path, node.lineno))
    return spans


def collect_doc_spans(docs_path: str) -> dict[str, int]:
    """Backticked dotted tokens inside the trace-span table region."""
    tokens: dict[str, int] = {}
    try:
        with open(docs_path, encoding="utf-8") as fh:
            lines = fh.readlines()
    except OSError:
        return tokens
    inside = False
    for lineno, line in enumerate(lines, start=1):
        if SPAN_BEGIN in line:
            inside = True
            continue
        if SPAN_END in line:
            inside = False
            continue
        if not inside:
            continue
        for span_text in re.findall(r"`([^`]+)`", line):
            tok = span_text.strip()
            if re.fullmatch(r"[a-z][a-z0-9_]*(\.[a-z0-9_<>]+)+", tok):
                tokens.setdefault(tok, lineno)
    return tokens


def _doc_token_concrete(tok: str) -> str:
    """A doc token with placeholders, concretized for glob matching:
    ``workqueue_depth_<name>`` -> ``workqueue_depth_x``."""
    return re.sub(r"(<[^>]*>|\*)", "x", tok)


class MetricsDocChecker(RepoChecker):
    name = "metrics-doc-drift"

    def check_repo(self, files: list[SourceFile],
                   repo_root: str) -> list[Finding]:
        findings: list[Finding] = []
        literals, globs = collect_code_metrics(files)
        docs_path = os.path.join(repo_root, DOCS_REL)
        tokens = collect_doc_tokens(docs_path)
        if not tokens and not literals:
            return self._check_spans(files, docs_path)
        concrete = {t: _doc_token_concrete(t) for t in tokens}

        # code -> docs: every registered metric is documented
        for name, (path, line) in sorted(literals.items()):
            if name not in tokens:
                findings.append(Finding(
                    self.name, path, line,
                    f"metric {name!r} is registered here but absent from "
                    f"{DOCS_REL} — document it (observability table or "
                    f"runbook)"))
        for glob, (path, line) in sorted(globs.items()):
            if not any(fnmatch.fnmatchcase(c, glob)
                       for c in concrete.values()):
                findings.append(Finding(
                    self.name, path, line,
                    f"dynamic metric family {glob!r} is registered here "
                    f"but no token in {DOCS_REL} documents it (use a "
                    f"<name> placeholder form)"))

        # docs -> code: every metric-looking doc token is registered
        for tok, lineno in sorted(tokens.items()):
            plain = "<" not in tok and "*" not in tok
            if plain and not tok.endswith(METRIC_SUFFIXES) \
                    and tok not in literals:
                continue  # not claiming to be a metric
            if plain and tok in literals:
                continue
            c = concrete[tok]
            if any(fnmatch.fnmatchcase(c, g) for g in globs):
                continue
            if not plain:
                # placeholder token: may also summarize several literals
                pat = fnmatch.translate(_placeholder_glob(tok))
                if any(re.fullmatch(pat, lit) for lit in literals):
                    continue
            if plain and any(fnmatch.fnmatchcase(tok, g) for g in globs):
                continue
            findings.append(Finding(
                self.name, DOCS_REL, lineno,
                f"docs/operations.md documents metric {tok!r} but nothing "
                f"in the codebase registers it — stale docs or a renamed "
                f"metric"))

        findings.extend(self._check_spans(files, docs_path))
        return findings

    def _check_spans(self, files: list[SourceFile],
                     docs_path: str) -> list[Finding]:
        """Trace spans <-> the docs trace-span table, both directions."""
        findings: list[Finding] = []
        code_spans = collect_code_spans(files)
        doc_spans = collect_doc_spans(docs_path)
        for name, (path, line) in sorted(code_spans.items()):
            if name not in doc_spans:
                findings.append(Finding(
                    self.name, path, line,
                    f"trace span {name!r} is recorded here but absent "
                    f"from the trace-span table in {DOCS_REL} (between "
                    f"the trace-spans markers) — document it"))
        for tok, lineno in sorted(doc_spans.items()):
            if tok not in code_spans:
                findings.append(Finding(
                    self.name, DOCS_REL, lineno,
                    f"the trace-span table documents {tok!r} but no "
                    f"obs.span/obs.phase/obs.record_span call site "
                    f"records it — stale docs or a renamed span"))
        return findings


def _placeholder_glob(tok: str) -> str:
    return re.sub(r"(<[^>]*>|\*)", "*", tok)
