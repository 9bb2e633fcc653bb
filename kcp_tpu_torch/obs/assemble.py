"""Trace-tree assembly and convergence phase profiles.

Consumers of the per-process span buffers (:mod:`.trace`): the router's
``/debug/trace`` scatter-gather, ``scripts/tracetool.py``, the scenario
engine's scorecard attachments, and the ``bench.py --trace``
sum-reconciliation gate all share these pure functions.

A *trace tree* is just a list of span dicts (possibly from several
processes) sharing a trace id; :func:`build_tree` nests them by parent
span id (orphans — spans whose parent lives in an unscraped process —
become roots, honestly). A *phase profile* reduces a convergence trace
to ``{phase: seconds}`` over the canonical :data:`~.trace.PHASES`
timeline, deriving the two gap phases (``propagate``, ``observe``) from
adjacent span boundaries so the profile always sums to the end-to-end
wall time.
"""

from __future__ import annotations

from .trace import PHASES


def build_tree(spans: list[dict]) -> list[dict]:
    """Nest spans by parent id: returns root nodes, each a copy of the
    span dict with a ``children`` list, siblings ordered by t0."""
    nodes = {s["span"]: dict(s, children=[]) for s in spans}
    roots: list[dict] = []
    for node in nodes.values():
        parent = nodes.get(node.get("parent") or "")
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    def _sort(ns: list[dict]) -> None:
        ns.sort(key=lambda n: n["t0"])
        for n in ns:
            _sort(n["children"])
    _sort(roots)
    return roots


def render_tree(spans: list[dict]) -> str:
    """Human-readable indented tree (tracetool's output)."""
    lines: list[str] = []

    def _walk(node: dict, depth: int) -> None:
        attrs = node.get("attrs") or {}
        extra = " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
        lines.append("%s%-24s %8.3fms  [%s]%s" % (
            "  " * depth, node["name"], node["dur"] * 1000.0,
            node.get("proc", "?"), ("  " + extra) if extra else ""))
        for c in node["children"]:
            _walk(c, depth + 1)

    for root in build_tree(spans):
        _walk(root, 0)
    return "\n".join(lines)


def merge_fragments(span_lists: list[list[dict]],
                    rv: str | int | None = None) -> list[dict]:
    """Union spans from several buffers into one logical trace. When
    ``rv`` is given, convergence fragments minted under a *different*
    trace id (cross-process engines, see :func:`~.trace.conv_begin`)
    are included if any of their spans carries a matching ``rv`` attr —
    the out-of-band join that keeps wire bytes untouched."""
    out: list[dict] = []
    seen: set[tuple[str, str]] = set()
    want_rv = str(rv) if rv is not None else None
    for spans in span_lists:
        frag_ok = want_rv is not None and any(
            str((s.get("attrs") or {}).get("rv", "")) == want_rv
            for s in spans)
        for s in spans:
            if want_rv is not None and not frag_ok:
                continue
            key = (s["trace"], s["span"])
            if key in seen:
                continue
            seen.add(key)
            out.append(s)
    out.sort(key=lambda s: s["t0"])
    return out


def phase_profile(spans: list[dict]) -> dict:
    """Reduce a convergence trace to ``{phase: seconds}`` plus
    ``e2e``/``sum``/``sum_ok``. Measured phases come from ``conv.<p>``
    spans; ``propagate`` and ``observe`` are derived from the gaps
    between adjacent measured boundaries (and the ``conv.e2e`` root), so
    the profile telescopes: sum(phases) == e2e whenever the write,
    engine, and e2e spans are all present (``sum_ok`` = within 5%)."""
    by_phase: dict[str, dict] = {}
    e2e = None
    for s in spans:
        name = s["name"]
        if name == "conv.e2e":
            e2e = s
        elif name.startswith("conv."):
            p = name[len("conv."):]
            # keep the earliest occurrence per phase (a retried apply
            # can re-record patch; the first is the causal one)
            if p not in by_phase or s["t0"] < by_phase[p]["t0"]:
                by_phase[p] = s
    prof: dict[str, float] = {}
    for p in PHASES:
        s = by_phase.get(p)
        if s is not None:
            prof[p] = s["dur"]
    # derived gap phases, from shared boundaries
    w, st = by_phase.get("write"), by_phase.get("stage")
    if "propagate" not in prof and w is not None and st is not None:
        prof["propagate"] = max(0.0, st["t0"] - (w["t0"] + w["dur"]))
    up = by_phase.get("upstatus")
    if "observe" not in prof and e2e is not None and up is not None:
        prof["observe"] = max(
            0.0, (e2e["t0"] + e2e["dur"]) - (up["t0"] + up["dur"]))
    out: dict = {"phases": {p: round(v, 6) for p, v in prof.items()}}
    total = sum(prof.values())
    out["sum"] = round(total, 6)
    if e2e is not None:
        out["e2e"] = e2e["dur"]
        out["sum_ok"] = (e2e["dur"] > 0
                         and abs(total - e2e["dur"]) / e2e["dur"] <= 0.05)
    return out


def diff_profiles(a: dict, b: dict) -> list[dict]:
    """Per-phase deltas between two phase profiles (tracetool diff):
    rows of {phase, a, b, delta}, ordered by the canonical timeline."""
    pa, pb = a.get("phases", a), b.get("phases", b)
    rows = []
    for p in PHASES:
        va, vb = pa.get(p), pb.get(p)
        if va is None and vb is None:
            continue
        rows.append({"phase": p, "a": va, "b": vb,
                     "delta": round((vb or 0.0) - (va or 0.0), 6)})
    return rows


def summarize_trace(spans: list[dict], trace_id: str | None = None) -> dict:
    """A compact scorecard attachment for one assembled trace."""
    if not spans:
        return {}
    t0 = min(s["t0"] for s in spans)
    t1 = max(s["t0"] + s["dur"] for s in spans)
    slowest = max(spans, key=lambda s: s["dur"])
    out = {
        "id": trace_id or spans[0]["trace"],
        "dur_ms": round((t1 - t0) * 1000.0, 3),
        "spans": len(spans),
        "procs": sorted({s.get("proc", "?") for s in spans}),
        "slowest_span": {"name": slowest["name"],
                         "dur_ms": round(slowest["dur"] * 1000.0, 3)},
        "names": sorted({s["name"] for s in spans}),
    }
    prof = phase_profile(spans)
    if prof.get("phases"):
        out["profile"] = prof
    return out
