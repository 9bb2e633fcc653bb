"""tracetool — pretty-print assembled traces and diff phase profiles.

Reads either a JSON file (the body of ``GET /debug/trace?id=`` /
``?slowest=N``, e.g. saved with curl) or fetches one live from a server
URL. On a router the endpoint scatter-gathers every shard's and
replica's span buffer, so the tree spans processes.

Usage::

    # pretty-print one trace (file or live endpoint)
    python -m kcp_tpu_torch.obs tree trace.json
    python -m kcp_tpu_torch.obs tree http://127.0.0.1:6443 --id <trace-id>
    python -m kcp_tpu_torch.obs tree http://127.0.0.1:6443 --slowest 3

    # the convergence phase breakdown of one trace
    python -m kcp_tpu_torch.obs profile trace.json

    # per-phase delta between two saved profiles (regression triage:
    # "convergence p99 regressed — which phase grew?")
    python -m kcp_tpu_torch.obs diff before.json after.json

The output is the same text, line for line, as the reference's
``scripts/tracetool.py`` prints for the same input.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import assemble


def _load(source: str, trace_id: str | None, slowest: int) -> dict:
    if source.startswith("http://") or source.startswith("https://"):
        from ..server.rest import RestClient

        q = f"id={trace_id}" if trace_id else f"slowest={slowest}"
        client = RestClient(source)
        try:
            return client._request("GET", f"/debug/trace?{q}") or {}
        finally:
            client.close()
    with open(source, encoding="utf-8") as fh:
        return json.load(fh)


def _span_lists(doc: dict) -> list[tuple[str, list[dict]]]:
    """(trace id, spans) groups from either endpoint shape."""
    if "spans" in doc:
        return [(doc.get("id", "?"), doc["spans"])]
    return [(t.get("id", "?"), t.get("spans", []))
            for t in doc.get("traces", [])]


def cmd_tree(args: argparse.Namespace) -> int:
    doc = _load(args.source, args.id, args.slowest)
    for partial in doc.get("partial") or []:
        print(f"# partial assembly: {partial}", file=sys.stderr)
    for tid, spans in _span_lists(doc):
        if not spans:
            print(f"trace {tid}: no spans buffered")
            continue
        print(f"trace {tid} ({len(spans)} spans):")
        print(assemble.render_tree(spans))
        prof = assemble.phase_profile(spans)
        if prof.get("phases"):
            print("  phases: " + json.dumps(prof))
        print()
    return 0


def cmd_profile(args: argparse.Namespace) -> int:
    doc = _load(args.source, args.id, args.slowest)
    groups = _span_lists(doc)
    if not groups:
        print("no traces", file=sys.stderr)
        return 1
    tid, spans = groups[0]
    prof = assemble.phase_profile(spans)
    prof["id"] = tid
    print(json.dumps(prof, indent=2))
    return 0


def cmd_diff(args: argparse.Namespace) -> int:
    with open(args.a, encoding="utf-8") as fh:
        a = json.load(fh)
    with open(args.b, encoding="utf-8") as fh:
        b = json.load(fh)
    rows = assemble.diff_profiles(a, b)
    if not rows:
        print("no comparable phases", file=sys.stderr)
        return 1
    print(f"{'phase':<12} {'a (ms)':>10} {'b (ms)':>10} {'delta (ms)':>12}")
    for r in rows:
        fa = "-" if r["a"] is None else f"{r['a'] * 1000:.3f}"
        fb = "-" if r["b"] is None else f"{r['b'] * 1000:.3f}"
        print(f"{r['phase']:<12} {fa:>10} {fb:>10} "
              f"{r['delta'] * 1000:>+12.3f}")
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m kcp_tpu_torch.obs", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in (("tree", cmd_tree), ("profile", cmd_profile)):
        sp = sub.add_parser(name)
        sp.add_argument("source", help="JSON file or server base URL")
        sp.add_argument("--id", default=None, help="trace id (URL mode)")
        sp.add_argument("--slowest", type=int, default=3)
        sp.set_defaults(fn=fn)
    sp = sub.add_parser("diff")
    sp.add_argument("a", help="baseline phase-profile JSON")
    sp.add_argument("b", help="comparison phase-profile JSON")
    sp.set_defaults(fn=cmd_diff)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
