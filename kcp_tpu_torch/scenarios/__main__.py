"""Run the scenario harness through the port and emit one JSON scorecard.

Usage:
    python -m kcp_tpu_torch.scenarios list
    python -m kcp_tpu_torch.scenarios run --all --seed 42 [--scale 1.0]
        [--out SCENARIOS.json] [--device cuda|cpu]
    python -m kcp_tpu_torch.scenarios run --scenarios crud-churn,kill-primary \
        --seed 7 --scale 0.3 --device cpu

Every run is seeded and replayable: the scorecard carries each
scenario's schedule hash — a second run with the same seed reproduces
the same op/fault schedule bit for bit. Exit status 1 when any scenario
misses a declared SLO, 2 when the device cannot be had.

``--scale`` shrinks tenant counts and op volumes for smokes; SLO
targets never scale. ``--device`` (env ``KCP_DEVICE``, else the CUDA
card) is where the controllers and the engine-side solver run. Without
a card the default is an error before any scenario starts, never a run
on the CPU; on the card the kernel is built and the card initialised
first, so no scenario's window counts the build.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

from ..cli import add_device_argument


def _prepare_device(device: str | None) -> str:
    """Resolve the run's device (raises without a card unless the CPU is
    asked for); on a card, build the kernel and initialise the card."""
    import torch

    from ..utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..ops import cuda_kernels

        cuda_kernels.build()
        torch.empty(1, device=dev)
        torch.cuda.synchronize(dev)
    return str(dev)


def main(argv=None) -> int:
    try:
        # watcher-scale scenarios hold one fd per live stream: lift the
        # soft nofile limit to the hard cap before the storm starts
        import resource

        _soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    except (ImportError, ValueError, OSError):
        pass
    p = argparse.ArgumentParser(prog="python -m kcp_tpu_torch.scenarios",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)
    sub.add_parser("list", help="list the named scenarios")
    run = sub.add_parser("run", help="run scenarios, emit a scorecard")
    run.add_argument("--all", action="store_true",
                     help="run every scenario in the catalog")
    run.add_argument("--scenarios", default="",
                     help="comma-separated scenario names")
    run.add_argument("--seed", type=int, default=42)
    run.add_argument("--scale", type=float, default=1.0,
                     help="tenant/op scale factor (SLO targets do NOT "
                          "scale)")
    run.add_argument("--out", default="",
                     help="scorecard JSON path (default: stdout only)")
    run.add_argument("--workdir", default="",
                     help="server root dirs (default: a fresh tempdir)")
    add_device_argument(run)
    args = p.parse_args(argv)

    from . import SCENARIOS, run_scenario

    if args.command == "list":
        for name, spec in SCENARIOS.items():
            print(f"{name:18s} [{spec.topology}] {spec.description}")
        return 0

    if args.all:
        names = list(SCENARIOS)
    else:
        names = [n for n in args.scenarios.split(",") if n]
    if not names:
        p.error("run needs --all or --scenarios a,b,c")
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        p.error(f"unknown scenario(s) {unknown}; "
                f"known: {sorted(SCENARIOS)}")
    try:
        device = _prepare_device(args.device)
    except RuntimeError as err:
        print(f"scenarios: {err}", file=sys.stderr)
        return 2

    workdir = args.workdir or tempfile.mkdtemp(prefix="kcp-scenarios-")
    t0 = time.time()
    results = []
    for name in names:
        print(f"== scenario: {name} (seed={args.seed} "
              f"scale={args.scale} device={device})", flush=True)
        r = run_scenario(SCENARIOS[name], seed=args.seed,
                         scale=args.scale, workdir=workdir, device=device)
        results.append(r)
        verdict = "PASS" if r["passed"] else "FAIL"
        print(f"   {verdict} in {r.get('measurements', {}).get('duration_s', '?')}s "
              f"schedule={r['schedule']['hash']}", flush=True)
        for row in r["slos"]:
            mark = "ok " if row["passed"] else "MISS"
            print(f"   [{mark}] {row['name']}: {row['metric']} "
                  f"{row['op']} {row['target']} "
                  f"(observed {row['observed']})", flush=True)
        if r.get("drain_bypassed"):
            print(f"   drain bypassed (kill): {r['drain_bypassed']}",
                  flush=True)

    scorecard = {
        "kind": "ScenarioScorecard",
        "seed": args.seed,
        "scale": args.scale,
        "duration_s": round(time.time() - t0, 2),
        "passed": all(r["passed"] for r in results),
        "scenarios": results,
    }
    out = json.dumps(scorecard, indent=2, sort_keys=False)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(out + "\n")
        print(f"scorecard written to {args.out}")
    print(json.dumps({"passed": scorecard["passed"],
                      "scenarios": {r["name"]: r["passed"]
                                    for r in results}}))
    return 0 if scorecard["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
