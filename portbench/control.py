"""The control's readings, on the card, at a cell's own size and load: one
whole run of the cell per seed, in one process, judged with the control's
patch sets (the reference without its status lane, ``reference.replay``
with ``status=False``) in the program's place, through the same
``run_cell`` and ``reference.judge`` as every run. Each must read
``correct: false``. No run of the benchmark runs this::

    python3 -m portbench.control --workload fleet-1m.trickle64 --seeds 11,12,13 --seconds 51

One JSON line per seed: the result's ``correct`` and ``checks``."""

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from . import spec
    from .__main__ import cache_env

    cell = spec.load_cell(args.workload)
    cache_env(spec.ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench.control: {args.workload} needs {cell.chips} CUDA card(s)",
              file=sys.stderr)
        return 2
    from .cell import run_cell

    for seed in (int(s) for s in args.seeds.split(",")):
        result, _ = run_cell(cell, seed, args.seconds, False, time.perf_counter(),
                             control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": result["correct"], "checks": result["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
