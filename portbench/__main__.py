"""The benchmark of the PyTorch and CUDA port (``kcp_tpu_torch``).

One run of one cell, from the root of a checkout, on a machine with the
cards the cell asks for::

    python3 -m portbench --workload fleet-1m.trickle64 --seed 1234 --seconds 10 --trace 0

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``, each number compared with its limit. The
same checks are the last lines of standard error. Without a CUDA card, with
fewer cards than the cell asks for, without the port beside it, or with JAX
or the JAX package loaded once the window has closed, the run exits with a
code other than 0 and prints no result.

Everything is found by name from ``BENCHMARK.json``, so a later change adds
a configuration, a traffic mix or a metric by adding files and entries and
edits nothing here:

- a configuration is ``portbench/configs/<name>.json`` (the entry's
  ``file``): ``rows`` (the bucket's rows), ``objects`` (those live at the
  start), ``slots``, ``status_slots``, ``pipeline``, ``batch_window_s`` and
  ``patch_capacity``, with its source, what was reduced and what was
  assumed;
- a traffic mix is ``portbench/traffic/<name>.json`` (the workload's
  ``traffic``): ``ops_per_tick`` (one-slot and few-slot spec edits, status
  edits, creates or deletes), ``few_slots``, ``status_edit_slots`` and
  ``warmup_ticks``, read by the one generator, ``traffic.py``;
- a metric, end-to-end or per-layer, is ``portbench/metrics/<name>.py``
  (the metric's ``name``, dots and all) with ``read(ctx)``, which returns
  the value or None where the run has nothing to read; ``cell.Context``
  holds what a reader may use.

The benchmark's own tests run on the CPU, at a tiny size, with the port's
plain kernel::

    python3 -m pytest -p no:cacheprovider portbench/tests

and those that need the card (marker ``cuda``), on a machine with one::

    python3 -m pytest -p no:cacheprovider -m cuda portbench/tests

``python3 -m portbench.control`` runs a cell on the card with the control's
patch sets judged in the program's place (``control.py``); each such run
must read ``correct: false``. No run of the benchmark runs it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

#: top-level module names that may not be loaded when the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "kcp_tpu")


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def cache_env(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own libraries already build under ``build/kcp_tpu_torch``)."""
    base = os.path.join(root, "build", "portbench")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import spec

    cell = spec.load_cell(args.workload)
    cache_env(spec.ROOT)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), "
              f"{have} visible", file=sys.stderr)
        return 2
    try:
        import kcp_tpu_torch.syncer.core  # noqa: F401
    except ImportError as err:
        print(f"portbench: the port cannot be imported: {err}", file=sys.stderr)
        return 2
    from .cell import run_cell

    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: JAX or the JAX package is loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    import json

    print("\n".join(lines), file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
