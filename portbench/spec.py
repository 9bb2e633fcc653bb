"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, each configuration's file, each traffic mix's file under
``portbench/traffic/`` and each metric's reader under
``portbench/metrics/``."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

#: the checkout's root: the directory that holds ``portbench/``
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict  # the configuration's file, as run
    traffic: dict  # the traffic mix's file
    end_to_end: list  # the cell's end-to-end metric entries
    per_layer: list  # the cell's per-layer metric entries
    root: str


def _read_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The workload ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {', '.join(sorted(work))})")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_read_json(os.path.join(root, cfg["file"])),
        traffic=_read_json(os.path.join(root, "portbench", "traffic",
                                        f"{w['traffic']}.json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        root=root)


def reader(metric: str, root: str = ROOT):
    """The ``read(ctx)`` function of ``portbench/metrics/<metric>.py``."""
    path = os.path.join(root, "portbench", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"no reader for metric {metric!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
