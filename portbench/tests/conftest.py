"""Fixtures of the benchmark's own tests: a copy of the benchmark in a
temporary directory, with tiny cells added as data files only."""

import json
import os
import shutil

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (CUDA kernels have no CPU mode); "
        "skipped without one")


class BenchCopy:
    """``BENCHMARK.json`` and ``portbench/`` copied under ``root``."""

    def __init__(self, root: str):
        self.root = root
        shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
        shutil.copytree(os.path.join(ROOT, "portbench"), os.path.join(root, "portbench"),
                        ignore=shutil.ignore_patterns("__pycache__", "tests"))

    def bench(self) -> dict:
        with open(os.path.join(self.root, "BENCHMARK.json"), encoding="utf-8") as f:
            return json.load(f)

    def write(self, rel: str, obj) -> None:
        path = os.path.join(self.root, rel)
        with open(path, "w", encoding="utf-8") as f:
            if isinstance(obj, str):
                f.write(obj)
            else:
                json.dump(obj, f, indent=1)

    def add_cell(self, name: str, rows: int = 4096, traffic: str | None = None,
                 base: str = "shard-100k") -> str:
        """A configuration of ``rows`` rows cut from ``base``, its objects the
        same share of them, and a cell of it under the traffic mix
        ``traffic`` (by default one like ``trickle8`` with 8 warm-up ticks),
        every per-layer metric listed for it; returns the cell's name."""
        with open(os.path.join(ROOT, "portbench", "configs", f"{base}.json"),
                  encoding="utf-8") as f:
            cfg = json.load(f)
        objects = cfg["objects"] * rows // cfg["rows"]
        cfg.update(name=name, rows=rows, objects=objects, reduced=["rows", "objects"])
        self.write(f"portbench/configs/{name}.json", cfg)
        if traffic is None:
            traffic = f"{name}-mix"
            self.write(f"portbench/traffic/{traffic}.json", {
                "ops_per_tick": {"spec_one_slot": 3, "spec_few_slots": 2, "status": 2,
                                 "create_or_delete": 1},
                "few_slots": 4, "status_edit_slots": 2, "warmup_ticks": 8})
        bench = self.bench()
        bench["configs"].append({"name": name, "source": "test", "reduced": ["rows", "objects"],
                                 "file": f"portbench/configs/{name}.json", "why": "test"})
        cell = f"{name}.{traffic}"
        bench["workloads"].append({"name": cell, "config": name, "traffic": traffic,
                                   "chips": 1, "why": "test"})
        for m in bench["per_layer"] + bench["end_to_end"]:
            if "workloads" in m:
                m["workloads"].append(cell)
        self.write("BENCHMARK.json", bench)
        return cell


@pytest.fixture
def bench_copy(tmp_path):
    return BenchCopy(str(tmp_path))
