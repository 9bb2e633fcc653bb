"""A cell's whole run on the CPU at a tiny size (the core's step takes the
kernel's plain version), the result line's contract, and cells added as
files only."""

import hashlib
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import spec
from portbench.cell import run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
SEED = 2**31 + 12345  # above 32 signed bits, as the benchmark's seeds may be


def _run(cell, trace=False, seconds=1.5, seed=SEED, **kw):
    return run_cell(cell, seed, seconds, trace, time.perf_counter(), device="cpu", **kw)


def test_cpu_run_prints_the_contract_keys(bench_copy):
    cell = spec.load_cell(bench_copy.add_cell("tiny"), root=bench_copy.root)
    result, lines = _run(cell)
    assert list(result) == KEYS
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    assert sorted(result["metrics"]) == sorted(m["name"] for m in cell.end_to_end)
    assert {m["unit"] for m in result["metrics"].values()} <= {"reconciles/s", "ms", "s"}
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(c == {"value": 0, "limit": 0} for c in result["checks"].values())
    assert lines[-len(result["checks"]):] == [
        f"check {k}: 0 (limit 0)" for k in result["checks"]]
    json.dumps(result)


def test_traced_cpu_run_gives_the_host_layers_and_the_trace_keys(bench_copy):
    cell = spec.load_cell(bench_copy.add_cell("tiny"), root=bench_copy.root)
    result, _lines = _run(cell, trace=True, seconds=3.0)
    assert list(result) == KEYS[:5] + ["breakdown", "checks"]
    assert result["correct"] is True
    # no device on the CPU: the device readers find nothing and stay silent
    assert set(result["metrics"]) == {
        "encode_ms_per_tick", "collect_wait_ms_per_tick", "pack_ms_per_tick",
        "step_dispatch_ms_per_tick", "gc_pause_ms_per_s", "convergence_p99_ms"}
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def _digests(root: str) -> dict:
    out = {}
    for base, _dirs, files in os.walk(os.path.join(root, "portbench")):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_a_configuration_traffic_and_metric_are_added_as_files_only(bench_copy):
    before = _digests(bench_copy.root)
    name = bench_copy.add_cell("added", rows=8192)
    bench_copy.write("portbench/metrics/ticks_seen.py",
                     "def read(ctx):\n    return ctx.ticks\n")
    bench = bench_copy.bench()
    bench["per_layer"].append({"name": "ticks_seen", "unit": "ticks", "better": "higher",
                               "source": "host_clock", "layer": "tick loop",
                               "moves": "reconciles_per_s", "workloads": [name]})
    bench_copy.write("BENCHMARK.json", bench)
    after = _digests(bench_copy.root)
    assert {k: v for k, v in after.items() if k in before} == before
    cell = spec.load_cell(name, root=bench_copy.root)
    result, _ = _run(cell, trace=True, seconds=3.0)
    assert result["correct"] is True
    assert result["metrics"]["ticks_seen"]["value"] > 0


@pytest.mark.parametrize("traffic, rows", [("trickle8", 4096), ("trickle64", 8192)])
def test_the_control_reads_incorrect_where_the_program_passes(bench_copy, traffic, rows):
    """The control through the run and the judge every run takes, at the
    cells' own traffic mixes."""
    cell = spec.load_cell(bench_copy.add_cell("tiny", rows=rows, traffic=traffic),
                          root=bench_copy.root)
    for seed in (3, 2**31 + 5):
        program, _ = _run(cell, seed=seed, seconds=1.0)
        control, lines = _run(cell, seed=seed, seconds=1.0, control=True)
        assert program["correct"] is True
        assert control["correct"] is False
        assert control["checks"]["patch_mismatches"]["value"] > 0
        assert "check patch_mismatches: 0 (limit 0)" not in lines


def test_the_command_refuses_without_a_card_or_without_the_port(bench_copy):
    if torch.cuda.is_available():
        # on a card machine only the bare directory can refuse
        cmds = [(bench_copy.root, {})]
    else:
        cmds = [(spec.ROOT, {}), (bench_copy.root, {})]
    for cwd, env in cmds:
        proc = subprocess.run(
            [sys.executable, "-m", "portbench", "--workload", "fleet-1m.trickle64",
             "--seed", "1", "--seconds", "1", "--trace", "0"],
            cwd=cwd, capture_output=True, text=True, timeout=300,
            env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"} | env)
        assert proc.returncode != 0
        assert proc.stdout.strip() == ""
