"""The port's scenario harness against the JAX package's, on the CPU.

- The reference's own cases of ``test_scenarios.py`` (replay
  determinism, SLO gating, the ``scenario.phase`` and ``server.drain``
  drills, graceful drain) and ``test_tracing.py`` (``/metrics`` and
  ``/debug/profile``, sampling, ``/debug/trace``, the commit stamp, wire
  neutrality, propagation, the cross-process assembly through a router
  over two ``kcp_tpu_torch.cli.kcp`` children, the convergence phases,
  the fleet metrics federation), run against the port
  (``test_torch_engine.port_module``). Every case runs; none is left
  out.
- The catalog: every spec of the port's ``SCENARIOS`` equal to the
  reference's field by field; the schedule hashes at seed 42 equal to
  ``SCENARIOS_r07.json``'s at scale 1.0 and to the reference's own
  ``schedule_hash`` at scale 0.25.
- Each of the 13 scenarios through the port at seed 42, scale 0.25, on
  the CPU: the scorecard's keys those of its ``SCENARIOS_r07.json``
  entry (traces aside), every SLO on a count passing. An SLO on a time
  or a ratio (``*_ms``, ``*_ratio``) is printed, not held: a loaded
  test host is no measure of them, the card is (``chip_smoke.py``).
- ``crud-churn`` (the mirrored ``TINY`` shape), ``fleet-churn`` and
  ``capacity-skew-binpack`` through both packages with one seed: equal
  schedules, acks, losses, 5xx, placement counts and fleet counts.
- No CPU fallback: without a card, ``run_scenario`` of a scenario with
  device work and ``python -m kcp_tpu_torch.scenarios run`` without
  ``--device`` fail before any server starts.
- ``obs/assemble.py``'s six functions against the reference's on seeded
  span lists.
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import test_scenarios as ref_scenario_tests
import torch

from kcp_tpu.obs import assemble as ref_assemble
from kcp_tpu.scenarios import catalog as ref_catalog
from kcp_tpu.scenarios import engine as ref_engine
from kcp_tpu.scenarios import workload as ref_workload
from kcp_tpu_torch.obs import assemble as port_assemble
from kcp_tpu_torch.scenarios import catalog as port_catalog
from kcp_tpu_torch.scenarios import engine as port_engine
from kcp_tpu_torch.scenarios import workload as port_workload
from test_torch_engine import _cases, port_module, run_mirrored

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ("test_scenarios.py", "test_tracing.py")
MIRRORED = [c for f in FILES for c in _cases(f)]

# the fixture test_tracing.py defines, against the port's tracer
trace_env = port_module("test_tracing.py").trace_env

with open(os.path.join(REPO, "SCENARIOS_r07.json")) as _f:
    REFERENCE_CARD = {s["name"]: s for s in json.load(_f)["scenarios"]}


@pytest.mark.parametrize("ref_file,name,kwargs", MIRRORED)
def test_reference_scenario_case_against_the_port(ref_file, name, kwargs, request):
    run_mirrored(ref_file, name, kwargs, request)


def test_mirrored_scenario_files_run_every_case():
    names = {(p.values[0], p.values[1]) for p in MIRRORED}
    # 8 + 11 test functions, none parametrised
    assert len(names) == 19 and len(MIRRORED) == 19
    scen, tracing = port_module("test_scenarios.py"), port_module("test_tracing.py")
    assert scen.run_scenario is port_engine.run_scenario
    assert tracing.assemble is port_assemble


# ------------------------------------------------------------- the catalog


def test_catalog_specs_equal_the_references():
    assert list(port_catalog.SCENARIOS) == list(ref_catalog.SCENARIOS)
    for name, spec in port_catalog.SCENARIOS.items():
        ref = ref_catalog.SCENARIOS[name]
        assert dataclasses.asdict(spec) == dataclasses.asdict(ref), name
        for scale in (0.25, 0.4):
            assert dataclasses.asdict(spec.scaled(scale)) == \
                dataclasses.asdict(ref.scaled(scale)), (name, scale)


@pytest.mark.parametrize("name", list(ref_catalog.SCENARIOS))
def test_schedule_hashes_equal_the_reference(name):
    spec = port_catalog.SCENARIOS[name]
    schedule = port_workload.build_schedule(42, spec)
    assert port_workload.schedule_hash(42, spec, schedule) == \
        REFERENCE_CARD[name]["schedule"]["hash"]
    small, ref_small = spec.scaled(0.25), ref_catalog.SCENARIOS[name].scaled(0.25)
    got = port_workload.schedule_hash(42, small, port_workload.build_schedule(42, small))
    want = ref_workload.schedule_hash(42, ref_small,
                                      ref_workload.build_schedule(42, ref_small))
    assert got == want
    assert port_workload.expected_final_state(schedule, spec) == \
        ref_workload.expected_final_state(ref_workload.build_schedule(
            42, ref_catalog.SCENARIOS[name]), ref_catalog.SCENARIOS[name])


def _timed(metric: str) -> bool:
    return metric.endswith("_ms") or metric.endswith("_ratio")


@pytest.mark.parametrize("name", list(ref_catalog.SCENARIOS))
def test_catalog_scenario_through_the_port(name, tmp_path):
    r = port_engine.run_scenario(port_catalog.SCENARIOS[name], seed=42, scale=0.25,
                                 workdir=str(tmp_path), device="cpu")
    ref = REFERENCE_CARD[name]
    assert "aborted" not in r, r["aborted"]
    assert set(r) - {"traces"} == set(ref) - {"traces"}
    assert set(r["measurements"]) == set(ref["measurements"])
    assert [(s["name"], s["metric"], s["op"], s["target"]) for s in r["slos"]] == \
        [(s["name"], s["metric"], s["op"], s["target"]) for s in ref["slos"]]
    missed = [s for s in r["slos"] if not s["passed"] and not _timed(s["metric"])]
    assert not missed, missed
    for s in r["slos"]:
        if _timed(s["metric"]):
            print(f"{name}: {s['metric']} {s['op']} {s['target']}: observed "
                  f"{s['observed']} ({'held' if s['passed'] else 'missed'} on the CPU)")


# ------------------------------------------------ counts against the reference

CRUD_KEYS = ("acked", "lost_acked_writes", "http_5xx")
PLACEMENT_KEYS = ("placement_rows", "placement_mismatches", "placement_overcommit_rows",
                  "placement_noncandidate_replicas", "placement_incremental_extra_rows",
                  "placement_incremental_mismatches")
FLEET_KEYS = ("fleet_flaps", "fleet_seed_unplaced", "fleet_storm_churn",
              "fleet_storm_evacuations", "assignment_mismatches", "fleet_unplaced")


@pytest.mark.parametrize("port_spec,ref_spec,scale,keys", [
    # test_scenarios.py's TINY shape, in each package
    (port_module("test_scenarios.py").TINY, ref_scenario_tests.TINY, 1.0, CRUD_KEYS),
    (port_catalog.FLEET_CHURN, ref_catalog.FLEET_CHURN, 0.25, FLEET_KEYS),
    (port_catalog.CAPACITY_SKEW, ref_catalog.CAPACITY_SKEW, 0.25, PLACEMENT_KEYS),
], ids=["crud-churn", "fleet-churn", "capacity-skew-binpack"])
def test_deterministic_counts_equal_the_reference(port_spec, ref_spec, scale, keys, tmp_path):
    port = port_engine.run_scenario(port_spec, seed=42, scale=scale,
                                    workdir=str(tmp_path / "port"), device="cpu")
    ref = ref_engine.run_scenario(ref_spec, seed=42, scale=scale,
                                  workdir=str(tmp_path / "ref"))
    assert port["passed"] and ref["passed"], (port["slos"], ref["slos"])
    assert port["schedule"] == ref["schedule"]
    for key in keys:
        assert port["measurements"][key] == ref["measurements"][key], key


# ------------------------------------------------------------- no fallback


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the host without a card")
def test_run_scenario_without_a_card_raises_before_any_server(monkeypatch, tmp_path):
    started = []
    monkeypatch.setattr(port_engine, "make_topology",
                        lambda *a, **k: started.append(a) or None)
    for spec in (port_catalog.FLEET_CHURN, port_catalog.CRD_CHURN,
                 port_catalog.CAPACITY_SKEW):
        with pytest.raises(RuntimeError, match="runs on a CUDA card by default"):
            port_engine.run_scenario(spec, seed=42, scale=0.25, workdir=str(tmp_path))
    assert started == [] and os.listdir(tmp_path) == []
    # a serve-only scenario needs no device
    assert port_engine.scenario_device(port_catalog.CRUD_CHURN) is None
    assert port_engine.scenario_device(port_catalog.FLEET_CHURN, "cpu") == "cpu"


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the host without a card")
def test_scenarios_cli_without_a_card_exits_before_any_scenario(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "KCP_DEVICE"}
    proc = subprocess.run(
        [sys.executable, "-m", "kcp_tpu_torch.scenarios", "run", "--scenarios",
         "fleet-churn", "--workdir", str(tmp_path)],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 2
    assert "runs on a CUDA card by default" in proc.stderr
    assert "== scenario" not in proc.stdout and os.listdir(tmp_path) == []


def test_scenarios_cli_runs_on_the_cpu_and_writes_the_scorecard(tmp_path):
    out = tmp_path / "card.json"
    proc = subprocess.run(
        [sys.executable, "-m", "kcp_tpu_torch.scenarios", "run", "--scenarios",
         "crud-churn,capacity-skew-binpack", "--scale", "0.25", "--device", "cpu",
         "--workdir", str(tmp_path / "wd"), "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    card = json.loads(out.read_text())
    assert list(card) == ["kind", "seed", "scale", "duration_s", "passed", "scenarios"]
    assert card["kind"] == "ScenarioScorecard" and card["passed"]
    assert [s["name"] for s in card["scenarios"]] == ["crud-churn", "capacity-skew-binpack"]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "passed": True, "scenarios": {"crud-churn": True, "capacity-skew-binpack": True}}


def test_slo_refuses_an_unknown_operator():
    from kcp_tpu_torch.scenarios import SLO

    with pytest.raises(ValueError, match="unknown op"):
        SLO("x", "m", "<", 1)
    assert SLO("x", "m", "<=", 1).check(1) and not SLO("x", "m", "==", 1).check(0)


# -------------------------------------------------------------- assembly


def _spans(rng, n_traces: int = 3, per_trace: int = 12) -> list[dict]:
    """Seeded span dicts: several traces over two processes, conv.*
    phases among them, parents inside and outside the list."""
    names = ["conv.e2e", "conv.write", "conv.stage", "conv.tick", "conv.patch",
             "conv.downstream", "conv.upstatus", "server.request", "store.commit",
             "store.fanout", "client.request", "router.relay"]
    out = []
    for t in range(n_traces):
        trace = f"{t:032x}"
        ids = [f"{t:08x}{i:08x}" for i in range(per_trace)]
        for i, span in enumerate(ids):
            parent = ids[int(rng.integers(0, i))] if i and rng.random() < 0.8 else (
                "ffff" if rng.random() < 0.5 else "")
            s = {"trace": trace, "span": span, "parent": parent,
                 "name": names[int(rng.integers(0, len(names)))],
                 "t0": float(rng.uniform(0, 2)), "dur": float(rng.uniform(0, 0.5)),
                 "proc": f"p{int(rng.integers(0, 2))}"}
            if rng.random() < 0.5:
                s["attrs"] = {"rv": str(int(rng.integers(1, 4))),
                              "obj": f"o{int(rng.integers(0, 3))}"}
            out.append(s)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_assembly_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    spans = _spans(rng)
    frags = [spans[i::3] for i in range(3)] + [spans[:5]]
    by_trace = {}
    for s in spans:
        by_trace.setdefault(s["trace"], []).append(s)
    for fn in ("build_tree", "render_tree", "phase_profile"):
        for sub in [spans, *by_trace.values(), []]:
            got = getattr(port_assemble, fn)(copy.deepcopy(sub))
            assert got == getattr(ref_assemble, fn)(copy.deepcopy(sub)), fn
    for rv in (None, "1", 2, "9"):
        assert port_assemble.merge_fragments(frags, rv) == \
            ref_assemble.merge_fragments(frags, rv)
    profiles = [ref_assemble.phase_profile(t) for t in by_trace.values()]
    for a in profiles:
        for b in profiles:
            assert port_assemble.diff_profiles(a, b) == ref_assemble.diff_profiles(a, b)
            assert port_assemble.diff_profiles(a["phases"], b) == \
                ref_assemble.diff_profiles(a["phases"], b)
    for tid, sub in [*by_trace.items(), (None, []), ("x", spans)]:
        assert port_assemble.summarize_trace(sub, tid) == \
            ref_assemble.summarize_trace(sub, tid)
        assert port_assemble.summarize_trace(sub) == ref_assemble.summarize_trace(sub)
