"""The port's in-process and write-path bench lanes (``python -m
kcp_tpu_torch.bench --store | --encode | --admission | --replica |
--consistent | --writes``) and its trace tool (``python -m
kcp_tpu_torch.obs``) against the reference's ``bench.py`` and
``scripts/tracetool.py``, on the CPU.

Each lane runs at ``scripts/ci.sh``'s shape or smaller. Its key tree
equals the reference's plus ``card`` and ``note``: for ``--writes`` and
``--consistent`` the committed ``BENCH_r09_writes.json`` and
``BENCH_r12_consistent.json``; for the other four the dicts that
``bench.py``'s lane functions build. The behavioural gates hold:

- ``--store``: indexed and linear-scan watch events equal, and equal to
  the reference lane's count on the same shape;
- ``--encode``: cached and uncached wires equal (bytes and events), and
  their sha256 the reference lane's on the same shape;
- ``--admission``: no quiet tenant rejected, the flood meets a 429 with
  Retry-After;
- ``--replica``: replica list bytes equal the primary's, no acked write
  lost across the promotion, the standby promoted to primary with epoch
  1 or later;
- ``--consistent``: bytes equal, no stale read-your-write;
- ``--writes``: grouped and serial state and RV sequences equal, the
  kill-mid-window drill with no acked write lost and commit windows and
  batched acks counted.

Every speed-up, overhead and p99 ratio is a timing: the card machine's to
hold (``chip_smoke.py`` phase 16), not this host's, which shares its
cores with the other test processes.

The trace tool prints byte for byte what ``scripts/tracetool.py`` prints:
``tree`` and ``profile`` of a ``/debug/trace`` body saved from a port
``ServerThread`` with every request traced, and ``diff`` of every pair of
phase profiles that ``SCENARIOS_torch_r01.json`` and ``SCENARIOS_r07.json``
hold for one scenario, phase and rank.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import tempfile

import pytest

from kcp_tpu_torch import bench
from test_torch_shardbench import _committed, _lane, tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# scripts/ci.sh's shapes, or smaller
STORE_SMALL = {"KCP_BENCH_STORE_OBJECTS": "4000", "KCP_BENCH_STORE_MUTS": "600"}
ENCODE_SMALL = {"KCP_BENCH_ENCODE_OBJECTS": "4000", "KCP_BENCH_ENCODE_MUTS": "200"}
ADMISSION_SMALL = {"KCP_BENCH_ADM_WRITES": "1000", "KCP_BENCH_ADM_TENANTS": "20",
                   "KCP_BENCH_ADM_STORM_S": "1"}
REPLICA_CI = {"KCP_BENCH_REPL_OBJECTS": "500", "KCP_BENCH_REPL_SECONDS": "0.8",
              "KCP_BENCH_REPL_LAG_WRITES": "60", "KCP_BENCH_REPL_DRILL_WRITES": "40"}
CONSISTENT_CI = {"KCP_BENCH_CONS_OBJECTS": "500", "KCP_BENCH_CONS_SECONDS": "0.8",
                 "KCP_BENCH_CONS_LAG_WRITES": "60", "KCP_BENCH_CONS_RYWR_STEPS": "60"}
WRITES_SMALL = {"KCP_BENCH_WRITES_SECONDS": "0.3", "KCP_BENCH_WRITES_CONC": "1,64",
                "KCP_BENCH_WRITES_EQ_OPS": "60", "KCP_BENCH_WRITES_STORE_OPS": "20"}

# bench.py store_bench's result (its lines 1237-1257)
_STORE_RUN = {"list_s": None, "fanout_s": None, "events": None}
STORE_KEYS = {
    "metric": None, "value": None, "unit": None,
    "store_bench": {
        "objects": None, "watches": None, "lists": None, "mutations": None,
        "list_speedup": None, "fanout_speedup": None, "events_equal": None,
        "indexed": _STORE_RUN, "legacy": _STORE_RUN,
    },
}

# bench.py encode_bench's result (its lines 1512-1551 and run()'s dict)
_ENCODE_RUN = {"cold_list_s": None, "list_s": None, "churn_list_s": None, "fanout_s": None,
               "list_encode_s": None, "churn_encode_s": None, "fanout_encode_s": None,
               "events": None, "sha256": None}
ENCODE_KEYS = {
    "metric": None, "value": None, "unit": None,
    "encode_bench": {
        "objects": None, "watchers": None, "lists": None, "mutations": None,
        "list_speedup": None, "churn_list_speedup": None, "fanout_speedup": None,
        "list_encode_speedup": None, "churn_encode_speedup": None,
        "fanout_encode_speedup": None, "events_equal": None, "bytes_equal": None,
        "cached": _ENCODE_RUN, "legacy": _ENCODE_RUN,
    },
}

# bench.py admission_bench's result (its lines 1137-1174)
ADMISSION_KEYS = {
    "metric": None, "value": None, "unit": None,
    "admission_bench": {
        "happy": {"writes": None, "http_off_per_s": None, "http_on_per_s": None,
                  "http_med_off_us": None, "http_med_on_us": None, "overhead_pct": None,
                  "direct_off_per_s": None, "direct_on_per_s": None,
                  "direct_overhead_pct": None},
        "storm": {"tenants": None, "flow_rate_per_s": None, "flood_x": None,
                  "storm_s": None, "baseline_quiet_p99_ms": None,
                  "storm_quiet_p99_ms": None, "quiet_p99_ratio": None, "quiet_ok": None,
                  "quiet_rejected": None, "flood_ok": None, "flood_429": None,
                  "flood_sent": None, "flood_retry_after_seen": None},
    },
}

# bench.py replica_bench's result (its lines 3101-3116, ``results`` and the
# drill's dict)
_PER_COUNT = {"0": None, "1": None, "2": None}
REPLICA_KEYS = {
    "metric": None, "value": None, "unit": None, "stage": None,
    "replica_bench": {
        "host_cpus": None, "objects": None, "seconds": None,
        "read_capacity_rps": _PER_COUNT, "capacity_speedup": _PER_COUNT,
        "bytes_equal": None, "lag": {"p50_ms": None, "p99_ms": None, "writes": None},
        "kill": {"acked_writes": None, "lost_after_promotion": None, "promote_ms": None,
                 "promoted_role": None, "epoch": None},
    },
}


def _ref_lane(name: str, env: dict, monkeypatch) -> dict:
    """One lane of the reference's ``bench.py`` (loaded with importlib)
    at the same knobs, its JSON line parsed."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    spec = importlib.util.spec_from_file_location("ref_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        getattr(mod, name)()
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _only(per_key: dict, keys) -> dict:
    return {k: v for k, v in per_key.items() if k in keys}


# ------------------------------------------------ --store, --encode, --admission


def test_store_lane(monkeypatch, capsys):
    r = _lane("--store", STORE_SMALL, monkeypatch, capsys)
    assert tree(r) == STORE_KEYS
    sb = r["store_bench"]
    assert r["metric"] == "store_read_path_speedup" and sb["objects"] == 4000
    assert sb["events_equal"] and sb["indexed"]["events"] > 0
    ref = _ref_lane("store_bench", STORE_SMALL, monkeypatch)["store_bench"]
    assert sb["indexed"]["events"] == ref["indexed"]["events"]
    assert sb["legacy"]["events"] == ref["legacy"]["events"]


def test_encode_lane(monkeypatch, capsys):
    r = _lane("--encode", ENCODE_SMALL, monkeypatch, capsys)
    assert tree(r) == ENCODE_KEYS
    eb = r["encode_bench"]
    assert r["metric"] == "encode_once_speedup"
    assert eb["bytes_equal"] and eb["events_equal"]
    assert eb["cached"]["events"] == 64 * 200
    ref = _ref_lane("encode_bench", ENCODE_SMALL, monkeypatch)["encode_bench"]
    assert eb["cached"]["sha256"] == ref["cached"]["sha256"]
    assert eb["cached"]["events"] == ref["cached"]["events"]


def test_admission_lane(monkeypatch, capsys):
    # the lane sets its own flow budgets: an inherited one must not reach it
    for k in bench.LANE_SERVER_ENV:
        monkeypatch.delenv(k, raising=False)
    r = _lane("--admission", ADMISSION_SMALL, monkeypatch, capsys)
    assert tree(r) == ADMISSION_KEYS
    st = r["admission_bench"]["storm"]
    assert r["metric"] == "admission_overhead_pct"
    assert st["tenants"] == 20 and st["flow_rate_per_s"] == 40.0
    assert st["quiet_rejected"] == 0 and st["quiet_ok"] > 0, st
    assert st["flood_429"] > 0 and st["flood_retry_after_seen"], st
    # the lane restores what it set for its serving A/B
    for k in ("KCP_ADMISSION", "KCP_FLOW_RATE", "KCP_FLOW_BURST"):
        assert k not in os.environ, k


# ---------------------------------------------- --replica, --consistent, --writes


def test_replica_lane(monkeypatch, capsys):
    r = _lane("--replica", REPLICA_CI, monkeypatch, capsys)
    assert tree(r) == REPLICA_KEYS
    rb = r["replica_bench"]
    assert r["metric"] == "replica_read_capacity_speedup"
    assert r["value"] == rb["capacity_speedup"]["2"]
    assert rb["bytes_equal"] and rb["lag"]["writes"] == 60
    kill = rb["kill"]
    assert kill["acked_writes"] == 40 and kill["lost_after_promotion"] == 0, kill
    assert kill["promoted_role"] == "primary" and kill["epoch"] >= 1, kill


def test_consistent_lane(monkeypatch, capsys):
    r = _lane("--consistent", CONSISTENT_CI, monkeypatch, capsys)
    committed = json.load(open(os.path.join(REPO, "BENCH_r12_consistent.json")))
    assert tree(r) == tree(committed)
    cb = r["consistent_bench"]
    assert r["metric"] == "consistent_read_capacity_speedup"
    assert cb["bytes_equal"] and cb["wait_for_frontier"]["writes"] == 60
    rw = cb["read_your_writes"]
    assert rw["reads"] == 60 and rw["stale"] == 0, rw


def test_writes_lane(monkeypatch, capsys, tmp_path):
    # every WAL the lane fsyncs lives under the test's own directory
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    r = _lane("--writes", WRITES_SMALL, monkeypatch, capsys)
    committed = _committed("BENCH_r09_writes.json")
    wb = committed["writes_bench"]
    for part in ("write_path", "end_to_end_http"):
        for mode in ("serial", "grouped", "speedup"):
            if mode in wb[part]:
                wb[part][mode] = _only(wb[part][mode], ("1", "64"))
    assert tree(r) == tree(committed)
    wb = r["writes_bench"]
    assert r["metric"] == "write_group_commit_speedup" and wb["wal_sync"] == "fsync"
    assert wb["concurrency"] == [1, 64]
    assert wb["state_equal"] and wb["rv_sequence_equal"]
    drill = wb["kill_drill"]
    assert drill["ok"] and drill["lost_after_kill"] == 0 and drill["acked_writes"] > 0, drill
    assert drill["commit_windows"] > 0 and drill["acks_batched"] > 0, drill
    # the lane restores the write-path knobs it set
    for k in ("KCP_GROUP_COMMIT", "KCP_WAL_SYNC", "KCP_FLOW_CONCURRENCY"):
        assert k not in os.environ, k


# ------------------------------------------------------------- the trace tool


def _run_tool(argv: list[str], port: bool) -> subprocess.CompletedProcess:
    head = ["-m", "kcp_tpu_torch.obs"] if port else [os.path.join("scripts", "tracetool.py")]
    return subprocess.run([sys.executable, *head, *argv], capture_output=True, text=True,
                          cwd=REPO, timeout=60)


@pytest.fixture
def trace_body(tmp_path, monkeypatch):
    """``/debug/trace?slowest=3`` of a port ``ServerThread`` with every
    request traced, saved to a file."""
    from kcp_tpu_torch.obs import TRACER
    from kcp_tpu_torch.server import Config, RestClient
    from kcp_tpu_torch.server.threaded import ServerThread

    with monkeypatch.context() as m:
        m.setenv("KCP_TRACE", "1")
        m.setenv("KCP_TRACE_SAMPLE", "1")
        TRACER.reconfigure()
        try:
            with ServerThread(Config(durable=False, install_controllers=False,
                                     tls=False)) as st:
                c = RestClient(st.address, cluster="t0")
                for i in range(6):
                    c.create("configmaps", {
                        "apiVersion": "v1", "kind": "ConfigMap",
                        "metadata": {"name": f"cm-{i}", "namespace": "default"},
                        "data": {"v": str(i)}}, "default")
                doc = c._request("GET", "/debug/trace?slowest=3")
                c.close()
        finally:
            m.undo()
            TRACER.reconfigure()
    assert doc["traces"] and all(t["spans"] for t in doc["traces"])
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(doc))
    return str(path)


@pytest.mark.parametrize("cmd", ["tree", "profile"])
def test_tracetool_prints_what_the_reference_prints(cmd, trace_body):
    port = _run_tool([cmd, trace_body], port=True)
    ref = _run_tool([cmd, trace_body], port=False)
    assert port.returncode == ref.returncode == 0, port.stderr + ref.stderr
    assert port.stdout == ref.stdout and port.stdout.strip()
    assert port.stderr == ref.stderr


def _profile_pairs() -> list[tuple[str, dict, dict]]:
    """(scenario/phase/rank, the port's profile, the reference's) for every
    trace rank both scorecards keep."""
    a = json.load(open(os.path.join(REPO, "SCENARIOS_torch_r01.json")))
    b = json.load(open(os.path.join(REPO, "SCENARIOS_r07.json")))
    ref = {s["name"]: s for s in b["scenarios"]}
    pairs = []
    for s in a["scenarios"]:
        other = ref.get(s["name"])
        for phase, traces in (s.get("traces") or {}).items():
            theirs = (other or {}).get("traces", {}).get(phase) or []
            for i, (x, y) in enumerate(zip(traces, theirs)):
                if x.get("profile") and y.get("profile"):
                    pairs.append((f"{s['name']}/{phase}/{i}", x["profile"], y["profile"]))
    return pairs


def test_tracetool_diff_prints_what_the_reference_prints(tmp_path):
    pairs = _profile_pairs()
    assert len(pairs) >= 20
    # every pair in one process per tool; the first pair and an empty one
    # through each tool's command line as well
    spec = importlib.util.spec_from_file_location(
        "ref_tracetool", os.path.join(REPO, "scripts", "tracetool.py"))
    ref_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_tool)
    from kcp_tpu_torch.obs.__main__ import main as port_main

    for label, x, y in pairs:
        fa, fb = tmp_path / "a.json", tmp_path / "b.json"
        fa.write_text(json.dumps(x))
        fb.write_text(json.dumps(y))
        argv = ["diff", str(fa), str(fb)]
        outs = []
        for run in (lambda: port_main(argv), lambda: _ref_main(ref_tool, argv)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = run()
            outs.append((rc, buf.getvalue()))
        assert outs[0] == outs[1], label
        assert outs[0][0] == 0 and outs[0][1].startswith("phase "), label
    label, x, y = pairs[0]
    (tmp_path / "a.json").write_text(json.dumps(x))
    (tmp_path / "b.json").write_text(json.dumps(y))
    (tmp_path / "empty.json").write_text("{}")
    for argv in (["diff", str(tmp_path / "a.json"), str(tmp_path / "b.json")],
                 ["diff", str(tmp_path / "empty.json"), str(tmp_path / "empty.json")]):
        port, ref = _run_tool(argv, port=True), _run_tool(argv, port=False)
        assert (port.returncode, port.stdout, port.stderr) == (
            ref.returncode, ref.stdout, ref.stderr)
    assert ref.returncode == 1 and "no comparable phases" in ref.stderr


def _ref_main(mod, argv: list[str]) -> int:
    saved = sys.argv
    sys.argv = ["tracetool.py", *argv]
    try:
        return mod.main()
    finally:
        sys.argv = saved
