"""The port's bench lanes (``python -m kcp_tpu_torch.bench``) against the
reference's ``bench.py``, on the CPU at the reference CI's small shapes
(``scripts/ci.sh``).

- ``--fleet`` (2,048 rows, 16 steps, 6 warm-up, 8 stragglers): the
  per-owner patch streams equal across modes, the quarantine drill
  green, rows per dispatch at least 2x; every per-owner digest of each
  mode equal to the reference's ``_fleet_mode_run`` on JAX's CPU
  (``bench.py`` loaded with importlib: it imports no JAX at module
  level).
- ``--pagination`` (2,000 objects, pages of 250): the pages' bytes and
  RV equal to the one-shot list's, and the page count and the items'
  sha256 those of the reference's ``_pagination_ab``.
- ``gauntlet_specs()`` equal field by field to the five specs the
  reference's ``gauntlet_bench`` runs (captured by patching its
  ``run_scenario``), and each one's schedule hash at seed 42, scale 1/50
  equal to the reference's.
- The gauntlet through the port on the CPU: config 0 at 1/50 and the
  controller config 3 at 2 tenants, each passing with no lost acked
  write and the reference scorecard's keys (each row also names the
  device its config's device work ran on).
- ``--trace`` at a reduced shape: the wires equal across the three
  ``KCP_TRACE`` modes, every convergence trace sum-reconciles, the six
  ``conv.*`` phases and the five span kinds the reference CI asserts.
  The overhead floor is a timing: the card's, not this host's.
- No fallback: ``--fleet`` and a ``--gauntlet`` with the controller
  config exit 2 without a card before any run.
"""

import asyncio
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from kcp_tpu.scenarios import engine as ref_engine
from kcp_tpu.scenarios import workload as ref_workload
from kcp_tpu_torch import bench
from kcp_tpu_torch.scenarios import engine as port_engine
from kcp_tpu_torch.scenarios import workload as port_workload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one intra-op thread per xdist worker, as test_torch_engine.py sets it:
# torch's default pool oversubscribes the host and slows the tiny CPU ops
torch.set_num_threads(1)

# the reference CI's fleet smoke shape (scripts/ci.sh)
FLEET_CI = {"KCP_BENCH_FLEET_ROWS": "2048", "KCP_BENCH_FLEET_STEPS": "16",
            "KCP_BENCH_FLEET_WARMUP": "6", "KCP_BENCH_FLEET_STRAGGLERS": "8"}
# a reduced --trace shape (the reference CI's, cut further for this host)
TRACE_SMALL = {"KCP_BENCH_TRACE_OBJECTS": "300", "KCP_BENCH_TRACE_REQS": "64",
               "KCP_BENCH_TRACE_WATCHES": "4", "KCP_BENCH_TRACE_MUTS": "48",
               "KCP_BENCH_TRACE_CONV": "2"}
GAUNTLET_ENV = ("KCP_GAUNTLET_SCALE", "KCP_GAUNTLET_CONFIGS", "KCP_GAUNTLET_SOAK",
                "KCP_GAUNTLET_OPS", "KCP_GAUNTLET_OUT")


def _ref_bench():
    spec = importlib.util.spec_from_file_location("ref_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lane(argv, capsys) -> dict:
    bench.main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# ---------------------------------------------------------------- --fleet


def test_fleet_lane_on_the_cpu(monkeypatch, capsys):
    for k, v in FLEET_CI.items():
        monkeypatch.setenv(k, v)
    r = _lane(["--fleet", "--device", "cpu"], capsys)
    fb = r["fleet_bench"]
    assert r["metric"] == "fleet_device_utilization" and r["device"] == "cpu"
    assert fb["streams_equal"], "ragged and per-bucket patch streams diverged"
    assert r["value"] >= 2.0, r["value"]
    assert fb["quarantine_drill"]["ok"], fb["quarantine_drill"]
    # lockstep: one dispatch a step ragged, one per bucket per step otherwise
    assert fb["dispatches"] == {"per_bucket": 16 * fb["buckets"], "ragged": 16}
    assert fb["buckets"] == 4 and fb["sections"] == 3 + 8


def test_fleet_on_mode_sees_each_mode_as_it_ends(monkeypatch):
    for k, v in {"KCP_BENCH_FLEET_ROWS": "256", "KCP_BENCH_FLEET_STEPS": "2",
                 "KCP_BENCH_FLEET_WARMUP": "1", "KCP_BENCH_FLEET_STRAGGLERS": "2"}.items():
        monkeypatch.setenv(k, v)
    seen = []
    r = asyncio.run(bench.measure_fleet("cpu", on_mode=lambda m, res: seen.append(
        (m, res["dispatches"]))))
    assert seen == list(r["fleet_bench"]["dispatches"].items()) == \
        [("per_bucket", 2 * 4), ("ragged", 2)]


@pytest.mark.parametrize("fleet", [False, True], ids=["per_bucket", "ragged"])
def test_fleet_digests_equal_the_reference(fleet):
    ref = _ref_bench()
    # the lane's buckets at 2,048 rows: (rows, 64), (rows // 8, 32), (rows // 64, 16)
    shape = [(2048, 64), (256, 32), (32, 16)]
    args = (fleet, shape, 8, 16, 6, 0.1)
    want = asyncio.run(ref._fleet_mode_run(*args))
    got = asyncio.run(bench._fleet_mode_run(*args, device="cpu"))
    assert got["stream_digests"] == want["stream_digests"]
    assert "empty" not in got["stream_digests"]
    # patch_rows counts the patches applied after warm-up; where the last
    # warm-up tick's patches land, before or after that mark, is timing
    # (they are applied after the tick is counted), so the digests, which
    # cover every patch of the run, are what must be equal
    for k in ("rows", "buckets", "sections", "dispatches"):
        assert got[k] == want[k], k


# ------------------------------------------------------------ --pagination


def test_pagination_lane_equals_the_reference(monkeypatch, capsys):
    monkeypatch.setenv("KCP_BENCH_PAG_OBJECTS", "2000")
    monkeypatch.setenv("KCP_BENCH_PAG_PAGE", "250")
    r = _lane(["--pagination"], capsys)
    ab = r["pagination_bench"]
    assert r["metric"] == "paged_relist_peak_cut" and r["value"] == ab["peak_cut"]
    assert ab["bytes_equal"] and ab["rv_equal"]
    want = _ref_bench()._pagination_ab(2000, 250)
    assert set(ab) == set(want)
    assert (ab["pages"], ab["sha256"]) == (want["pages"], want["sha256"]) == \
        (8, want["sha256"])


# -------------------------------------------------------------- --gauntlet


@pytest.fixture
def reference_gauntlet_specs(monkeypatch):
    """The specs the reference's gauntlet_bench hands run_scenario, in
    order, at its defaults (its relist A/B cut to a few objects)."""
    for k in GAUNTLET_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("KCP_BENCH_PAG_OBJECTS", "20")
    monkeypatch.setenv("KCP_BENCH_PAG_PAGE", "5")
    seen = []

    def capture(spec, seed, scale, workdir):
        seen.append((spec, seed, scale))
        return {"passed": True, "measurements": {}}

    monkeypatch.setattr(ref_engine, "run_scenario", capture)
    assert _ref_bench().gauntlet_bench() == 0
    return seen


def test_gauntlet_specs_equal_the_references(reference_gauntlet_specs, capsys):
    capsys.readouterr()
    specs = bench.gauntlet_specs()
    assert len(specs) == len(reference_gauntlet_specs) == 5
    for spec, (ref, seed, scale) in zip(specs, reference_gauntlet_specs):
        assert (seed, scale) == (42, 1.0 / 50)
        assert dataclasses.asdict(spec) == dataclasses.asdict(ref), spec.name
        small, ref_small = spec.scaled(scale), ref.scaled(scale)
        got = port_workload.schedule_hash(42, small, port_workload.build_schedule(42, small))
        want = ref_workload.schedule_hash(42, ref_small,
                                          ref_workload.build_schedule(42, ref_small))
        assert got == want, spec.name
    # only the controller config resolves a device
    assert [port_engine.scenario_device(s, "cpu") for s in specs] == \
        [None, None, None, "cpu", None]


@pytest.mark.parametrize("config,divisor", [(0, "50"), (3, "2500")],
                         ids=["demo-1-50", "crd-5k-2-tenants"])
def test_gauntlet_through_the_port(config, divisor, monkeypatch):
    for k in GAUNTLET_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("KCP_GAUNTLET_CONFIGS", str(config))
    monkeypatch.setenv("KCP_GAUNTLET_SCALE", divisor)
    monkeypatch.setenv("KCP_BENCH_PAG_OBJECTS", "200")
    monkeypatch.setenv("KCP_BENCH_PAG_PAGE", "50")
    card = bench.gauntlet_bench("cpu")
    with open(os.path.join(REPO, "GAUNTLET_r01.json")) as f:
        reference = json.load(f)
    assert set(card) == set(reference), card
    assert card["value"] == 1 and card["unit"] == "of 1 configs"
    assert card["scale"] == f"1/{divisor}"
    (row,) = card["rows"]
    # the reference's row keys, and the device the config's device work ran on
    assert set(row) == set(reference["rows"][0]) | {"device"}, row
    assert row["device"] == ("cpu" if config == 3 else None)
    assert row["name"] == bench.gauntlet_specs()[config].name
    assert row["passed"] and row["lost_acked_writes"] == 0, row
    assert all(s["passed"] for s in row["slos"]), row["slos"]
    assert card["relist"]["bytes_equal"] and card["relist"]["rv_equal"]


# ----------------------------------------------------------------- --trace


def test_trace_lane_on_the_cpu(monkeypatch, capsys):
    for k, v in TRACE_SMALL.items():
        monkeypatch.setenv(k, v)
    for k in ("KCP_TRACE", "KCP_TRACE_SAMPLE", "KCP_TRACE_SEED"):
        monkeypatch.delenv(k, raising=False)
    try:
        r = _lane(["--trace"], capsys)
    finally:
        from kcp_tpu_torch import obs

        for k in ("KCP_TRACE", "KCP_TRACE_SAMPLE", "KCP_TRACE_SEED"):
            os.environ.pop(k, None)
        obs.TRACER.reconfigure()
    tb = r["trace_bench"]
    assert r["metric"] == "trace_overhead_p50_pct" and r["unit"] == "%"
    assert tb["bytes_equal"], "wire bytes diverged under tracing"
    assert set(tb["modes"]) == {"off", "sampled", "always"}
    conv = tb["convergence"]
    assert conv["runs"] == 2 and conv["all_sum_ok"], conv["sum_reconciles"]
    need = {"write", "stage", "tick", "patch", "downstream", "upstatus"}
    assert need <= set(conv["phases_seen"]), conv["phases_seen"]
    names = set(conv["traces"][0]["names"])
    for s in ("server.request", "router.relay", "store.commit", "repl.ack",
              "repl.apply", "conv.e2e"):
        assert s in names, (s, sorted(names))


# ------------------------------------------------------------- no fallback


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the host without a card")
@pytest.mark.parametrize("argv,env", [
    (["--fleet"], {}),
    (["--gauntlet"], {"KCP_GAUNTLET_CONFIGS": "3"}),
], ids=["fleet", "gauntlet-controllers"])
def test_device_lanes_without_a_card_exit_before_any_run(argv, env, tmp_path):
    env = dict({k: v for k, v in os.environ.items()
                if k not in GAUNTLET_ENV and k != "KCP_DEVICE"},
               TMPDIR=str(tmp_path), **env)
    proc = subprocess.run([sys.executable, "-m", "kcp_tpu_torch.bench", *argv],
                          capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 2, proc.stderr
    assert "runs on a CUDA card by default" in proc.stderr
    assert proc.stdout == "" and "# gauntlet" not in proc.stderr
    assert os.listdir(tmp_path) == []
