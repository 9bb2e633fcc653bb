"""The port's sharded-fleet bench lanes (``python -m kcp_tpu_torch.bench
--sharded | --smartclient | --elastic``) on the CPU, each at the shape of
the reference CI's smoke (``scripts/ci.sh``):

- ``--sharded`` (1 and 2 ``kcp start`` shard processes, 1.5 s, 16
  clusters, 12 watch events): the merged watch ends with a terminal 410
  when a shard is killed, and no acked write is lost after catch-up;
- ``--smartclient`` (2 shards, 1.5 s, 8 clusters): routed and direct
  bytes equal, direct requests made, the scatter wire identical to the
  joined one with spans written, and the ring-change drill with no acked
  write lost, no error surfaced, at least one fallback and ring epoch 2
  or later;
- ``--elastic`` (2 -> 4 shards, 0.8 s, 16 clusters): no acked write lost,
  no error surfaced, clusters and records migrated, no shard idle after.

Each lane's key tree equals the reference's (``BENCH_r08_smartclient.json``
and ``BENCH_r10_elastic.json``; for ``--sharded`` the keys that
``bench.py``'s ``sharded_bench`` builds), plus ``card`` and ``note``. Each
shard's clusters (``ring_partition``) equal the reference ``ShardRing``'s
owners, and each per-shard row counts them.

The capacity floors (2 shards at least 1.6x one, direct at least 1.5x
routed, the doubled fleet at least 1.2x) and the fail-fast time are
timings: the card machine's to hold (``chip_smoke.py`` phase 15), not this
host's, which shares its cores with the other test processes.
"""

import json
import os

import pytest

from kcp_tpu.sharding import ShardRing as RefShardRing
from kcp_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference CI's shapes (scripts/ci.sh)
SHARDED_CI = {"KCP_BENCH_SHARD_FLEETS": "1,2", "KCP_BENCH_SHARD_SECONDS": "1.5",
              "KCP_BENCH_SHARD_CLUSTERS": "16", "KCP_BENCH_SHARD_EVENTS": "12"}
SMART_CI = {"KCP_BENCH_SMART_SECONDS": "1.5", "KCP_BENCH_SMART_CLUSTERS": "8"}
ELASTIC_CI = {"KCP_BENCH_ELASTIC_SECONDS": "0.8", "KCP_BENCH_ELASTIC_CLUSTERS": "16"}

# bench.py sharded_bench's result (its lines 2307-2323 and the dicts they hold)
SHARDED_KEYS = {
    "metric": None, "value": None, "unit": None,
    "sharded_bench": {
        "host_cpus": None, "clusters": None, "loadgens": None, "seconds": None,
        "fleets": {"1": {"concurrent_per_s": None, "capacity_per_s": None,
                         "per_shard": [{"shard": None, "clusters": None, "per_s": None}]},
                   "2": {"concurrent_per_s": None, "capacity_per_s": None,
                         "per_shard": [{"shard": None, "clusters": None, "per_s": None}]}},
        "capacity_speedup": {"2": None}, "concurrent_speedup": {"2": None},
        "router": {"shards": None, "relay_per_s": None, "list_p50_ms": None,
                   "watch_events": None, "watch_lat_p50_ms": None,
                   "watch_lat_p99_ms": None},
        "kill": {"watch_terminal_410": None, "watch_410_ms": None,
                 "unavailable_after_kill_ms": None, "failfast_ms": None,
                 "acked_writes": None, "lost_after_catchup": None},
    },
}


def tree(v):
    """The key tree of a JSON value: dicts by key, lists by their first
    element, leaves as None."""
    if isinstance(v, dict):
        return {k: tree(x) for k, x in v.items()}
    if isinstance(v, list):
        return [tree(v[0])] if v else []
    return None


def _committed(name: str) -> dict:
    with open(os.path.join(REPO, name), encoding="utf-8") as f:
        return json.loads(f.read().strip().splitlines()[-1])


def _lane(flag: str, env: dict, monkeypatch, capsys) -> dict:
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("KCP_FAULTS", raising=False)
    monkeypatch.chdir(REPO)  # the lanes' children run python -m kcp_tpu_torch...
    bench.main([flag])
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r.pop("note") == bench.HOST_PATH_NOTE
    assert "card" in r
    r.pop("card")
    return r


def _ref_partition(names: list[str], clusters: list[str]) -> list[list[str]]:
    ring = RefShardRing.from_spec(",".join(f"{n}=http://h{i}:1" for i, n in enumerate(names)))
    return [[c for c in clusters if ring.owner_index(c) == i] for i in range(len(names))]


@pytest.mark.parametrize("n_shards,n_clusters", [(1, 16), (2, 16), (2, 8), (4, 16), (4, 24)])
def test_ring_partition_equals_the_reference_ring(n_shards, n_clusters):
    names = [f"s{i}" for i in range(n_shards)]
    clusters = [f"t{i}" for i in range(n_clusters)]
    got = bench.ring_partition(names, clusters)
    assert got == _ref_partition(names, clusters)
    assert sorted(c for part in got for c in part) == sorted(clusters)


def test_sharded_lane(monkeypatch, capsys):
    r = _lane("--sharded", SHARDED_CI, monkeypatch, capsys)
    assert tree(r) == SHARDED_KEYS
    sb = r["sharded_bench"]
    kill = sb["kill"]
    assert r["metric"] == "sharded_write_capacity_speedup"
    assert r["value"] == sb["capacity_speedup"]["2"]
    assert kill["watch_terminal_410"], kill
    assert kill["lost_after_catchup"] == 0 and kill["acked_writes"] == 60, kill
    assert sb["router"]["watch_events"] == 12 and sb["router"]["shards"] == 2
    clusters = [f"t{i}" for i in range(16)]
    for n in ("1", "2"):
        want = _ref_partition([f"s{i}" for i in range(int(n))], clusters)
        assert [p["clusters"] for p in sb["fleets"][n]["per_shard"]] == [len(p) for p in want]
        assert all(p["per_s"] > 0 for p in sb["fleets"][n]["per_shard"])


def test_smartclient_lane(monkeypatch, capsys):
    r = _lane("--smartclient", SMART_CI, monkeypatch, capsys)
    ref = _committed("BENCH_r08_smartclient.json")
    assert tree(r) == tree(ref)
    sb = r["smartclient_bench"]
    ab, wire, drill = sb["ab"], sb["wire"], sb["ring_change_drill"]
    assert r["value"] == ab["capacity_speedup"]
    assert ab["bytes_equal"] and ab["direct_requests"] > 0, ab
    assert wire["identical"] and wire["spans_written"] > 0, wire
    assert wire["list_bytes"] == ref["smartclient_bench"]["wire"]["list_bytes"]
    assert drill["lost_after_move"] == 0 and drill["errors_surfaced"] == 0, drill
    assert drill["acked_writes"] == 80, drill
    assert drill["fallbacks"] >= 1 and drill["ring_epoch_after"] >= 2, drill
    want = _ref_partition(["s0", "s1"], [f"t{i}" for i in range(8)])
    assert [(p["shard"], p["clusters"]) for p in ab["per_shard"]] == [
        (p["shard"], p["clusters"]) for p in ref["smartclient_bench"]["ab"]["per_shard"]] == [
        (i, len(p)) for i, p in enumerate(want)]


def test_elastic_lane(monkeypatch, capsys):
    r = _lane("--elastic", ELASTIC_CI, monkeypatch, capsys)
    ref = _committed("BENCH_r10_elastic.json")
    assert tree(r) == tree(ref)
    eb = r["elastic_bench"]
    mv = eb["during_move"]
    assert r["value"] == round(eb["capacity_after_per_s"] / eb["capacity_before_per_s"], 2)
    assert mv["lost_after_move"] == 0 and mv["errors_surfaced"] == 0, mv
    assert mv["migrated_clusters"] >= 1 and mv["migration_records"] >= 1, mv
    assert len(eb["per_shard_after"]) == eb["shards_after"] == 4, eb["per_shard_after"]
    clusters = [f"t{i}" for i in range(16)]
    for key, n in (("per_shard_before", 2), ("per_shard_after", 4)):
        want = _ref_partition([f"s{i}" for i in range(n)], clusters)
        assert [(p["shard"], p["clusters"]) for p in eb[key]] == [
            (p["shard"], p["clusters"]) for p in ref["elastic_bench"][key]] == [
            (f"s{i}", len(p)) for i, p in enumerate(want)]
    # each new shard takes the clusters whose HRW owner it becomes
    moved = sum(len(_ref_partition([f"s{i}" for i in range(n)], clusters)[-1])
                for n in (3, 4))
    assert mv["migrated_clusters"] == moved == ref["elastic_bench"]["during_move"][
        "migrated_clusters"]
