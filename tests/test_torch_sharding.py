"""The port's sharded control plane against the JAX package's, on the CPU.

- The reference's own cases of ``test_sharding.py`` (the ring, the
  vector RV codec, the router's relay, merges and watches, the
  sharded-vs-single fuzz, shard-kill chaos), ``test_migration.py``
  (fence, stream, cut-over, purge; the ``scripts/walreplay.py`` oracle
  reading the port's WAL files) and ``test_smartclient.py`` (direct
  routing, stale-ring 410s, a moved shard), run against the port
  (``test_torch_engine.port_module``: the fleet a mirrored file takes
  from ``helpers`` is the port's ``scenarios.topology``'s, and
  ``test_migration.py``'s ``from test_sharding import`` names come from
  that file's mirror). Every case runs; none is left out.
- HRW ownership: the port's ``owner_name`` names the reference's owner
  for every cluster tried.
- Router parity: one seeded request script through the JAX
  ``shard_fleet(3)`` and through the port's, in memory, TLS and
  controllers off: equal status codes and bodies (vector RVs included)
  after dropping ``metadata.uid`` and ``metadata.creationTimestamp``.
"""

import http.client
import importlib
import json
import re
import urllib.parse

import numpy as np
import pytest

from test_torch_engine import FLEET_HELPERS, TESTS, _cases, port_module, run_mirrored
from test_torch_server import _normalise

FILES = ("test_sharding.py", "test_migration.py", "test_smartclient.py")
MIRRORED = [c for f in FILES for c in _cases(f)]

# the fixture test_sharding.py defines, against the port's fleet
fleet = port_module("test_sharding.py").fleet


@pytest.mark.parametrize("ref_file,name,kwargs", MIRRORED)
def test_reference_sharding_case_against_the_port(ref_file, name, kwargs, request):
    run_mirrored(ref_file, name, kwargs, request)


def test_mirrored_sharding_files_run_every_case():
    names = {(p.values[0], p.values[1]) for p in MIRRORED}
    # 22 + 11 + 7 test functions; test_sharding.py's sharded-vs-single
    # fuzz runs two seeds
    assert len(names) == 40 and len(MIRRORED) == 41


def test_mirrored_fleets_are_the_ports():
    """Every reference test file that takes a fleet builder from
    ``helpers`` sees the port's in its mirror, and names imported from a
    sibling test file come from that file's mirror."""
    import os

    taking = []
    for ref_file in sorted(os.listdir(TESTS)):
        if not ref_file.startswith("test_") or ref_file.startswith("test_torch_"):
            continue
        src = open(os.path.join(TESTS, ref_file)).read()
        line = re.search(r"^from helpers import (.+)$", src, re.M)
        used = [n for n in FLEET_HELPERS if line and re.search(rf"\b{n}\b", line.group(1))]
        if not used:
            continue
        taking.append(ref_file)
        mod = port_module(ref_file)
        for name in used:
            assert getattr(mod, name).__module__ == "kcp_tpu_torch.scenarios.topology", \
                (ref_file, name)
    assert taking == ["test_migration.py", "test_pagination.py", "test_sharding.py",
                      "test_smartclient.py"]
    migration, sharding = port_module("test_migration.py"), port_module("test_sharding.py")
    for name in ("_apply_ops", "_cm", "_norm", "_normalized_state", "_workload"):
        assert getattr(migration, name) is getattr(sharding, name)
    assert migration._apply_ops.__globals__ is sharding.__dict__


def test_hrw_owners_equal_the_references():
    from kcp_tpu.sharding.ring import owner_name as ref_owner
    from kcp_tpu_torch.sharding.ring import owner_name

    for n in (1, 2, 3, 4, 7):
        names = [f"s{i}" for i in range(n)]
        for c in [f"lc-{i:02d}" for i in range(64)] + ["admin", "*", "ünï", ""]:
            assert owner_name(names, c) == ref_owner(names, c)
    ring = [f"s{i}" for i in range(4)]
    spread = [owner_name(ring, f"lc-{i:02d}") for i in range(16)]
    assert {s: spread.count(s) for s in ring} == {"s0": 1, "s1": 5, "s2": 6, "s3": 4}


def test_scenario_model_names_its_roadmap_entry():
    """The scenario model of ROADMAP A8.3 is ported: the package's names
    resolve to the port's own spec, engine and catalog objects."""
    import kcp_tpu_torch.scenarios as scenarios
    from kcp_tpu_torch.scenarios import catalog, engine, spec

    assert scenarios.SCENARIOS is catalog.SCENARIOS
    assert scenarios.run_scenario is engine.run_scenario
    assert (scenarios.SLO, scenarios.Phase, scenarios.ScenarioSpec) == \
        (spec.SLO, spec.Phase, spec.ScenarioSpec)
    assert sorted(scenarios.__all__) == sorted(
        ("SCENARIOS", "run_scenario", "SLO", "Phase", "ScenarioSpec"))
    assert scenarios.topology.shard_fleet.__module__ == "kcp_tpu_torch.scenarios.topology"


# --------------------------------------------------------- router parity

CLUSTERS = tuple(f"lc-{c}" for c in "abcdefghij")  # 2, 6 and 2 per shard


def _router_script(pkg: str, seed: int) -> list:
    """The seeded request script through one package's 3-shard fleet:
    every response as (what, status, normalised body)."""
    topology = importlib.import_module(f"{pkg}.scenarios.topology")
    rvmap = importlib.import_module(f"{pkg}.sharding.rvmap")
    smart = importlib.import_module(f"{pkg}.client.smart")
    rng = np.random.default_rng(seed)
    out = []

    def call(base, what, method, path, body=None, headers=None):
        host, port = urllib.parse.urlsplit(base).netloc.split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=30)
        try:
            payload = json.dumps(body).encode() if body is not None else None
            conn.request(method, path, body=payload, headers=headers or {})
            resp = conn.getresponse()
            raw = resp.read()
            epoch = resp.getheader("X-Kcp-Ring-Epoch")
        finally:
            conn.close()
        doc = json.loads(raw) if raw else None
        out.append((what, resp.status, _normalise(doc), epoch))
        return doc

    def read_watch(base, path, until: set):
        """A merged watch read until the stream of each shard in
        ``until`` has shown its ``sentinel``: its status and each shard's
        events in stream order (the shards' streams interleave by
        timing; each one's order is fixed). A terminal ERROR lands under
        the key None."""
        host, port = urllib.parse.urlsplit(base).netloc.split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=30)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            streams = {i: [] for i in range(len(ring))}
            while until:
                line = resp.readline()
                assert line, "merged watch ended early"
                ev = json.loads(line)
                if ev["type"] == "ERROR":
                    streams[None] = [ev]
                    break
                meta = ev["object"]["metadata"]
                i = ring.owner_index(meta["clusterName"])
                streams[i].append(ev)
                if meta["name"] == "sentinel":
                    until.discard(i)
            return resp.status, streams
        finally:
            conn.close()

    def cm(name, lc=None, **data):
        meta = {"name": name, "namespace": "default",
                "labels": {"tier": str(int(rng.integers(0, 3)))}}
        if lc:
            meta["clusterName"] = lc
        return {"apiVersion": "v1", "kind": "ConfigMap", "metadata": meta,
                "data": {k: str(v) for k, v in data.items()}}

    def path(lc, name=""):
        base = f"/clusters/{lc}/api/v1/namespaces/default/configmaps"
        return f"{base}/{name}" if name else base

    with topology.shard_fleet(3) as (router, shards, ring):
        r = router.address
        doc = call(r, "ring", "GET", "/ring")
        # the shards' addresses differ between the two fleets
        out[-1] = out[-1][:2] + ({"epoch": doc["epoch"],
                                  "shards": [d["name"] for d in doc["shards"]]}, None)
        # single-cluster CRUD, relayed to each cluster's owner
        names = {lc: [] for lc in CLUSTERS}
        for i in range(24):
            lc = CLUSTERS[int(rng.integers(0, len(CLUSTERS)))]
            names[lc].append(f"cm-{i:02d}")
            call(r, f"create {lc}", "POST", path(lc),
                 cm(f"cm-{i:02d}", v=int(rng.integers(0, 1000))))
        # the merged watch below starts here
        start = call(r, "vector 0", "GET", "/clusters/*/api/v1/configmaps")
        vector = start["metadata"]["resourceVersion"]
        for lc in CLUSTERS:
            for name in names[lc][:2]:
                obj = call(r, f"get {lc}/{name}", "GET", path(lc, name))
                obj["data"] = {"v": str(int(rng.integers(0, 1000)))}
                call(r, f"update {lc}/{name}", "PUT", path(lc, name), obj)
            if len(names[lc]) > 2:
                call(r, f"delete {lc}", "DELETE", path(lc, names[lc].pop()))
        call(r, "missing", "GET", path("lc-a", "nope"))
        # wildcard reads: merged list and its vector RV, pages, selector
        listed = call(r, "wildcard list", "GET", "/clusters/*/api/v1/configmaps")
        out.append(("vector", 200, rvmap.decode_rvmap(
            int(listed["metadata"]["resourceVersion"]), 3), None))
        call(r, "wildcard selector", "GET",
             "/clusters/*/api/v1/configmaps?labelSelector=tier%3D1")
        page, n = call(r, "page 1", "GET", "/clusters/*/api/v1/configmaps?limit=4"), 2
        while (page.get("metadata") or {}).get("continue"):
            tok = urllib.parse.quote(page["metadata"]["continue"])
            page = call(r, f"page {n}", "GET",
                        f"/clusters/*/api/v1/configmaps?limit=4&continue={tok}")
            n += 1
        # a wildcard named GET: unique, ambiguous, absent
        call(r, "wildcard get", "GET", path("*", "cm-00"))
        lc0, lc1 = "lc-a", next(c for c in CLUSTERS
                                if ring.owner_index(c) != ring.owner_index("lc-a"))
        call(r, "twin a", "POST", path(lc0), cm("twin"))
        call(r, "twin b", "POST", path(lc1), cm("twin"))
        call(r, "wildcard get ambiguous", "GET", path("*", "twin"))
        call(r, "wildcard get absent", "GET", path("*", "nowhere"))
        # wildcard writes route through the ring on metadata.clusterName
        call(r, "wildcard create", "POST", path("*"), cm("routed", lc1, r=1))
        call(r, "wildcard create without a cluster", "POST", path("*"), cm("lost"))
        for i, shard in enumerate(shards):
            call(shard.address, f"shard {i} has routed", "GET", path(lc1, "routed"))
        # the merged watch from the first list's vector RV, and a resume
        # from the vector of each shard's first half of its events
        for i in range(3):
            lc = next(c for c in CLUSTERS if ring.owner_index(c) == i)
            call(r, f"sentinel {i}", "POST", path(lc), cm("sentinel"))
        status, events = read_watch(
            r, f"/clusters/*/api/v1/configmaps?watch=true&resourceVersion={vector}",
            {0, 1, 2})
        out.append(("merged watch", status, _normalise(events), None))
        # a DELETED event carries the deleted object's RV, not a stream
        # position: each shard's resume point is its last other event in
        # the first half of its stream
        start, mid, rest = rvmap.decode_rvmap(int(vector), 3), [], {}
        for i in range(3):
            half = [k for k, e in enumerate(events[i][:len(events[i]) // 2])
                    if e["type"] != "DELETED"]
            k = half[-1] if half else -1
            mid.append(int(events[i][k]["object"]["metadata"]["resourceVersion"])
                       if half else start[i])
            rest[i] = events[i][k + 1:]
        mid_vector = rvmap.encode_rvmap(mid)
        status, resumed = read_watch(
            r, f"/clusters/*/api/v1/configmaps?watch=true&resourceVersion={mid_vector}",
            {i for i in range(3) if rest[i]})
        out.append(("resumed watch", status, _normalise(resumed), None))
        assert resumed == rest
        status, gone = read_watch(r, "/clusters/*/api/v1/configmaps?watch=true"
                                     "&resourceVersion=7", {0})
        out.append(("scalar resume", status, _normalise(gone), None))
        # a smart client goes direct to the owner; a stale ring answers 410
        sc = smart.SmartRestClient(r, cluster=lc1)
        try:
            created = sc.create("configmaps", cm("direct", v=1))
        finally:
            sc.close()
        out.append(("smart create", 201, _normalise(created), None))
        owner = ring.owner_index(lc1)
        call(shards[owner].address, "shard get direct", "GET", path(lc1, "direct"),
             headers={"X-Kcp-Ring-Epoch": "1"})
        wrong = shards[(owner + 1) % 3].address
        call(wrong, "stale-epoch create", "POST", path(lc1), cm("stale"),
             headers={"X-Kcp-Ring-Epoch": "1"})
        call(wrong, "unstamped create on a non-owner", "POST", path(lc1), cm("stray"))
        call(r, "final list", "GET", "/clusters/*/api/v1/configmaps")
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_router_responses_equal_the_jax_fleets(seed):
    ref = _router_script("kcp_tpu", seed)
    port = _router_script("kcp_tpu_torch", seed)
    assert [w for w, *_ in port] == [w for w, *_ in ref]
    for (what, *r), (_w, *p) in zip(ref, port):
        assert p == r, what
    got = {w: (s, e) for w, s, _b, e in ref}
    assert got["stale-epoch create"] == (410, "1")
    assert got["wildcard get ambiguous"][0] == 400
    assert got["wildcard create without a cluster"][0] == 400
    assert got["scalar resume"][0] == 200
    assert [s for w, s, _b, _e in ref if w.endswith("has routed")].count(200) == 1
    assert got["shard get direct"][0] == 200 and got["smart create"][0] == 201
    watched = {w: sum(len(v) for v in b.values()) for w, _s, b, _e in ref
               if w.endswith("watch")}
    assert watched["merged watch"] > watched["resumed watch"] > 3
    assert any(w == "page 3" for w, *_ in ref)
