"""The port's REST/watch server, admission, replication and remote store
against the JAX package's, on the CPU.

- The reference's own cases of ``test_server.py``, ``test_admission.py``,
  ``test_authz.py``, ``test_authz_fuzz.py``, ``test_profile.py``,
  ``test_printers.py``, ``test_remote_store.py``, ``test_pool.py``,
  ``test_replication.py``, ``test_group_commit.py``,
  ``test_consistent_reads.py``, ``test_pagination.py``,
  ``test_openapi.py`` and ``test_trace.py``, run against the port
  (``port_module``: the source read with ``kcp_tpu`` as
  ``kcp_tpu_torch``, ``Config`` and the controllers bound to
  ``device="cpu"``; ``helpers.shard_fleet`` bound to the port's), every
  case, the router cases among them.
- REST parity: one seeded request script against the JAX
  ``ServerThread`` and the port's, both in memory, TLS and controllers
  off: equal status codes and bodies after dropping ``metadata.uid`` and
  ``metadata.creationTimestamp`` (minted from randomness and the clock)
  and the Age cell a Table derives from the latter.
- The ledger's device lane: one seeded push-syncer load through each
  package's ``Server`` with controllers on the CPU (the JAX one on JAX
  CPU with its fused backend, the port with ``device="cpu"``): equal
  device counts per key and equal ``quota_usage_device``.
- A router serves with no controllers and no device, and a ring-named
  shard serves; the smart-client names load lazily. What the port
  refuses: ``device=None`` without a card when controllers are
  installed; ``/debug/trace`` answers 503 when its profiler cannot
  start.
"""

import http.client
import importlib
import json
import time
import urllib.parse

import numpy as np
import pytest
import torch

from test_torch_engine import _cases, port_module, run_mirrored

_SKIP: dict = {}
FILES = ("test_server.py", "test_admission.py", "test_authz.py", "test_authz_fuzz.py",
         "test_profile.py", "test_printers.py", "test_remote_store.py", "test_pool.py",
         "test_replication.py", "test_group_commit.py", "test_consistent_reads.py",
         "test_pagination.py", "test_openapi.py", "test_trace.py")
MIRRORED = [c for f in FILES for c in _cases(f, skip=_SKIP.get(f, ()))]

# the fixtures the mirrored files define, against the port (pytest finds
# them as attributes of this module; the autouse ones clear the port's
# fault injector around every test here)
srv = port_module("test_server.py").srv
pair = port_module("test_remote_store.py").pair
_clear_faults = port_module("test_admission.py")._clear_faults
_clean_injector = port_module("test_replication.py")._clean_injector


@pytest.mark.parametrize("ref_file,name,kwargs", MIRRORED)
def test_reference_server_case_against_the_port(ref_file, name, kwargs, request):
    run_mirrored(ref_file, name, kwargs, request)


def test_mirrored_server_files_run_against_the_port():
    from kcp_tpu_torch.server import Config

    bound = port_module("test_server.py").Config
    assert bound.func is Config and bound.keywords == {"device": "cpu"}
    names = {(p.values[0], p.values[1]) for p in MIRRORED}
    # 16 + 25 + 4 + 1 + 4 + 1 + 11 + 6 + 11 + 12 + 8 + 9 + 15 + 2 test
    # functions and the 15 test methods of test_authz.py's,
    # test_printers.py's and test_trace.py's classes
    assert len(names) == 140


# ------------------------------------------------------------ REST parity

TABLE = "application/json;as=Table;v=v1;g=meta.k8s.io"
CLUSTERS = ("lc-a", "lc-b", "lc-c")


def _normalise(doc):
    """Drop the fields minted from randomness and the clock."""
    if isinstance(doc, dict):
        if doc.get("kind") == "Table":
            age = [i for i, c in enumerate(doc.get("columnDefinitions", []))
                   if c.get("name") == "Age"]
            for row in doc.get("rows", []):
                for i in age:
                    row["cells"][i] = "<age>"
        meta = doc.get("metadata")
        if isinstance(meta, dict):
            meta.pop("uid", None)
            meta.pop("creationTimestamp", None)
        return {k: _normalise(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_normalise(v) for v in doc]
    return doc


def _rest_script(pkg: str, seed: int) -> list:
    """The seeded request script against one package's server: every
    response as (what, status, normalised body)."""
    server = importlib.import_module(f"{pkg}.server")
    threaded = importlib.import_module(f"{pkg}.server.threaded")
    rng = np.random.default_rng(seed)
    out = []
    with threaded.ServerThread(server.Config(durable=False, tls=False,
                                             install_controllers=False)) as st:
        host, port = urllib.parse.urlsplit(st.address).netloc.split(":")

        def call(what, method, path, body=None, headers=None):
            conn = http.client.HTTPConnection(host, int(port), timeout=30)
            try:
                payload = json.dumps(body).encode() if body is not None else None
                conn.request(method, path, body=payload, headers=headers or {})
                resp = conn.getresponse()
                raw = resp.read()
            finally:
                conn.close()
            try:
                doc = json.loads(raw)
            except ValueError:
                doc = raw.decode()
            out.append((what, resp.status, _normalise(doc)))
            return doc

        def cm_path(lc, name=""):
            base = f"/clusters/{lc}/api/v1/namespaces/default/configmaps"
            return f"{base}/{name}" if name else base

        call("quota", "POST",
             "/clusters/lc-c/api/v1/namespaces/default/resourcequotas",
             {"apiVersion": "v1", "kind": "ResourceQuota",
              "metadata": {"name": "budget", "namespace": "default"},
              "spec": {"hard": {"configmaps": 4}}})
        names = {lc: [] for lc in CLUSTERS}
        for i in range(18):
            lc = CLUSTERS[int(rng.integers(0, 3))]
            name = f"cm-{i:02d}"
            names[lc].append(name)
            call(f"create {lc}/{name}", "POST", cm_path(lc), {
                "apiVersion": "v1", "kind": "ConfigMap",
                "metadata": {"name": name, "namespace": "default",
                             "labels": {"tier": str(int(rng.integers(0, 3)))}},
                "data": {"v": str(int(rng.integers(0, 1000)))}})
        watch_from = call("rv", "GET", "/version")["resourceVersion"]
        for lc in CLUSTERS:
            for name in names[lc][:3]:
                obj = call(f"get {lc}/{name}", "GET", cm_path(lc, name))
                if "metadata" not in obj:
                    continue
                obj["data"] = {"v": str(int(rng.integers(0, 1000)))}
                call(f"update {lc}/{name}", "PUT", cm_path(lc, name), obj)
            if names[lc]:
                victim = names[lc][int(rng.integers(0, len(names[lc])))]
                call(f"delete {lc}/{victim}", "DELETE", cm_path(lc, victim))
        call("over quota", "POST", cm_path("lc-c"), {
            "apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": "one-too-many", "namespace": "default"}})
        call("wildcard list", "GET", "/clusters/*/api/v1/configmaps")
        call("wildcard selector list", "GET",
             "/clusters/*/api/v1/configmaps?labelSelector=tier%3D1")
        page = call("page 1", "GET", "/clusters/*/api/v1/configmaps?limit=5")
        n = 2
        while (page.get("metadata") or {}).get("continue"):
            tok = urllib.parse.quote(page["metadata"]["continue"])
            page = call(f"page {n}", "GET",
                        f"/clusters/*/api/v1/configmaps?limit=5&continue={tok}")
            n += 1
        call("table", "GET", cm_path("lc-a"), headers={"Accept": TABLE})
        tip = int(call("rv", "GET", "/version")["resourceVersion"])
        # the watch from the RV before the updates, read to the tip
        conn = http.client.HTTPConnection(host, int(port), timeout=30)
        try:
            conn.request("GET", "/clusters/*/api/v1/configmaps?watch=true"
                                f"&resourceVersion={watch_from}")
            resp = conn.getresponse()
            events = []
            while True:
                line = resp.readline()
                assert line, "watch ended before the tip"
                ev = json.loads(line)
                events.append(_normalise(ev))
                if int(ev["object"]["metadata"]["resourceVersion"]) >= tip:
                    break
            out.append(("watch", resp.status, events))
        finally:
            conn.close()
        call("openapi", "GET", "/clusters/lc-a/openapi/v2")
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_rest_responses_equal_the_jax_servers(seed):
    ref = _rest_script("kcp_tpu", seed)
    port = _rest_script("kcp_tpu_torch", seed)
    assert [w for w, _s, _b in port] == [w for w, _s, _b in ref]
    for (what, rs, rb), (_w, ps, pb) in zip(ref, port):
        assert (ps, pb) == (rs, rb), what
    statuses = {s for _w, s, _b in ref}
    assert {200, 201, 403} <= statuses  # the quota denial is in the script
    assert any(w == "page 2" for w, _s, _b in ref)


# ---------------------------------------------------- the ledger's device lane


def _ledger_load(pkg: str, seed: int, n_logical: int = 2, n_physical: int = 2,
                 roots: int = 6) -> tuple[dict, float]:
    """A seeded push-syncer load through one package's ``Server``:
    every logical cluster registers every fake physical cluster and
    creates seeded root Deployments; returns the ledger's device counts
    per (logical cluster, resource) once every leaf is downstream and
    the lane has settled, and ``quota_usage_device``."""
    capi = importlib.import_module(f"{pkg}.apis.cluster")
    fake = importlib.import_module(f"{pkg}.physical")
    server = importlib.import_module(f"{pkg}.server")
    threaded = importlib.import_module(f"{pkg}.server.threaded")
    trace = importlib.import_module(f"{pkg}.utils.trace")
    rng = np.random.default_rng(seed)
    kw = {"device": "cpu"} if pkg == "kcp_tpu_torch" else {}
    registry = fake.PhysicalRegistry()
    pcs = [f"pc-{j}" for j in range(n_physical)]
    lcs = [f"lc-{i}" for i in range(n_logical)]
    phys = {pc: registry.resolve(f"fake://{pc}") for pc in pcs}
    st = threaded.ServerThread(server.Config(
        durable=False, tls=False, poll_interval=0.2, import_poll_interval=0.2,
        auto_publish_apis=True, **kw), registry=registry).start(120)
    agents = []

    async def start_agents():
        for pc in pcs:
            agents.append(fake.FakeClusterAgent(phys[pc]))
            await agents[-1].start()

    async def stop_agents():
        for a in agents:
            await a.stop()

    try:
        st.submit(start_agents())
        mc = server.MultiClusterRestClient(st.address)
        for lc in lcs:
            for pc in pcs:
                mc.cluster_client(lc).create(capi.CLUSTERS,
                                             capi.new_cluster(f"{lc}-{pc}", f"fake://{pc}"))
        want = 0
        for lc in lcs:
            for k in range(roots):
                replicas = int(rng.integers(1, 101))
                want += n_physical
                body = {"apiVersion": "apps/v1", "kind": "Deployment",
                        "metadata": {"name": f"app-{k}", "namespace": "default"},
                        "spec": {"replicas": replicas}}
                deadline = time.monotonic() + 60
                while True:  # 404 until the import publishes deployments
                    try:
                        mc.cluster_client(lc).create("deployments.apps", body)
                        break
                    except Exception:  # noqa: BLE001
                        assert time.monotonic() < deadline, "deployments never served"
                        time.sleep(0.1)
        ledger = st.server.handler.admission.ledger

        def lane():
            return {lc: ledger.device_usage_of(lc, "deployments.apps") for lc in lcs}

        deadline = time.monotonic() + 120
        while True:
            down = st.call(lambda: sum(len(c.list("deployments.apps")[0])
                                       for c in phys.values()))
            if down == want and set(lane().values()) == {roots * n_physical}:
                break
            assert time.monotonic() < deadline, (down, lane())
            time.sleep(0.1)
        usage = trace.REGISTRY.gauge("quota_usage_device").value
        return lane(), usage
    finally:
        if agents:
            st.submit(stop_agents())
        st.stop()


def test_ledger_device_lane_equals_the_jax_servers():
    ref = _ledger_load("kcp_tpu", 5)
    port = _ledger_load("kcp_tpu_torch", 5)
    assert port == ref
    assert ref[0] == {"lc-0": 12, "lc-1": 12} and ref[1] == 24


# --------------------------------------------------------------- refusals


def test_router_and_fleet_name_their_roadmap_entry(monkeypatch):
    """A router (``Config(role="router")``) serves with no store, no
    controllers and no device, and a shard named in a ring serves and
    verifies ring-stamped requests; fleet placement (``Config(fleet=True)``
    or ``KCP_FLEET=1``) serves, with a ``FleetScheduler`` after the
    splitter among the controllers."""
    from kcp_tpu_torch.fleet.scheduler import FleetScheduler
    from kcp_tpu_torch.reconcilers.deployment import DeploymentSplitter
    from kcp_tpu_torch.server import Config, RestClient, Server
    from kcp_tpu_torch.server.threaded import ServerThread
    from kcp_tpu_torch.sharding import RouterHandler

    def controllers(config):
        st = ServerThread(config).start()
        try:
            return [type(c) for c in st.server._controllers]
        finally:
            st.stop()

    kinds = controllers(Config(durable=False, tls=False, device="cpu", fleet=True))
    assert FleetScheduler in kinds
    assert kinds.index(FleetScheduler) > kinds.index(DeploymentSplitter)
    assert FleetScheduler not in controllers(Config(durable=False, tls=False, device="cpu"))
    monkeypatch.setenv("KCP_FLEET", "1")
    assert FleetScheduler in controllers(Config(durable=False, tls=False, device="cpu"))
    Server(Config(durable=False, tls=False, install_controllers=False))  # serve-only
    monkeypatch.delenv("KCP_FLEET")
    with ServerThread(Config(durable=False, tls=False, install_controllers=False,
                             shard_name="s0", ring_names="s0,s1")) as shard:
        assert shard.server.handler.ring_names == ("s0", "s1")
        # the default device is the card: the router never asks for one
        with ServerThread(Config(role="router", shards=f"s0={shard.address}",
                                 durable=False, tls=False)) as router:
            server = router.server
            assert isinstance(server.handler, RouterHandler)
            assert server.store is None and server._controllers == []
            assert server.device is None and server.mesh is None
            assert not server.install_controllers
            assert RestClient(router.address).request_raw("GET", "/readyz")[0] == 200
    with pytest.raises(ValueError, match="not in --ring-names"):
        Server(Config(durable=False, tls=False, install_controllers=False,
                      shard_name="s2", ring_names="s0,s1"))


def test_no_smart_client_names_in_the_ports_client():
    """The five smart-client names resolve lazily: importing the client
    package alone does not load ``client.smart`` (which pulls in the
    serving stack)."""
    import subprocess
    import sys

    names = ("SmartRestClient", "SmartMultiClusterRestClient", "rest_client",
             "multicluster_rest_client", "smart_enabled")
    code = ("import sys, kcp_tpu_torch.client as c; "
            "assert 'kcp_tpu_torch.client.smart' not in sys.modules; "
            f"got = [getattr(c, n).__module__ for n in {names!r}]; "
            "assert 'kcp_tpu_torch.client.smart' in sys.modules; print(set(got))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "{'kcp_tpu_torch.client.smart'}"
    import kcp_tpu_torch.client as client

    assert set(names) <= set(client.__all__)
    with pytest.raises(AttributeError):
        client.NoSuchClient  # noqa: B018


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the host without a card")
def test_controllers_without_a_card_refuse_the_default_device():
    from kcp_tpu_torch.server import Config, Server

    with pytest.raises(RuntimeError, match="CUDA card by default"):
        Server(Config(durable=False, tls=False))
    # serve-only needs no device
    s = Server(Config(durable=False, tls=False, install_controllers=False))
    assert s.device is None and s.mesh is None


def test_controllers_on_a_cpu_mesh():
    from kcp_tpu_torch.server import Config, Server

    s = Server(Config(durable=False, tls=False, device="cpu", mesh="4x2"))
    assert s.mesh.shape == {"tenants": 4, "slots": 2}
    assert s.device == torch.device("cpu")


def test_debug_trace_answers_503_when_the_profiler_cannot_start():
    import asyncio

    from kcp_tpu_torch.apis.scheme import default_scheme
    from kcp_tpu_torch.server.handler import RestHandler
    from kcp_tpu_torch.server.httpd import Request
    from kcp_tpu_torch.store import LogicalStore

    async def main(d):
        handler = RestHandler(LogicalStore(), default_scheme())
        return await handler(Request("GET", "/debug/trace",
                                     {"seconds": ["0.05"], "dir": [d]}, {}, b""))

    import tempfile

    with tempfile.TemporaryDirectory() as d:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            busy = asyncio.run(main(d))
        ok = asyncio.run(main(d))
    assert busy.status == 503 and json.loads(busy.body)["started"] is False
    assert ok.status == 200 and json.loads(ok.body)["trace"].endswith("trace.json")
