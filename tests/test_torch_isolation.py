"""The port stands alone: it never loads JAX or any module of the JAX
package.

``tests/conftest.py`` imports JAX into every test process, so the
runtime check imports every module of the port, drives a tiny CPU closed
loop through its FusedCore, serves a few objects through
``start_syncer`` on a 2 x ``cpu`` mesh, runs the kubecon demo scenario
through the controller plane, and starts ``kcp start``'s ``Server`` with
its controllers on the CPU, registers one fake cluster and syncs one
Deployment over REST and takes a ``/debug/trace``, solves a placement with
``fleet/solver.py`` and places roots through ``kcp start`` with the fleet
scheduler (``fleet/scheduler.py``), serves through a 2-shard fleet of
``scenarios/topology.py`` behind the router (``sharding/``) with a smart
client (``client/smart.py``), runs the sharded front door
(``demo.sharded_front_door_load``) and a ``crud-churn`` scenario through
the scenario harness (``scenarios/``) at a tiny size, all in a fresh
interpreter (``-I``: no user site, no PYTHONPATH hooks) and inspects its
``sys.modules``. The bench's sharded lanes start children of their own:
a ``kcp start`` shard and a ``--shard-loadgen`` writer run the same way
through a wrapper that reports their modules as they exit, torch among
them, and so does the ``--watchers`` lane's ``--watchers-serve`` server:
none of them runs controllers, so none loads torch. Each entry point
of such a process imports without loading torch, and a server that does
install controllers loads it and places its core on the device it was
given (without a card and without a device it refuses to start). A static scan
of the port's sources and of ``chip_smoke.py`` backs it up for code the
loop does not reach.
"""

import ast
import json
import os
import signal
import subprocess
import sys
import threading

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "kcp_tpu_torch")

_PROBE = r"""
import asyncio, importlib, json, pkgutil, sys
sys.path.insert(0, REPO)
import torch
torch.set_num_threads(1)
import kcp_tpu_torch
for mod in pkgutil.walk_packages(kcp_tpu_torch.__path__, "kcp_tpu_torch."):
    importlib.import_module(mod.name)
from kcp_tpu_torch.bench import closed_loop
from kcp_tpu_torch.reconciler.fairqueue import make_queue
from kcp_tpu_torch.syncer.core import FusedCore

core = FusedCore(batch_window=0.0005, device="cpu")
out = asyncio.run(closed_loop(core, 512, 16, churn=16, seconds=0.3,
                              warmup_ticks=3))

# the serving entry point over two stores, sharded on a 2 x cpu mesh
from kcp_tpu_torch.client import Client
from kcp_tpu_torch.parallel import mesh_from_spec
from kcp_tpu_torch.store import LogicalStore
from kcp_tpu_torch.syncer import start_syncer
from kcp_tpu_torch.syncer.engine import CLUSTER_LABEL


async def serve():
    up, down = Client(LogicalStore(), "t"), Client(LogicalStore(), "p")
    mesh = mesh_from_spec("2", devices=[torch.device("cpu")] * 2)
    syncer = await start_syncer(up, down, ["configmaps"], "c1", mesh=mesh)
    for i in range(8):
        up.create("configmaps", {"apiVersion": "v1", "kind": "ConfigMap",
                  "metadata": {"name": f"cm-{i}", "namespace": "default",
                               "labels": {CLUSTER_LABEL: "c1"}}, "data": {"v": str(i)}})
    for _ in range(2000):
        if len(down.list("configmaps")[0]) == 8:
            break
        await asyncio.sleep(0.005)
    n = len(down.list("configmaps")[0])
    sharded = type(syncer.engines[0].core._fleet._state.up_vals).__name__
    await syncer.stop()
    return n, sharded


synced, sharded = asyncio.run(serve())

# the controller plane: the kubecon scenario (clusters registered,
# schemas imported and negotiated, a Deployment split, synced down and
# its status summed back)
from kcp_tpu_torch import demo

kubecon = asyncio.run(demo.run("kubecon", device="cpu"))

# the front door: the server with its controllers, over REST
import tempfile

front = demo.front_door_load("cpu", 1, 1, 1, timeout=60.0, trace_dir=tempfile.mkdtemp())

# fleet placement: the solver alone and the scheduler through kcp start
import numpy as np
from kcp_tpu_torch.fleet.solver import FleetSolver

placed = FleetSolver(spread=1, device="cpu").solve(
    np.array([3], np.int32), np.ones((1, 2), bool), np.array([5, 9], np.int32),
    np.zeros(2, np.int32), np.zeros(1, np.int32)).tolist()
fleet = demo.fleet_front_door_load("cpu", 1, 2, 2, timeout=60.0)

# the sharded control plane: a router fleet, a smart client, phase 10's load
import kcp_tpu_torch.client as client_pkg
from kcp_tpu_torch.scenarios.topology import shard_fleet

with shard_fleet(2) as (router, _shards, _ring):
    smart = client_pkg.SmartRestClient(router.address, cluster="lc-x")
    smart.create("configmaps", {"apiVersion": "v1", "kind": "ConfigMap",
                 "metadata": {"name": "direct", "namespace": "default"}})
    smart.close()
    fleet_items = [o["metadata"]["name"] for o in
                   client_pkg.multicluster_rest_client(router.address).list("configmaps")[0]]
plane = demo.sharded_front_door_load("cpu", 2, 1, 1, n_shards=2, timeout=60.0)

# the scenario harness: one catalog scenario through the engine
from kcp_tpu_torch.scenarios import SCENARIOS, run_scenario

scenario = run_scenario(SCENARIOS["crud-churn"], seed=42, scale=0.25,
                        workdir=tempfile.mkdtemp(), device="cpu")
modules = {m for m in ("kcp_tpu_torch.sharding.router", "kcp_tpu_torch.client.smart",
                       "kcp_tpu_torch.scenarios.topology") if m in sys.modules}
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "kcp_tpu"))
print(json.dumps({"converged": out["converged"], "ticks": out["ticks"],
                  "queue": type(core.controller.queue).__name__,
                  "fair": type(make_queue("probe")).__name__,
                  "synced": synced, "sharded": sharded,
                  "kubecon": kubecon, "golden": demo.golden(),
                  "front": [front["leaves"], front["device_lane"], front["trace"]["started"]],
                  "placed": placed, "fleet": fleet["capacity_change"]["first_solve_rows"],
                  "fleet_items": fleet_items, "plane": plane["roots"],
                  "scenario": [scenario["passed"], scenario["schedule"]["hash"]],
                  "modules": sorted(modules),
                  "loaded": loaded}))
"""


def test_port_closed_loop_loads_no_jax_and_no_reference_module():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-I", "-c", _PROBE.replace("REPO", repr(REPO))],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["loaded"] == [], f"port loaded {res['loaded']}"
    assert res["converged"] and res["ticks"] > 0
    assert res["synced"] == 8 and res["sharded"] == "ShardedTensor"
    assert res["kubecon"][0] == "=== demo: kubecon ==="
    assert res["kubecon"] == res["golden"][-len(res["kubecon"]):]
    assert res["front"] == [1, {"lc-00": 1}, True]
    assert res["placed"] == [[0, 3]] and res["fleet"] == 2
    assert res["fleet_items"] == ["direct"] and res["plane"] == 2
    assert res["scenario"] == [True, "c200cb6c90259953"]
    assert len(res["modules"]) == 3
    # the controller's queue is the native fair queue when the repo's
    # library builds, else the plain one: either is the port's own class
    assert res["queue"] in ("FairWorkQueue", "WorkQueue")


# runs a module of the port as ``python -m`` would and, as it exits,
# prints the torch, JAX and JAX-package modules it loaded
_WRAPPED = r"""
import atexit, json, runpy, sys
sys.path.insert(0, REPO)
atexit.register(lambda: print("EXIT " + json.dumps(sorted(
    m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "jaxlib", "kcp_tpu"))),
    flush=True))
sys.argv[0] = MODULE
runpy.run_module(MODULE, run_name="__main__", alter_sys=True)
"""


def _wrapped(module: str, *args: str, env_extra: dict | None = None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    code = _WRAPPED.replace("REPO", repr(REPO)).replace("MODULE", repr(module))
    return subprocess.Popen([sys.executable, "-I", "-c", code, *args], env=env, cwd=REPO,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _exit_report(proc) -> list:
    """The modules a wrapped child reports as it exits. Both pipes are read
    through their file objects, in threads while the child runs down: a
    ``readline()`` may already have read the EXIT line ahead into the
    object's buffer, where ``communicate()``, which reads the pipe itself,
    would not see it."""
    got = {}
    readers = [threading.Thread(target=lambda k=k, f=f: got.__setitem__(k, f.read()),
                                daemon=True)
               for k, f in (("out", proc.stdout), ("err", proc.stderr))]
    for t in readers:
        t.start()
    proc.stdin.close()
    try:
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
        for t in readers:
            t.join(60)
    lines = [x for x in got.get("out", "").splitlines() if x.startswith("EXIT ")]
    assert proc.returncode == 0 and lines, f"rc {proc.returncode}: {got.get('err', '')[-3000:]}"
    return json.loads(lines[-1][5:])


def test_sharded_lanes_children_load_no_jax_and_no_reference_module():
    """The children of ``--sharded``: a ``kcp start`` shard as the lanes
    spawn it (``scenarios.topology.spawn_server``'s arguments) and a
    ``--shard-loadgen`` writer against it (``bench.LOADGEN_ARGV``)."""
    from kcp_tpu_torch import bench

    assert bench.LOADGEN_ARGV[1:] == ["-m", "kcp_tpu_torch.bench", "--shard-loadgen"]
    shard = _wrapped("kcp_tpu_torch.cli.kcp", "start", "--no-install-controllers",
                     "--no-tls", "--syncer-mode", "none", "--in-memory", "--listen-port", "0")
    try:
        line = shard.stdout.readline()
        assert line.startswith("kcp-tpu serving at "), line + shard.stderr.read()[-3000:]
        url = line.split()[-1]
        loadgen = _wrapped("kcp_tpu_torch.bench", "--shard-loadgen", env_extra={
            "KCP_LG_SPEC": f"s0={url}", "KCP_LG_CLUSTERS": "t0,t1",
            "KCP_LG_SECONDS": "0.2", "KCP_LG_PREFIX": "iso"})
        assert loadgen.stdout.readline().strip() == "ready"
        loadgen.stdin.write("go\n")
        loadgen.stdin.flush()
        writes = json.loads(loadgen.stdout.readline())["writes"]
        assert writes > 0
        assert _exit_report(loadgen) == []
    finally:
        shard.send_signal(signal.SIGTERM)
    assert _exit_report(shard) == []


def test_watchers_serve_child_loads_no_torch_jax_or_reference_module():
    """The ``--watchers`` lane's server child (``bench.WATCHERS_SERVE_ARGV``)
    serves its seeded store with no controller, so it loads no torch."""
    from kcp_tpu_torch import bench

    assert bench.WATCHERS_SERVE_ARGV[1:] == ["-m", "kcp_tpu_torch.bench", "--watchers-serve"]
    child = _wrapped("kcp_tpu_torch.bench", "--watchers-serve", env_extra={
        "KCP_WB_OBJECTS": "200", "KCP_WB_CLUSTERS": "2"})
    try:
        info = json.loads(child.stdout.readline() or "{}")
        assert info.get("objects") == 200, child.stderr.read()[-3000:]
    finally:
        child.send_signal(signal.SIGTERM)
    assert _exit_report(child) == []


# the entry points of processes that run no controllers: importing one
# loads no torch, as importing the reference's counterpart loads no jax
TORCH_FREE = ("kcp_tpu_torch.cli.kcp", "kcp_tpu_torch.server",
              "kcp_tpu_torch.scenarios.topology", "kcp_tpu_torch.bench",
              "kcp_tpu_torch.obs.__main__")


@pytest.mark.parametrize("module", TORCH_FREE)
def test_controller_less_entry_point_imports_no_torch(module):
    code = (f"import sys; sys.path.insert(0, {REPO!r}); import {module}; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'kcp_tpu')))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True,
                          text=True, timeout=60, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "[]", f"{module} loaded {proc.stdout.strip()}"


_CONTROLLERS = r"""
import json, sys
sys.path.insert(0, REPO)
from kcp_tpu_torch.server import Config
from kcp_tpu_torch.server.threaded import ServerThread

before = "torch" in sys.modules
with ServerThread(Config(durable=False, tls=False, device="cpu")) as st:
    from kcp_tpu_torch.syncer.core import FusedCore

    cores = st.call(lambda: [str(c.device) for c in FusedCore._instances.values()])
    got = {"before": before, "after": "torch" in sys.modules,
           "installed": st.server.install_controllers,
           "device": str(st.server.device), "cores": cores}
# no device named and no card: the server refuses to start (no CPU fallback)
import torch

if not torch.cuda.is_available():
    try:
        ServerThread(Config(durable=False, tls=False)).start()
        got["no_card"] = "started"
    except RuntimeError as err:
        got["no_card"] = str(err.__cause__)
print(json.dumps(got))
"""


def test_controller_installing_server_loads_torch_on_its_device():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-I", "-c", _CONTROLLERS.replace("REPO", repr(REPO))],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["installed"] and not got["before"] and got["after"], got
    assert got["device"] == "cpu" and got["cores"] == ["cpu"], got
    if "no_card" in got:
        assert "runs on a CUDA card by default" in got["no_card"], got


def _sources():
    for root, _dirs, files in os.walk(PORT):
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(root, fn)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "tests", "test_torch_cuda.py")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_nothing_of_jax_or_the_reference(path):
    tree = ast.parse(open(path).read(), path)
    rel = os.path.relpath(path, REPO)
    # how many package levels a relative import may climb and stay inside
    # kcp_tpu_torch (a module at kcp_tpu_torch/a/b.py may use up to 2 dots)
    depth = rel.count(os.sep) if rel.startswith("kcp_tpu_torch") else 0
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                assert node.level <= depth, f"{rel}: relative import leaves the port"
                continue
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "kcp_tpu"), f"{rel} imports {name}"
