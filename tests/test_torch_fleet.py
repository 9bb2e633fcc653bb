"""The port's fleet placement (``kcp_tpu_torch/fleet/``) against the JAX
package's, on the CPU.

- The reference's own cases of ``test_fleet_placement.py`` (solver,
  inventory, scheduler) and ``test_faults.py`` (every fault point,
  ``fleet.solve`` included), run against the port
  (``test_torch_engine.port_module``). Left out:
  ``test_fleet_placement.py::test_solver_differential_fuzz_device_equals_host``,
  which calls JAX ``solve_batched`` with ``jnp.int32`` scalars;
  ``test_solver_fuzz_port_equals_jax_and_host`` below takes the same 4
  seeds x 25 draws through the port's ``solve_batched`` and holds it
  byte-equal to both JAX ``solve_batched`` (JAX CPU) and ``solve_host``.
- The port's solver against JAX ``solve_batched`` and ``solve_host`` at
  the placement benchmark's shape (10,000 workspaces x 8 physical
  clusters, spread 2, seed 17), full and the 37-row incremental
  re-solve; ties, zero demand, no eligible cluster, a home region of -1
  and the int32 clips; ``solve_sharded`` over meshes ``4`` and ``4x2``
  of repeated CPU devices equal to the unsharded solve.
- One seeded scheduler load through each package (``DeploymentSplitter``
  on its fused lane + ``FleetScheduler``, the port on the CPU, the
  reference on JAX CPU): equal leaf sets.

Every comparison is exact equality.
"""

import asyncio

import numpy as np
import pytest
import torch

from kcp_tpu.fleet import solver as jsolver
from kcp_tpu_torch.fleet import solver as psolver
from test_torch_engine import _cases, port_module, run_mirrored

_SKIP = {
    "test_fleet_placement.py": ("test_solver_differential_fuzz_device_equals_host",),
}
FILES = ("test_fleet_placement.py", "test_faults.py")
MIRRORED = [c for f in FILES for c in _cases(f, skip=_SKIP.get(f, ()))]


@pytest.mark.parametrize("ref_file,name,kwargs", MIRRORED)
def test_reference_fleet_case_against_the_port(ref_file, name, kwargs, request):
    run_mirrored(ref_file, name, kwargs, request)


def test_mirrored_fleet_files_leave_out_only_the_jax_fuzz():
    names = {(p.values[0], p.values[1]) for p in MIRRORED}
    assert ("test_fleet_placement.py", "test_solver_sharded_by_mesh_matches_host") in names
    assert ("test_faults.py", "test_fleet_solve_fault_drill_requeues_then_converges") in names
    assert ("test_fleet_placement.py",
            "test_solver_differential_fuzz_device_equals_host") not in names
    assert port_module("test_fleet_placement.py").FleetSolver is psolver.FleetSolver
    # 12 - 1 + 33 test functions
    assert len(names) == 44


# ------------------------------------------------------------ solver parity


def _port_batched(demand, cand, alloc, region, home, spread, lw) -> np.ndarray:
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    out = psolver.solve_batched(t(demand), t(cand), t(alloc), t(region), t(home), spread, lw)
    assert out.dtype == torch.int32
    return out.numpy()


def _jax_batched(demand, cand, alloc, region, home, spread, lw) -> np.ndarray:
    import jax.numpy as jnp

    return np.asarray(jsolver.solve_batched(demand, cand, alloc, region, home,
                                            jnp.int32(spread), jnp.int32(lw)))


def _all_equal(demand, cand, alloc, region, home, spread, lw) -> np.ndarray:
    """The port's batched solve, JAX's, and both host twins: one answer."""
    host = psolver.solve_host(demand, cand, alloc, region, home, spread, lw)
    assert np.array_equal(host, jsolver.solve_host(demand, cand, alloc, region, home,
                                                   spread, lw))
    assert np.array_equal(_port_batched(demand, cand, alloc, region, home, spread, lw), host)
    assert np.array_equal(_jax_batched(demand, cand, alloc, region, home, spread, lw), host)
    return host


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_solver_fuzz_port_equals_jax_and_host(seed):
    """``test_solver_differential_fuzz_device_equals_host``'s 4 seeds x 25
    draws: the port's ``solve_batched`` byte-equal to JAX's and to the
    host twin, and every assignment a valid bin-pack."""
    rng = np.random.default_rng(seed)
    for _ in range(25):
        W = int(rng.integers(1, 48))
        P = int(rng.integers(1, 24))
        demand = rng.integers(0, 2000, W).astype(np.int32)
        cand = rng.random((W, P)) < rng.uniform(0.2, 1.0)
        alloc = np.maximum(
            0, np.round(64 * rng.lognormal(0.0, rng.uniform(0.2, 2.0), P))
        ).astype(np.int32)
        region = rng.integers(0, 5, P).astype(np.int32)
        home = rng.integers(0, 5, W).astype(np.int32)
        spread = int(rng.integers(0, 6))
        lw = int(rng.choice([0, 64, psolver.DEFAULT_LOCALITY_WEIGHT]))
        host = _all_equal(demand, cand, alloc, region, home, spread, lw)
        elig = cand & (alloc > 0)[None, :]
        placeable = elig.any(axis=-1)
        assert (host.sum(axis=-1)[placeable] == demand[placeable]).all()
        assert (host[~placeable] == 0).all()
        assert ((host > 0) <= elig).all()
        if spread:
            assert ((host > 0).sum(axis=-1) <= spread).all()


def test_solver_edge_cases_equal_jax_and_host():
    lw = psolver.DEFAULT_LOCALITY_WEIGHT
    # ties: equal capacity everywhere, the lowest column wins (spread 1),
    # the remainder goes to the lowest columns (spread 0)
    out = _all_equal(np.array([1, 5], np.int32), np.ones((2, 4), bool),
                     np.full(4, 7, np.int32), np.zeros(4, np.int32),
                     np.array([5, 5], np.int32), 1, lw)
    assert out.tolist() == [[1, 0, 0, 0], [5, 0, 0, 0]]
    out = _all_equal(np.array([6], np.int32), np.ones((1, 4), bool), np.full(4, 7, np.int32),
                     np.zeros(4, np.int32), np.array([5], np.int32), 0, lw)
    assert out.tolist() == [[2, 2, 1, 1]]
    # zero demand; no eligible cluster (no candidate, or no capacity)
    cand = np.array([[True, True], [False, False], [True, True]])
    out = _all_equal(np.array([0, 9, 9], np.int32), cand, np.array([0, 0], np.int32),
                     np.zeros(2, np.int32), np.zeros(3, np.int32), 0, lw)
    assert (out == 0).all()
    out = _all_equal(np.array([0, 9, 9], np.int32), cand, np.array([3, 5], np.int32),
                     np.zeros(2, np.int32), np.zeros(3, np.int32), 0, lw)
    assert out.tolist() == [[0, 0], [0, 0], [3, 6]]
    # a home region of -1 matches no region: capacity alone decides
    out = _all_equal(np.array([10, 10], np.int32), np.ones((2, 3), bool),
                     np.array([100, 400, 50], np.int32), np.array([0, 1, 0], np.int32),
                     np.array([-1, 0], np.int32), 1, lw)
    assert out.tolist() == [[0, 10, 0], [10, 0, 0]]
    # the int32 clips: demand past 65535 and capacity past 32767
    out = _all_equal(np.array([70000, 70000], np.int32), np.ones((2, 3), bool),
                     np.array([40000, 40000, 20000], np.int32), np.array([0, 1, 2], np.int32),
                     np.array([2, -1], np.int32), 0, lw)
    assert out.sum(axis=1).tolist() == [psolver.DEMAND_CLIP] * 2
    assert out[1, 0] == out[1, 1]  # both clipped to the same weight


def _bench_inputs():
    from kcp_tpu_torch.bench import placement_inputs

    return placement_inputs(10000, 8, 37)


def test_bench_shape_full_and_incremental_equal_jax_and_host():
    """The placement benchmark's shape (10,000 workspaces x 8 physical
    clusters, spread 2, seed 17; ``BENCH_r11_placement.json``): the
    port's ``FleetSolver`` on the CPU, JAX's on JAX CPU and the host twin
    agree, full and on the 37-row incremental re-solve, which touches
    exactly those rows."""
    import json
    import os

    x = _bench_inputs()
    args = [x[k] for k in ("demand", "cand", "alloc", "region", "home")]
    port = psolver.FleetSolver(spread=2, device="cpu")
    ref = jsolver.FleetSolver(spread=2)
    full = port.solve(*args).copy()
    host = psolver.solve_host(*args, 2)
    assert np.array_equal(full, host)
    assert np.array_equal(ref.solve(*args), host)
    recorded = json.load(open(os.path.join(os.path.dirname(__file__), "..",
                                           "BENCH_r11_placement.json")))["placement_bench"]
    assert int(host.sum()) == recorded["total_replicas"]
    assert int((full.sum(axis=1) > x["demand"]).sum()) == 0
    assert int(full[~x["cand"]].sum()) == 0
    rows = [int(i) for i in x["dirty_rows"]]
    args[1] = x["cand2"]
    before = port.stats["rows_solved"]
    inc = port.solve(*args, rows=rows)
    assert port.stats["rows_solved"] - before == 37
    host2 = psolver.solve_host(*args, 2)
    assert np.array_equal(inc, host2)
    assert np.array_equal(ref.solve(*args, rows=rows), host2)


@pytest.mark.parametrize("spec", ["4", "4x2"])
def test_solve_sharded_equals_unsharded(spec):
    from kcp_tpu_torch.parallel.mesh import mesh_from_spec

    mesh = mesh_from_spec(spec, devices=[torch.device("cpu")] * 8)
    x = _bench_inputs()
    args = [x[k][:1001] for k in ("demand", "cand", "home")]  # not a multiple of 4
    demand, cand, home = args
    whole = psolver.FleetSolver(spread=2, device="cpu").solve(
        demand, cand, x["alloc"], x["region"], home)
    out = psolver.solve_sharded(mesh, demand, cand, x["alloc"], x["region"], home, 2)
    assert np.array_equal(out, whole)
    meshed = psolver.FleetSolver(spread=2, device="cpu", mesh=mesh)
    assert np.array_equal(meshed.solve(demand, cand, x["alloc"], x["region"], home), whole)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the host without a card")
def test_fused_solver_without_a_card_refuses_the_default_device():
    with pytest.raises(RuntimeError, match="CUDA card by default"):
        psolver.FleetSolver()
    assert psolver.FleetSolver(backend="host").device is None


# -------------------------------------------------------- scheduler parity


def _scheduler_leaves(pkg: str, seed: int, n_logical: int = 3, n_physical: int = 4,
                      roots: int = 12, spread: int = 2) -> tuple[dict, dict]:
    """One seeded scheduler load through ``pkg``'s DeploymentSplitter (on
    its fused lane) and FleetScheduler over an in-memory store: every
    registration Ready with a seeded capacity and a region, roots with
    seeded replicas and region labels. Returns (leaves once they equal
    the host twin's answer, that answer) as {(lc, name): replicas}."""
    import importlib

    capi = importlib.import_module(f"{pkg}.apis.cluster")
    client = importlib.import_module(f"{pkg}.client")
    sched_mod = importlib.import_module(f"{pkg}.fleet.scheduler")
    dep = importlib.import_module(f"{pkg}.reconcilers.deployment")
    store_mod = importlib.import_module(f"{pkg}.store")
    kw = {"backend": "tpu"} if pkg == "kcp_tpu" else {"backend": "fused", "device": "cpu"}
    rng = np.random.default_rng(seed)
    regions = ["us-east", "us-west", "eu-west"]
    caps = np.clip(rng.lognormal(3.0, 1.2, (n_logical, n_physical)), 1, 30000).astype(int)
    reps = rng.integers(1, 101, (n_logical, roots))
    home = rng.integers(-1, len(regions), (n_logical, roots))
    lcs = [f"lc-{i}" for i in range(n_logical)]
    want = {}
    rid = {"": 0, **{r: i + 1 for i, r in enumerate(regions)}}
    for i, lc in enumerate(lcs):
        counts = psolver.solve_host(
            reps[i], np.ones((roots, n_physical), bool), caps[i],
            [rid[regions[j % 3]] for j in range(n_physical)],
            [rid[regions[h]] if h >= 0 else 0 for h in home[i]], spread)
        want.update({(lc, f"app-{k}--{lc}-pc-{j}"): int(counts[k, j])
                     for k in range(roots) for j in range(n_physical) if counts[k, j]})

    async def main():
        mc = client.MultiClusterClient(store_mod.LogicalStore())
        for i, lc in enumerate(lcs):
            t = mc.cluster_client(lc)
            for j in range(n_physical):
                obj = capi.new_cluster(f"{lc}-pc-{j}", kubeconfig=f"fake://pc-{j}")
                capi.set_capacity(obj, int(caps[i, j]), region=regions[j % 3])
                capi.set_ready(obj)
                t.create(capi.CLUSTERS, obj)
        splitter = dep.DeploymentSplitter(mc, **kw)
        sched = sched_mod.FleetScheduler(splitter, spread=spread)
        await splitter.start()
        await sched.start()
        for i, lc in enumerate(lcs):
            t = mc.cluster_client(lc)
            for k in range(roots):
                meta = {"name": f"app-{k}", "namespace": "default"}
                if home[i, k] >= 0:
                    meta["labels"] = {capi.REGION_LABEL: regions[home[i, k]]}
                t.create("deployments.apps", {
                    "apiVersion": "apps/v1", "kind": "Deployment", "metadata": meta,
                    "spec": {"replicas": int(reps[i, k]),
                             "template": {"spec": {"containers": []}}}})

        def leaves() -> dict:
            out = {}
            for lc in lcs:
                for o in mc.cluster_client(lc).list("deployments.apps")[0]:
                    if "--" in o["metadata"]["name"]:
                        out[(lc, o["metadata"]["name"])] = o["spec"]["replicas"]
            return out

        loop = asyncio.get_running_loop()
        end = loop.time() + 30
        while leaves() != want and loop.time() < end:
            await asyncio.sleep(0.02)
        got = leaves()
        await sched.stop()
        await splitter.stop()
        return got

    return asyncio.run(main()), want


def test_scheduler_leaves_equal_the_reference_schedulers():
    port, want = _scheduler_leaves("kcp_tpu_torch", 5)
    ref, _ = _scheduler_leaves("kcp_tpu", 5)
    assert port == ref == want
    assert len(want) > 36  # most roots spread over two clusters
