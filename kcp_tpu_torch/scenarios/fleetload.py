"""Fleet + placement scenario workloads (engine-side drivers).

Two workload shapes beyond the configmap/CRD writers:

- ``fleet``: a seeded :class:`~kcp_tpu_torch.physical.fake.ChurnDriver`
  storms a real server's Cluster API over REST while the in-server
  fleet control plane (``KCP_FLEET=1``) keeps root Deployments placed.
  Counter deltas are captured at phase boundaries so the
  zero-churn-under-flaps claim is phase-scoped, not run-scoped, and
  the healed fleet's live assignment is checked against the host
  twin's answer for the final state — the device path's decisions are
  auditable from outside the process.
- ``placement``: no servers at all — the BASELINE-shape bin-pack
  study (10k workspaces x 8 pclusters, skewed lognormal capacity)
  runs engine-side: batched device solve (on the harness's device)
  vs numpy host twin byte-equality, plus a candidate-delta incremental
  re-solve that must touch exactly the dirty rows. Its numbers ARE the
  measurements.

Both drivers run as the phase's single "writer" future; any internal
failure is recorded (``*_driver_errors``) instead of raised, so a
broken driver fails its SLOs loudly rather than aborting the whole
catalog run.
"""

from __future__ import annotations

import logging
import time

import numpy as np

from ..fleet.solver import FleetSolver, solve_host
from ..reconcilers.deployment.controller import (
    CLUSTER_LABEL,
    DEPLOYMENTS,
    OWNED_BY_LABEL,
)
from ..server.rest import RestClient
from ..utils.trace import REGISTRY

log = logging.getLogger(__name__)

#: the logical cluster the fleet workload lives in
FLEET_TENANT = "fleet"

#: counters whose PHASE deltas the fleet workload asserts on (the
#: engine's TRACKED_COUNTERS are run-scoped; zero-churn-under-flaps is
#: a claim about the storm phase alone)
_PHASE_COUNTERS = ("placement_churn_total", "placement_resolves_total",
                   "cluster_evacuations_total")


def _counters() -> dict[str, float]:
    return {n: REGISTRY.counter(n).value for n in _PHASE_COUNTERS}


def _root(name: str, replicas: int) -> dict:
    return {"apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": name, "namespace": "default",
                         "clusterName": FLEET_TENANT},
            "spec": {"replicas": replicas,
                     "template": {"spec": {"containers": []}}}}


def _placed(c: RestClient) -> dict[str, dict[str, int]]:
    """root -> {pcluster: replicas} from the live leaf Deployments."""
    items, _rv = c.list(DEPLOYMENTS, "default")
    out: dict[str, dict[str, int]] = {}
    for o in items:
        labels = o["metadata"].get("labels") or {}
        owner = labels.get(OWNED_BY_LABEL)
        if not owner:
            continue
        n = int(o.get("spec", {}).get("replicas", 0) or 0)
        if n:
            out.setdefault(owner, {})[labels.get(CLUSTER_LABEL, "")] = n
    return out


def run_fleet_phase(base_url: str, phase_name: str, sspec, seed: int,
                    shared: dict) -> None:
    """One fleet-workload phase (blocking worker thread)."""
    shared.setdefault("fleet_driver_errors", 0)
    try:
        _fleet_phase(base_url, phase_name, sspec, seed, shared)
    except Exception:  # noqa: BLE001 — fail via SLOs, not an abort
        log.exception("fleet workload phase %r failed", phase_name)
        shared["fleet_driver_errors"] += 1


def _fleet_phase(base_url: str, phase_name: str, sspec, seed: int,
                 shared: dict) -> None:
    from ..physical.fake import ChurnDriver

    opts = sspec.options
    c = RestClient(base_url, cluster=FLEET_TENANT)
    try:
        if phase_name == "seed":
            drv = ChurnDriver(
                int(opts.get("pclusters", 150)), seed=seed,
                ticks=int(opts.get("ticks", 6)),
                flap_rate=float(opts.get("flap_rate", 0.15)),
                flap_len=1, outage_rate=0.0, capacity_churn=0.0,
                base_capacity=int(opts.get("base_capacity", 64)),
                skew=float(opts.get("skew", 1.0)))
            shared["_drv"] = drv
            drv.seed_fleet(c)
            rng = np.random.default_rng(seed + 1)
            demands = rng.integers(1, 24,
                                   int(opts.get("roots", 24))).tolist()
            shared["_demands"] = demands
            for j, d in enumerate(demands):
                c.create(DEPLOYMENTS, _root(f"app-{j:03d}", int(d)))
            want_total = sum(demands)
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                placed = _placed(c)
                got = sum(sum(v.values()) for v in placed.values())
                if got == want_total and len(placed) == len(demands):
                    break
                time.sleep(0.2)
            shared["fleet_seed_unplaced"] = want_total - sum(
                sum(v.values()) for v in _placed(c).values())
            shared["_before"] = _counters()
        elif phase_name == "storm":
            drv = shared["_drv"]
            tick_s = float(opts.get("tick_s", 0.08))
            for tick in range(drv.ticks):
                drv.apply(c, tick)
                time.sleep(tick_s)
            # heal INSIDE the phase: every flap window stays far inside
            # the evacuation hysteresis, so the storm's churn delta is
            # a clean claim about flaps, not about a trailing outage
            drv.apply(c, drv.ticks)
            time.sleep(0.4)
            before = shared.pop("_before")
            now = _counters()
            shared["fleet_storm_churn"] = (
                now["placement_churn_total"]
                - before["placement_churn_total"])
            shared["fleet_storm_evacuations"] = (
                now["cluster_evacuations_total"]
                - before["cluster_evacuations_total"])
            shared["fleet_flaps"] = shared["_drv"].flap_count()
        elif phase_name == "verify":
            drv, demands = shared["_drv"], shared["_demands"]
            alloc = np.asarray(drv.allocatable_at(drv.ticks), np.int32)
            R = len(demands)
            # host-twin answer for the healed fleet: unlabeled roots
            # carry no locality bonus, so uniform regions/homes solve
            # to the same assignment the live scheduler's -1 homes do
            want = solve_host(np.asarray(demands, np.int32),
                              np.ones((R, drv.n), bool), alloc,
                              np.zeros(drv.n, np.int32),
                              np.zeros(R, np.int32))
            want_map = {
                f"app-{j:03d}": {drv.names[i]: int(want[j, i])
                                 for i in range(drv.n) if want[j, i]}
                for j in range(R)}
            deadline = time.monotonic() + 30.0
            while True:
                placed = _placed(c)
                mism = sum(1 for r, m in want_map.items()
                           if placed.get(r, {}) != m)
                if mism == 0 or time.monotonic() > deadline:
                    break
                time.sleep(0.25)
            shared["assignment_mismatches"] = mism
            shared["fleet_unplaced"] = sum(demands) - sum(
                sum(v.values()) for v in placed.values())
        else:
            raise ValueError(f"unknown fleet phase {phase_name!r}")
    finally:
        c.close()


# ---------------------------------------------------------------------------
# placement study (no topology)
# ---------------------------------------------------------------------------


def run_placement_phase(phase_name: str, sspec, seed: int,
                        shared: dict, device=None) -> None:
    """The BASELINE-shape bin-pack study (blocking worker thread); the
    batched solve runs on ``device`` (``None``: the CUDA card)."""
    shared.setdefault("placement_driver_errors", 0)
    try:
        _placement_study(sspec, seed, shared, device)
    except Exception:  # noqa: BLE001 — fail via SLOs, not an abort
        log.exception("placement study phase %r failed", phase_name)
        shared["placement_driver_errors"] += 1


def _placement_study(sspec, seed: int, shared: dict, device) -> None:
    opts = sspec.options
    W = int(opts.get("workspaces", 10000))
    P = int(opts.get("pclusters", 8))
    spread = int(opts.get("spread", 2))
    rng = np.random.default_rng(seed)
    demand = rng.integers(0, 48, W).astype(np.int32)
    # skewed fleet: a few huge pclusters, a long tail of small ones
    alloc = np.maximum(1, np.minimum(
        rng.lognormal(3.0, float(opts.get("skew", 1.2)), P),
        30000.0)).astype(np.int32)
    cand = rng.random((W, P)) < 0.9
    region = rng.integers(0, 4, P).astype(np.int32)
    home = rng.integers(-1, 4, W).astype(np.int32)
    solver = FleetSolver(spread=spread, device=device)
    solver.solve(demand, cand, alloc, region, home)  # warm (compile)
    t0 = time.perf_counter()
    dev = solver.solve(demand, cand, alloc, region, home).copy()
    shared["placement_batched_ms"] = round(
        (time.perf_counter() - t0) * 1000, 3)
    t0 = time.perf_counter()
    host = solve_host(demand, cand, alloc, region, home, spread)
    shared["placement_host_ms"] = round(
        (time.perf_counter() - t0) * 1000, 3)
    shared["placement_rows"] = W
    shared["placement_pclusters"] = P
    shared["placement_mismatches"] = int((dev != host).any(axis=1).sum())
    shared["placement_overcommit_rows"] = int(
        (dev.sum(axis=1) > demand).sum())
    shared["placement_noncandidate_replicas"] = int(dev[~cand].sum())
    # candidate-delta incremental re-solve: exactly the dirty rows
    # re-dispatch; untouched rows keep their cached assignment and the
    # result must still match a from-scratch host solve of the new state
    k = int(opts.get("dirty_rows", 37))
    dirty = rng.choice(W, size=k, replace=False)
    cand2 = cand.copy()
    cand2[dirty] = rng.random((k, P)) < 0.7
    before = solver.stats["rows_solved"]
    dev2 = solver.solve(demand, cand2, alloc, region, home,
                        rows=[int(i) for i in dirty])
    solved = solver.stats["rows_solved"] - before
    shared["placement_incremental_extra_rows"] = solved - k
    host2 = solve_host(demand, cand2, alloc, region, home, spread)
    shared["placement_incremental_mismatches"] = int(
        (dev2 != host2).any(axis=1).sum())
