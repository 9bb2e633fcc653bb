"""Scenario engine: drive a spec against a real topology, score SLOs.

One scenario run = one topology brought up for real (ServerThreads over
HTTP), one seeded op schedule executed by writer threads, one observer
per (tenant, slot) holding a raw watch stream with the production
resume discipline, phases interleaving fault schedules
(``KCP_FAULTS``-seeded) and chaos actions (rolling restarts — graceful
vs kill —, primary SIGKILL, watcher storms, tenant floods), and one
scorecard: every declared SLO with its observed value, plus the raw
counts that justify it.

Determinism: the schedule is a pure function of (seed, spec) and its
hash rides the scorecard; faults use the seeded injector; actions fire
at fixed points in the phase sequence. Wall-clock measurements
(latencies) vary run to run — the SLOs bound them; the schedule and
the derived final-state expectation never vary.

``scenario.phase`` is a KCP_FAULTS injection point at every phase
boundary: ``latency`` stalls the transition, ``error`` aborts the run
— the harness's own failure path has a drill like everything else.

Device: a scenario whose server installs controllers (CRD and fleet
workloads) or that solves placements engine-side runs that work on
``run_scenario``'s ``device`` — ``None`` is the CUDA card, resolved
before any server starts, so a host without one raises instead of
running on the CPU. The other scenarios serve without controllers and
resolve no device.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import math
import os
import threading
import time

from .. import faults as faults_mod
from ..server.rest import RestClient
from ..utils import errors
from ..utils.trace import REGISTRY
from .spec import ScenarioSpec
from .topology import make_topology
from .workload import (
    NAMESPACE,
    RESOURCE,
    StreamObserver,
    WriterStats,
    build_schedule,
    expected_final_state,
    run_consistent_reader,
    run_flood,
    run_writer,
    schedule_hash,
    tenant_name,
)

log = logging.getLogger(__name__)

#: process-global counters whose per-run deltas scenarios assert on
TRACKED_COUNTERS = ("repl_promotions_total", "repl_rehome_total",
                    "router_rehome_total", "smart_client_direct_total",
                    "smart_client_fallback_total",
                    "smart_client_ring_refreshes_total",
                    "store_commit_windows_total",
                    "repl_ack_batched_total",
                    "migration_records_total",
                    "migration_fenced_writes_total",
                    "repl_fenced_writes_total",
                    "fault_injected_link_partition_total",
                    "fault_injected_link_delay_total",
                    "placement_resolves_total",
                    "placement_churn_total",
                    "cluster_evacuations_total",
                    "cluster_readmissions_total",
                    "consistent_read_waits_total",
                    "consistent_read_timeouts_total",
                    "router_replica_reads_total",
                    "router_replica_fallback_total")


def pctile(vals: list[float], q: float) -> float:
    if not vals:
        return 0.0
    s = sorted(vals)
    i = max(0, min(len(s) - 1, math.ceil(q * len(s)) - 1))
    return s[i]


# ---------------------------------------------------------------------------
# actions
# ---------------------------------------------------------------------------


def _topology_rss_kb(topology) -> int | None:
    """Resident-set size (kB) of the process actually serving the
    topology: the spawned child for a proc-mode Monolith, this process
    for in-thread topologies (RouterFleet / ReplicatedPrimary servers
    live in our ServerThreads). None when /proc isn't readable — the
    soak SLO then fails loudly as "never measured" instead of passing
    on a hole in the data."""
    child = getattr(topology, "_child", None)
    pid = child.pid if child is not None else os.getpid()
    try:
        with open(f"/proc/{pid}/status", encoding="ascii") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except (OSError, ValueError, IndexError):
        return None
    return None


async def _run_action(action: str, topology, observers, loop) -> None:
    """Fire a phase's chaos action once the writers are under way."""
    await asyncio.sleep(0.25)
    if action in ("rolling_restart_drain", "rolling_restart_kill"):
        drain = action.endswith("drain")
        for i in range(len(topology.shards)):
            await loop.run_in_executor(None, topology.restart_shard, i,
                                       drain)
            await asyncio.sleep(0.3)
    elif action == "kill_primary":
        await loop.run_in_executor(None, topology.kill_primary)
    elif action == "move_shard":
        # the ring change: drain a live-workload shard, restart it on a
        # NEW address, republish /ring — smart clients must absorb the
        # move with one-shot fallbacks, routed clients with retries
        await loop.run_in_executor(None, topology.move_shard)
    elif action == "scale_out":
        # elastic capacity: grow the fleet by one shard LIVE — the
        # grown ring publishes with movers pinned, each pinned
        # cluster's WAL streams to the new owner, ownership flips
        # atomically per cluster; writers eat fence-503 retries and
        # watchers ride typed 410 relists, never a lost acked write
        await loop.run_in_executor(None, topology.scale_out)
    elif action == "drop_watchers":
        # the reconnect storm: EVERY stream severed in the same instant,
        # every observer resumes from its last_rv at once
        for obs in observers:
            obs.drop()
    else:
        raise ValueError(f"unknown scenario action {action!r}")


# ---------------------------------------------------------------------------
# CRD / schema-negotiation workload
# ---------------------------------------------------------------------------


def run_crd_tenant(base_url: str, tenant: str, ops, phase_idx: int,
                   stats: WriterStats, shared: dict) -> None:
    """One tenant's CRD lifecycle slice (blocking worker thread).

    Even phases: create the tenant's CRD, measure create→servable
    latency (the schema-negotiation convergence the BASELINE config
    lanes care about), then churn CRs. Odd phases: update the CRD
    schema (negotiation churn), churn more CRs, verify the fold, then
    tear the CRD down and measure create→404 teardown latency. The
    lifecycle is a 2-beat cycle, so a soak run repeating the
    establish/negotiate block N times runs N full lifecycles."""
    from ..apis import crd as crdapi

    group = f"{tenant}.scenario.kcp.dev"
    resource = f"widgets.{group}"
    api_version = f"{group}/v1"
    c = RestClient(base_url, cluster=tenant)

    def cr(name: str, step: int) -> dict:
        return {"apiVersion": api_version, "kind": "Widget",
                "metadata": {"name": name, "namespace": NAMESPACE,
                             "clusterName": tenant},
                "spec": {"v": step}}

    try:
        if phase_idx % 2 == 0:
            crd = crdapi.new_crd(group, "v1", "widgets", "Widget")
            crd["metadata"]["clusterName"] = tenant
            t0 = time.monotonic()
            c.create("customresourcedefinitions.apiextensions.k8s.io", crd)
            # establishment poll: the resource is servable once the CRD
            # lifecycle controller registered it into the serving scheme
            deadline = time.monotonic() + 30.0
            while True:
                try:
                    c.create(resource, cr(f"{tenant}-canary", 0))
                    break
                except errors.NotFoundError:
                    if time.monotonic() > deadline:
                        stats.note("gave_up")
                        return
                    time.sleep(0.05)
            with stats._lock:
                shared.setdefault("servable_s", []).append(
                    time.monotonic() - t0)
            c.delete(resource, f"{tenant}-canary", NAMESPACE)
        else:
            # negotiation churn: widen the schema; serving must not blip
            got = c.get("customresourcedefinitions.apiextensions.k8s.io",
                        f"widgets.{group}")
            got["spec"]["versions"][0]["schema"] = {"openAPIV3Schema": {
                "type": "object",
                "properties": {"spec": {"type": "object"}}}}
            c.update("customresourcedefinitions.apiextensions.k8s.io", got)
        live: set[str] = set(shared.setdefault(("live", tenant), set()))
        for op in ops:
            deadline = time.monotonic() + 20.0
            while True:
                try:
                    if op.kind == "create":
                        c.create(resource, cr(op.name, op.step))
                        live.add(op.name)
                    elif op.kind == "update":
                        c.update(resource, cr(op.name, op.step))
                    else:
                        c.delete(resource, op.name, NAMESPACE)
                        live.discard(op.name)
                    stats.ack(tenant, op.name, 0, op.kind)
                    break
                except (errors.UnavailableError, ConnectionError,
                        OSError):
                    stats.note("http_5xx")
                    if time.monotonic() > deadline:
                        stats.note("gave_up")
                        break
                    time.sleep(0.05)
        with stats._lock:
            shared[("live", tenant)] = live
        if phase_idx % 2 == 1:
            # verify the fold against the server BEFORE teardown
            items, _rv = c.list(resource, NAMESPACE)
            have = {o["metadata"]["name"] for o in items}
            lost = len(live - have) + len(have - live)
            with stats._lock:
                shared["cr_lost"] = shared.get("cr_lost", 0) + lost
            # teardown: reap the surviving CRs first (the store does
            # not GC CR objects with their CRD — a later lifecycle
            # recreating the CRD would resurrect them into its fold),
            # then delete the CRD; the endpoint must 404 promptly
            for name in live:
                try:
                    c.delete(resource, name, NAMESPACE)
                except errors.ApiError:
                    pass
            t0 = time.monotonic()
            c.delete("customresourcedefinitions.apiextensions.k8s.io",
                     f"widgets.{group}", "")
            # the CRs died with the CRD: reset the fold so a soak's
            # next lifecycle starts from an honest empty ledger
            with stats._lock:
                shared[("live", tenant)] = set()
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                try:
                    c.list(resource, NAMESPACE)
                    time.sleep(0.05)
                except errors.NotFoundError:
                    with stats._lock:
                        shared.setdefault("teardown_s", []).append(
                            time.monotonic() - t0)
                    break
    finally:
        c.close()


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


async def _drive(sspec: ScenarioSpec, seed: int, schedule, topology,
                 stats: WriterStats, measurements: dict,
                 device=None) -> list:
    loop = asyncio.get_running_loop()
    # the default loop executor (cpu+4 threads) is sized for nothing:
    # every tenant writer occupies a thread for a whole phase, and
    # observer relists queue BEHIND them — at storm scale that turns a
    # reconnect into a phase-long stall. Size for writers + relist slack.
    from concurrent.futures import ThreadPoolExecutor

    loop.set_default_executor(ThreadPoolExecutor(
        max_workers=sspec.tenants + 32, thread_name_prefix="scenario-io"))
    base = topology.client_url
    observers: list[StreamObserver] = []
    if sspec.workload == "configmaps" and sspec.watchers_per_tenant:
        for ti in range(sspec.tenants):
            for _ in range(sspec.watchers_per_tenant):
                observers.append(StreamObserver(base, tenant_name(ti)))
        await asyncio.gather(*(o.start() for o in observers))
    pace = float(sspec.options.get("pace_s", 0.0))
    try:
        for phase_idx, phase in enumerate(sspec.phases):
            delay = faults_mod.maybe_fail("scenario.phase")
            if delay:
                await asyncio.sleep(delay)
            inj = None
            if phase.faults:
                # WAN-link specs name peers by ROLE ({primary}, ...);
                # the topology knows the host:port each role landed on
                fspec = phase.faults
                if "{" in fspec and hasattr(topology, "peer_addrs"):
                    for role, addr in topology.peer_addrs().items():
                        fspec = fspec.replace("{" + role + "}", addr)
                inj = faults_mod.FaultInjector(fspec, seed)
                faults_mod.install(inj)
            try:
                writer_futs = []
                if sspec.workload == "crd":
                    shared = measurements.setdefault("_crd", {})
                    for ti, ops in enumerate(schedule[phase.name]):
                        writer_futs.append(loop.run_in_executor(
                            None, run_crd_tenant, base, tenant_name(ti),
                            ops, phase_idx, stats, shared))
                elif sspec.workload == "fleet":
                    from .fleetload import run_fleet_phase

                    shared = measurements.setdefault("_fleet", {})
                    writer_futs.append(loop.run_in_executor(
                        None, run_fleet_phase, base, phase.name, sspec,
                        seed, shared))
                elif sspec.workload == "placement":
                    from .fleetload import run_placement_phase

                    shared = measurements.setdefault("_placement", {})
                    writer_futs.append(loop.run_in_executor(
                        None, run_placement_phase, phase.name, sspec,
                        seed, shared, device))
                else:
                    # smart_half: even-index tenants write DIRECT over
                    # the ring (SmartRestClient), odd ones stay routed —
                    # the same seeded schedule through both paths.
                    # smart_all: every tenant direct — the gauntlet's
                    # default driver shape (smart clients are the
                    # production common case since the router-hop cut).
                    smart_half = bool(sspec.options.get("smart_half"))
                    smart_all = bool(sspec.options.get("smart_all"))
                    for ti, ops in enumerate(schedule[phase.name]):
                        if ops:
                            writer_futs.append(loop.run_in_executor(
                                None, run_writer, base, tenant_name(ti),
                                ops, stats, phase.name, "quiet", 30.0,
                                pace,
                                smart_all or (smart_half and ti % 2 == 0)))
                reader_futs = []
                reader_stop = threading.Event()
                if sspec.options.get("consistent_readers"):
                    # session-consistency probers ride alongside the
                    # writers: every read pins the tenant's own max
                    # acked RV — a lagging replica must park, fall
                    # back, or refuse, never answer below the floor
                    shared = measurements.setdefault("_consistent", {
                        "_lock": threading.Lock(), "consistent_reads": 0,
                        "stale_consistent_reads": 0,
                        "consistent_read_errors": 0})
                    for ti in range(sspec.tenants):
                        reader_futs.append(loop.run_in_executor(
                            None, run_consistent_reader, base,
                            tenant_name(ti), stats, shared, reader_stop))
                flood_fut = None
                if phase.action == "flood":
                    flood_fut = loop.run_in_executor(
                        None, run_flood, base, "flood",
                        int(sspec.options.get("flood_ops", 300)), stats)
                action_fut = None
                if phase.action and phase.action != "flood":
                    action_fut = asyncio.ensure_future(
                        _run_action(phase.action, topology, observers,
                                    loop))
                if writer_futs:
                    await asyncio.gather(*writer_futs)
                if flood_fut is not None:
                    ok, throttled = await flood_fut
                    measurements["flood_ok"] = ok
                    measurements["flood_429"] = throttled
                if action_fut is not None:
                    await action_fut
                if reader_futs:
                    reader_stop.set()
                    await asyncio.gather(*reader_futs)
            finally:
                reader_stop.set()
                if inj is not None:
                    faults_mod.clear()
            traces = await loop.run_in_executor(
                None, _fetch_slowest_traces, base)
            if traces:
                measurements.setdefault("_traces", {})[phase.name] = traces
            # soak accounting: RSS at every phase boundary, so a run's
            # scorecard shows WHERE memory went, not just that it grew
            rss = _topology_rss_kb(topology)
            if rss is not None:
                measurements.setdefault("_rss", {})[phase.name] = rss
            if phase.settle_s:
                await asyncio.sleep(phase.settle_s)
        # coverage settle: give observers time to catch up with every
        # acked (name, rv) before we freeze the loss accounting
        if observers:
            await _await_coverage(stats, observers, timeout=float(
                sspec.options.get("coverage_timeout_s", 15.0)))
    finally:
        for o in observers:
            await o.stop()
    return observers


def _fetch_slowest_traces(base_url: str, n: int = 3) -> list[dict]:
    """The 3 slowest assembled traces at a phase boundary, compacted for
    the scorecard (kcp_tpu_torch/obs): an SLO breach in SCENARIOS_rNN.json
    ships with its own explanation. On a router topology the endpoint
    scatter-gathers every shard's buffer; best-effort — a topology mid-
    chaos may refuse, and the scorecard then simply has no trace."""
    from .. import obs
    from ..obs import assemble

    if not base_url or not obs.TRACER.enabled:
        return []
    client = RestClient(base_url)
    try:
        body = client._request("GET", f"/debug/trace?slowest={n}") or {}
    except (errors.ApiError, ConnectionError, OSError):
        return []
    finally:
        client.close()
    out = []
    for t in body.get("traces", [])[:n]:
        summary = assemble.summarize_trace(t.get("spans", []), t.get("id"))
        if summary:
            out.append(summary)
    return out


def _acked_by_tenant(stats: WriterStats) -> dict[str, set]:
    by_tenant: dict[str, set] = {}
    with stats._lock:
        acks = list(stats.acks)
    for tenant, name, rv, kind, _t in acks:
        if kind != "delete" and rv:
            by_tenant.setdefault(tenant, set()).add((name, rv))
    return by_tenant


async def _await_coverage(stats: WriterStats,
                          observers: list[StreamObserver],
                          timeout: float) -> None:
    want = _acked_by_tenant(stats)
    deadline = asyncio.get_running_loop().time() + timeout
    while asyncio.get_running_loop().time() < deadline:
        missing = 0
        for obs in observers:
            need = want.get(obs.tenant)
            if need:
                ev = obs.stats.events
                # membership probes against the live dict — at 10k
                # observers, rebuilding a set per observer per lap was
                # the coverage check's own hot loop
                missing += sum(1 for k in need if k not in ev)
        if missing == 0:
            return
        await asyncio.sleep(0.1)


def _verify_final_state(base: str, sspec: ScenarioSpec, expect,
                        measurements: dict) -> None:
    lost = 0
    for ti in range(sspec.tenants):
        tenant = tenant_name(ti)
        names = expect[tenant]
        c = RestClient(base, cluster=tenant)
        try:
            for attempt in range(40):
                try:
                    items, _rv = c.list(RESOURCE, NAMESPACE)
                    break
                except (errors.ApiError, ConnectionError, OSError):
                    if attempt == 39:
                        raise
                    time.sleep(0.25)
            have = {o["metadata"]["name"] for o in items}
        finally:
            c.close()
        # both directions: an acked create/update missing is a lost
        # write; an acked delete still present is a lost delete
        lost += len(names - have) + len(have - names)
    measurements["lost_acked_writes"] = lost


def _collect(sspec: ScenarioSpec, stats: WriterStats, observers,
             measurements: dict, counters_before: dict,
             duration_s: float) -> dict:
    want = _acked_by_tenant(stats)
    lost_events = 0
    for obs in observers:
        need = want.get(obs.tenant)
        if need:
            ev = obs.stats.events
            lost_events += sum(1 for k in need if k not in ev)
    conv: list[float] = []
    obs_by_tenant: dict[str, list[StreamObserver]] = {}
    for obs in observers:
        obs_by_tenant.setdefault(obs.tenant, []).append(obs)
    with stats._lock:
        acks = list(stats.acks)
        lat = {ph: {k: list(v) for k, v in kl.items()}
               for ph, kl in stats.latencies.items()}
    for tenant, name, rv, kind, t_ack in acks:
        if kind == "delete" or not rv:
            continue
        for obs in obs_by_tenant.get(tenant, ()):
            t_obs = obs.stats.events.get((name, rv))
            if t_obs is not None:
                conv.append(max(0.0, t_obs - t_ack))
    m = measurements
    m["acked"] = len(acks)
    m["events_observed"] = sum(len(o.stats.events) for o in observers)
    m["lost_watch_events"] = lost_events
    m["unclean_stream_ends"] = sum(o.stats.unclean_ends
                                   for o in observers)
    m["terminal_statuses"] = sum(o.stats.terminal_statuses
                                 for o in observers)
    m["gone_410"] = sum(o.stats.gone_410 for o in observers)
    m["relists"] = sum(o.stats.relists for o in observers)
    m["reconnects"] = sum(o.stats.reconnects for o in observers)
    if observers:
        resumes = [s for o in observers for s in o.stats.resume_s]
        # drop→first-event latency across the whole storm; 0.0 when no
        # deliberate drops happened (the paired `reconnects` SLO guards
        # a vacuous pass)
        m["resume_p99_ms"] = round(pctile(resumes, 0.99) * 1000, 3)
        m["resume_p50_ms"] = round(pctile(resumes, 0.50) * 1000, 3)
    m["p50_convergence_ms"] = round(pctile(conv, 0.50) * 1000, 3)
    m["p99_convergence_ms"] = round(pctile(conv, 0.99) * 1000, 3)
    m["http_5xx"] = stats.http_5xx
    m["quiet_429"] = stats.http_429
    m["ambiguous_acks"] = stats.ambiguous
    m["gave_up"] = stats.gave_up
    m["duration_s"] = round(duration_s, 3)
    if duration_s > 0:
        m["acked_per_sec"] = round(len(acks) / duration_s, 3)
    # soak memory SLO inputs: per-phase RSS plus last/first growth
    # ratio. Deliberately ABSENT (not defaulted) when sampling failed:
    # a scenario declaring `memory_growth_ratio` then scores
    # "metric never measured" and fails — per the no-silent-holes
    # discipline, an unmeasured SLO is a failing SLO.
    rss = m.pop("_rss", None)
    if rss:
        m["rss_kb_per_phase"] = dict(rss)
        first = next(iter(rss.values()))
        last = list(rss.values())[-1]
        if first > 0:
            m["memory_growth_ratio"] = round(last / first, 3)
    # per-phase writer p99: what a client-visible op cost during each
    # phase — the ring-change scenario bounds the fallback window's
    # (`phase_move_p99_ms`) so "the move was absorbed" is a latency
    # claim, not just a zero-loss claim
    for ph, klasses in lat.items():
        quiet = klasses.get("quiet", [])
        if quiet:
            m[f"phase_{ph}_p99_ms"] = round(
                pctile(quiet, 0.99) * 1000, 3)
    # noisy-neighbor ratio: quiet p99 during the storm phase vs baseline
    base_lat = lat.get("baseline", {}).get("quiet", [])
    storm_lat = lat.get("storm", {}).get("quiet", [])
    if base_lat and storm_lat:
        b99 = max(pctile(base_lat, 0.99), 1e-6)
        m["quiet_p99_ratio"] = round(pctile(storm_lat, 0.99) / b99, 3)
    # CRD workload measurements
    crd = m.pop("_crd", None)
    if crd is not None:
        m["crd_servable_p99_ms"] = round(
            pctile(crd.get("servable_s", []), 0.99) * 1000, 3)
        m["crd_teardown_p99_ms"] = round(
            pctile(crd.get("teardown_s", []), 0.99) * 1000, 3)
        m["crd_established"] = len(crd.get("servable_s", []))
        m["crd_torn_down"] = len(crd.get("teardown_s", []))
        # one establish per even phase, one teardown per odd phase —
        # a soak run's repeated lifecycle multiplies the expectation
        up_beats = (len(sspec.phases) + 1) // 2
        down_beats = len(sspec.phases) // 2
        m["crd_unestablished"] = (sspec.tenants * up_beats
                                  - m["crd_established"])
        m["crd_undestroyed"] = (sspec.tenants * down_beats
                                - m["crd_torn_down"])
        m["lost_acked_writes"] = crd.get("cr_lost", 0)
    # fleet/placement workload measurements: the driver's shared dict
    # holds scratch state (_-prefixed) AND final numbers — fold only
    # the numbers, under their final metric names
    for key in ("_fleet", "_placement", "_consistent"):
        drv_shared = m.pop(key, None)
        if drv_shared is not None:
            m.update({k: v for k, v in drv_shared.items()
                      if not k.startswith("_")
                      and isinstance(v, (int, float))})
    for name in TRACKED_COUNTERS:
        short = name[:-len("_total")]
        m[short] = REGISTRY.counter(name).value - counters_before[name]
    return m


def _run_pass(sspec: ScenarioSpec, seed: int, schedule, workdir: str,
              device=None) -> dict:
    """One full workload execution on a fresh topology; returns the
    measurement dict."""
    measurements: dict = {}
    stats = WriterStats()
    counters_before = {n: REGISTRY.counter(n).value
                       for n in TRACKED_COUNTERS}
    topology = make_topology(sspec, workdir, device)
    t0 = time.monotonic()
    observers: list = []
    try:
        topology.start()
        observers = asyncio.run(
            _drive(sspec, seed, schedule, topology, stats, measurements,
                   device))
        if hasattr(topology, "audit"):
            # post-run replication facts (exactly-one-writable-primary,
            # fencing landed, follower lag drained) — the partition and
            # WAN-lag drills' SLOs key on these
            measurements.update(topology.audit())
        if sspec.workload == "configmaps":
            _verify_final_state(topology.client_url, sspec,
                                expected_final_state(schedule, sspec),
                                measurements)
    finally:
        faults_mod.clear()
        topology.stop()
    return _collect(sspec, stats, observers, measurements,
                    counters_before, time.monotonic() - t0)


def scenario_device(spec: ScenarioSpec, device=None) -> str | None:
    """The device a scenario's device work runs on, resolved (so a
    missing card raises here), or ``None`` for a scenario that does none:
    its server installs no controllers and it solves nothing
    engine-side."""
    if not (spec.topology_args.get("controllers")
            or spec.workload == "placement"):
        return None
    from ..utils.device import resolve_device

    return str(resolve_device(device))


def run_scenario(spec: ScenarioSpec, seed: int = 42, scale: float = 1.0,
                 workdir: str = "/tmp/kcp-scenarios", device=None) -> dict:
    """Run one scenario end to end; returns its scorecard entry. Its
    device work runs on ``device`` (``None``: the CUDA card)."""
    device = scenario_device(spec, device)
    sspec = spec.scaled(scale)
    schedule = build_schedule(seed, sspec)
    shash = schedule_hash(seed, sspec, schedule)
    wd = os.path.join(workdir, f"{sspec.name}-{seed}")
    os.makedirs(wd, exist_ok=True)
    log.info("scenario %s: seed=%d scale=%s hash=%s", sspec.name, seed,
             scale, shash)
    result: dict = {
        "name": sspec.name, "description": sspec.description,
        "seed": seed, "scale": scale, "topology": sspec.topology,
        "tenants": sspec.tenants,
        "schedule": {
            "hash": shash,
            "ops": sum(len(ops) for tenants in schedule.values()
                       for ops in tenants),
            "phases": [{"name": p.name, "ops_per_tenant": p.ops_per_tenant,
                        "faults": p.faults, "action": p.action}
                       for p in sspec.phases],
        },
    }
    try:
        measurements = _run_pass(sspec, seed, schedule, wd, device)
    except (faults_mod.InjectedFault, errors.ApiError) as e:
        # an injected scenario.phase abort (or an unrecoverable engine
        # refusal): the scenario fails loudly with the cause on record
        result["passed"] = False
        result["aborted"] = f"{type(e).__name__}: {e}"
        result["slos"] = []
        return result
    if sspec.options.get("compare_kill"):
        # the drain-vs-kill demonstration: the same workload on a fresh
        # fleet with graceful drain BYPASSED — the violations the drain
        # pass must not show are recorded (and asserted present via the
        # bypass_* metrics)
        bypass_spec = _bypass_kill_spec(sspec)
        bypass_sched = build_schedule(seed + 1, bypass_spec)
        try:
            bypass = _run_pass(bypass_spec, seed + 1, bypass_sched,
                               wd + "-kill", device)
        except (faults_mod.InjectedFault, errors.ApiError) as e:
            bypass = {"aborted": f"{type(e).__name__}: {e}",
                      "unclean_stream_ends": 0}
        result["drain_bypassed"] = {
            k: bypass.get(k) for k in (
                "unclean_stream_ends", "lost_watch_events", "gone_410",
                "lost_acked_writes", "terminal_statuses", "http_5xx",
                "aborted") if k in bypass}
        measurements["bypass_unclean_ends"] = bypass.get(
            "unclean_stream_ends", 0)
        measurements["bypass_stream_breaches"] = (
            bypass.get("unclean_stream_ends", 0)
            + bypass.get("gone_410", 0)
            + bypass.get("lost_watch_events", 0))
    slo_rows = []
    passed = True
    for slo in sspec.slos:
        if slo.metric not in measurements:
            slo_rows.append({"name": slo.name, "metric": slo.metric,
                             "op": slo.op, "target": slo.target,
                             "observed": None, "passed": False,
                             "error": "metric never measured"})
            passed = False
            continue
        observed = measurements[slo.metric]
        ok = slo.check(observed)
        passed = passed and ok
        slo_rows.append({"name": slo.name, "metric": slo.metric,
                         "op": slo.op, "target": slo.target,
                         "observed": observed, "passed": ok})
    traces = measurements.get("_traces")
    if traces:
        # the 3 slowest assembled convergence traces per phase: the
        # scorecard's own explanation for any latency SLO it reports
        result["traces"] = traces
    result["measurements"] = {k: v for k, v in measurements.items()
                              if not k.startswith("_")}
    result["slos"] = slo_rows
    result["passed"] = passed
    return result


def _bypass_kill_spec(sspec: ScenarioSpec):
    phases = tuple(
        dataclasses.replace(p, action="rolling_restart_kill")
        if p.action == "rolling_restart_drain" else p
        for p in sspec.phases)
    options = {k: v for k, v in sspec.options.items()
               if k != "compare_kill"}
    return dataclasses.replace(sspec, name=sspec.name + "-kill",
                               phases=phases, options=options)
