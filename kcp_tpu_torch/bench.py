"""Closed-loop churn through the port's FusedCore (the port of
``bench.py``'s FusedCore lane and its ``_BenchOwner``).

A synthetic SectionOwner holds mirror arrays instead of informer caches
and copies rows instead of writing to a store; everything between —
queue, staging, the fused step with its CUDA kernel, the pipeline,
dispatch — is the serving code. Each core tick, ``churn`` random rows
get new upstream specs; each applied patch copies up -> down and feeds
the echo back as a downstream event, like a syncer whose write returns
through its informer.

Metrics (the definitions of ``bench.py``):

- reconciles/s = rows x ticks / seconds: every tick re-decides every
  resident row of every logical cluster;
- convergence = time from a row's churn to the apply of its patch
  (the downstream-write instant), p50 and p99 over the measured window.

Run with ``python -m kcp_tpu_torch.bench`` (the card by default,
``--device cpu`` for a host run at a small size).

``--placement`` runs the fleet bin-pack lane instead (the port of
``bench.py --placement``, BASELINE configs[2]): 10,000 workspaces x 8
physical clusters with lognormal-skewed capacity solved as one device
batch through ``FleetSolver``, against the per-workspace host loop of
``solve_host``, plus the 37-row incremental re-solve; one JSON line
with the reference's keys. ``KCP_BENCH_PLACEMENT_*`` set the sizes as
they do in the reference.

Four more lanes, each one JSON line with the reference's keys (plus
``card``, the ``nvidia-smi`` name and power limit of the machine's card,
or null), sized by the reference's knobs:

- ``--fleet`` (``KCP_BENCH_FLEET_*``): ragged fleet dispatch against
  per-bucket dispatch over a 64/32/16-slot fleet and 1-4-row stragglers
  in an 8-slot bucket; rows decided per device dispatch, the per-owner
  patch streams byte-compared across modes, and the poison-row
  quarantine drill. Device work: the card unless ``--device cpu``.
- ``--pagination`` (``KCP_BENCH_PAG_*``): peak allocation of a one-shot
  relist against limit/continue pages, the pages' bytes proven equal.
- ``--gauntlet`` (``KCP_GAUNTLET_*``): one composed scenario per
  BASELINE.json config through ``scenarios.run_scenario``, scored as a
  row, with the paged-relist A/B as its relist column. Its controller
  config (``gauntlet-crd-5k``) runs on ``--device`` (the card by
  default); the others resolve no device.
- ``--trace`` (``KCP_BENCH_TRACE_*``): tracing's off-path cost across
  ``KCP_TRACE`` modes, the wires' sha256 per mode, and a router + 2
  durable shards + standby convergence trace that must sum-reconcile.
  Host only.

A lane with device work and no card (nor ``--device cpu``) exits 2
before any run.
"""

from __future__ import annotations

import argparse
import asyncio
import hashlib
import json
import os
import re
import sys
import time

import numpy as np

from . import faults
from .syncer.core import FusedCore
from .utils.device import resolve_device
from .utils.trace import REGISTRY

#: the repository root (``BASELINE.json`` lives there)
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class BenchOwner:
    """Synthetic SectionOwner over ``b`` rows of ``s`` slots."""

    def __init__(self, core: FusedCore, b: int, s: int, seed: int = 7):
        self.core = core
        self.B, self.S = b, s
        self.rng = np.random.default_rng(seed)
        # status slots: the top s//8 columns, as example_state lays out
        mask = np.zeros(s, bool)
        mask[-max(1, s // 8):] = True
        self._mask = mask
        self.section = core.register(self, s)
        bucket = self.section.bucket
        for i in range(b):
            self.section.row_for(i)
        bucket.up_vals[:b] = self.rng.integers(1, 2**32, (b, s), dtype=np.uint32)
        bucket.down_vals[:b] = bucket.up_vals[:b]
        flip = self.rng.random(b) < 0.005
        bucket.down_vals[:b][flip, :1] ^= 1
        bucket.up_exists[:b] = True
        bucket.down_exists[:b] = True
        bucket.mark_stale()
        self.bucket = bucket
        self.t_create = np.full(b, time.perf_counter())
        self.lat_ms: list[float] = []
        self.patch_rows = 0

    def fused_status_mask(self) -> np.ndarray:
        return self._mask

    def fused_encode(self, key: int):
        b = self.bucket
        return b.up_vals[key], True, b.down_vals[key], True

    def fused_encode_many(self, keys):
        b = self.bucket
        idx = np.fromiter(keys, np.int64, len(keys))
        return (b.up_vals[idx], np.ones(idx.size, bool),
                b.down_vals[idx], np.ones(idx.size, bool))

    def fused_overflow(self) -> None:  # pragma: no cover - fixed vocab
        raise AssertionError("bench vocabulary never grows")

    def fused_apply(self, patches) -> None:
        """Sync each patch row downstream (the convergence instant) and
        enqueue the feedback event."""
        now = time.perf_counter()
        rows = np.fromiter((k for k, _c, _u in patches), np.int32, len(patches))
        self.patch_rows += rows.size
        self.lat_ms.extend((now - self.t_create[rows]) * 1e3)
        self.bucket.down_vals[rows] = self.bucket.up_vals[rows]
        self.core.enqueue_many(self.section, True, rows.tolist())

    def emit_churn(self, n: int) -> None:
        rows = self.rng.choice(self.B, size=n, replace=False)
        self.bucket.up_vals[rows] = self.rng.integers(
            1, 2**32, (n, self.S), dtype=np.uint32)
        self.t_create[rows] = time.perf_counter()
        self.core.enqueue_many(self.section, False, rows.tolist())


def _ticks(core: FusedCore, owner: BenchOwner) -> int:
    fleet = core._fleet
    return fleet.stats["ticks"] if fleet is not None else owner.bucket.stats["ticks"]


async def closed_loop(core: FusedCore, rows: int, slots: int = 64,
                      churn: int = 768, seconds: float = 10.0,
                      warmup_ticks: int = 24, seed: int = 7,
                      stall_s: float = 60.0) -> dict:
    """Warm up, churn for ``seconds``, stop the core, and check that every
    row converged (down mirror == up mirror). Returns the readings; the
    owner is under ``"owner"``."""
    owner = BenchOwner(core, rows, slots, seed=seed)
    bucket = owner.bucket
    bucket.patch_capacity = 8192
    # the acks-lane high-water the reference pre-warms (one wire shape
    # pair for the whole run)
    ack_floor = max(8192, rows // 64, 2 * churn)
    bucket.ack_capacity = 1 << (ack_floor - 1).bit_length()
    await core.start()

    async def pump(until_ticks: int | None, budget_s: float | None) -> None:
        start = time.perf_counter()
        last, progress = _ticks(core, owner), start
        owner.emit_churn(churn)
        while True:
            now = time.perf_counter()
            t = _ticks(core, owner)
            if until_ticks is not None and t >= until_ticks:
                return
            if budget_s is not None and now - start >= budget_s and t > last:
                return
            if t != last:
                last, progress = t, now
                owner.emit_churn(churn)
            elif now - progress > stall_s:
                raise RuntimeError(f"no tick for {stall_s:.0f} s (stuck at {t})")
            await asyncio.sleep(0.0002)

    t0 = time.perf_counter()
    await pump(warmup_ticks, None)
    warmup_s = time.perf_counter() - t0
    owner.lat_ms.clear()
    owner.patch_rows = 0
    tick0 = _ticks(core, owner)
    t0 = time.perf_counter()
    await pump(None, seconds)
    dt = time.perf_counter() - t0
    ticks = _ticks(core, owner) - tick0
    await core.stop()
    converged = bool((bucket.down_vals[:rows] == bucket.up_vals[:rows]).all())
    lat = np.asarray(owner.lat_ms)
    p50, p99 = (np.percentile(lat, [50, 99]).tolist() if lat.size
                else (None, None))
    return {
        "rows": rows, "slots": slots, "churn_per_tick": churn,
        "warmup_ticks": warmup_ticks, "warmup_s": warmup_s,
        "ticks": ticks, "seconds": dt,
        "reconciles_per_s": rows * ticks / dt,
        "ms_per_tick": dt / max(ticks, 1) * 1e3,
        "patch_rows_per_tick": owner.patch_rows / max(ticks, 1),
        "convergence_p50_ms": p50, "convergence_p99_ms": p99,
        "converged": converged,
        "owner": owner,
    }


def placement_inputs(W: int = 10000, P: int = 8, dirty: int = 37) -> dict:
    """The placement lane's inputs from seed 17, drawn in the reference's
    order (``bench.py`` ``placement_bench``): demand, lognormal capacity,
    90 % candidates, 4 regions, home regions in -1..3 (-1 matches none),
    then the incremental lane's dirty rows and their new candidates."""
    rng = np.random.default_rng(17)
    out = {
        "demand": rng.integers(0, 48, W).astype(np.int32),
        "alloc": np.clip(rng.lognormal(3.0, 1.2, P), 1, 30000).astype(np.int32),
        "cand": rng.random((W, P)) < 0.9,
        "region": rng.integers(0, 4, P).astype(np.int32),
        "home": rng.integers(-1, 4, W).astype(np.int32),
    }
    idx = rng.choice(W, size=min(dirty, W), replace=False)
    cand2 = out["cand"].copy()
    cand2[idx] = rng.random((idx.size, P)) < 0.7
    out.update(dirty_rows=idx, cand2=cand2)
    return out


def placement_bench(device=None, mesh=None, W: int = 10000, P: int = 8,
                    spread: int = 2, iters: int = 5, loop_rows: int = 0,
                    dirty: int = 37) -> dict:
    """Fleet bin-pack A/B (BASELINE configs[2]): one batched solve on
    ``device`` (or sharded over ``mesh``) against the per-workspace host
    loop, which may sample ``loop_rows`` rows and extrapolate. The
    assignment must equal ``solve_host``'s; the incremental re-solve
    must touch exactly the dirty rows. Times are host-clock seconds of
    ``FleetSolver.solve`` (its copy back is the solve's sync): the mean
    over ``iters`` (the reference's ``batched_ms``) and their median."""
    from .fleet.solver import FleetSolver, solve_host

    x = placement_inputs(W, P, dirty)
    demand, alloc, cand, region, home = (x[k] for k in ("demand", "alloc", "cand",
                                                       "region", "home"))
    loop_rows = min(loop_rows or W, W)
    solver = FleetSolver(spread=spread, device=device, mesh=mesh)
    solver.solve(demand, cand, alloc, region, home)  # warm-up
    each = []
    for _ in range(iters):
        t0 = time.perf_counter()
        dev = solver.solve(demand, cand, alloc, region, home)
        each.append(time.perf_counter() - t0)
    batched_s = sum(each) / iters
    # solve() returns the solver's live cache: snapshot it before the
    # incremental lane below scatters the dirty-row delta into it
    dev = dev.copy()
    host = solve_host(demand, cand, alloc, region, home, spread)
    per = np.zeros_like(host)
    t0 = time.perf_counter()
    for i in range(loop_rows):
        per[i] = solve_host(demand[i:i + 1], cand[i:i + 1], alloc, region,
                            home[i:i + 1], spread)[0]
    loop_s = (time.perf_counter() - t0) * (W / max(loop_rows, 1))
    idx, cand2 = x["dirty_rows"], x["cand2"]
    before = solver.stats["rows_solved"]
    dev2 = solver.solve(demand, cand2, alloc, region, home, rows=[int(i) for i in idx])
    inc_rows = solver.stats["rows_solved"] - before
    host2 = solve_host(demand, cand2, alloc, region, home, spread)
    return {
        "metric": "placement_batched_speedup",
        "value": round(loop_s / max(batched_s, 1e-9), 2),
        "unit": "x",
        "placement_bench": {
            "workspaces": W, "pclusters": P, "spread": spread,
            "iters": iters, "loop_rows_sampled": loop_rows,
            "batched_ms": round(batched_s * 1e3, 3),
            "batched_ms_median": round(float(np.median(each)) * 1e3, 3),
            "per_workspace_ms": round(loop_s * 1e3, 3),
            "batched_rows_per_s": int(W / max(batched_s, 1e-9)),
            "per_workspace_rows_per_s": int(W / max(loop_s, 1e-9)),
            "assignment_equal_host": bool((dev == host).all()),
            "assignment_equal_per_workspace": bool(
                (per[:loop_rows] == host[:loop_rows]).all()),
            "total_replicas": int(host.sum()),
            "overcommit_rows": int((dev.sum(axis=1) > demand).sum()),
            "noncandidate_replicas": int(dev[~cand].sum()),
            "incremental": {
                "dirty_rows": int(idx.size),
                "rows_solved": int(inc_rows),
                "mismatches": int((dev2 != host2).any(axis=1).sum()),
            },
        },
        "device": str(solver.device),
    }


# --------------------------------------------------------------------------
# --fleet: ragged fleet dispatch against per-bucket dispatch

STALL_S = 45.0  # no tick progress for this long => wedged device, abort


class _FleetOwner:
    """Open-loop SectionOwner for the fleet A/B: fixed mirror arrays,
    every patch recorded (sha256-compared across modes), no feedback —
    so per-bucket and ragged runs see identical staging schedules and
    the patch-stream byte-equality check is exact."""

    def __init__(self, core: FusedCore, b: int, s: int):
        self.core = core
        self.B, self.S = b, s
        mask = np.zeros(s, bool)
        mask[-max(1, s // 8):] = True
        self._mask = mask
        self.up_vals = np.zeros((b, s), np.uint32)
        self.down_vals = np.zeros((b, s), np.uint32)
        self.patch_rows = 0
        self._digest = None  # lazily-created hashlib stream digest
        self.section = core.register(self, s)
        self.section.bucket.patch_capacity = 8192

    def fused_status_mask(self) -> np.ndarray:
        return self._mask

    def fused_encode(self, key: int):
        return self.up_vals[key], True, self.down_vals[key], True

    def fused_encode_many(self, keys):
        idx = np.fromiter(keys, np.int64, len(keys))
        ones = np.ones(idx.size, bool)
        return self.up_vals[idx], ones, self.down_vals[idx], ones

    def fused_overflow(self) -> None:  # pragma: no cover - fixed vocab
        raise AssertionError("fleet bench vocabulary never grows")

    def fused_apply(self, patches) -> None:
        if self._digest is None:
            self._digest = hashlib.sha256()
        self.patch_rows += len(patches)
        self._digest.update(np.asarray(
            [(int(k), int(c), int(u)) for k, c, u in patches],
            np.int64).tobytes())

    def digest(self) -> str:
        return self._digest.hexdigest() if self._digest else "empty"


async def _fleet_mode_run(fleet: bool, shape, stragglers: int, steps: int,
                          warmup: int, churn_frac: float, seed: int = 7,
                          device=None) -> dict:
    """One lockstep run (per-bucket or ragged): every step churns every
    bucket, then waits for every bucket to tick once — so both modes
    decide the identical row set per tick and the streams compare."""
    core = FusedCore(batch_window=0.0005, fleet=fleet, device=device)
    owners = [_FleetOwner(core, b, s) for b, s in shape]
    srng = np.random.default_rng(seed + 1)
    straggler_owners = [
        _FleetOwner(core, int(srng.integers(1, 5)), 8)
        for _ in range(stragglers)]
    all_owners = owners + straggler_owners
    buckets = list({id(o.section.bucket): o.section.bucket
                    for o in all_owners}.values())
    total_rows = sum(o.B for o in all_owners)
    await core.start()

    rng = np.random.default_rng(seed)
    step_times: list[float] = []
    t_start = time.perf_counter()
    decided = 0
    last_progress = time.perf_counter()
    for step in range(warmup + steps):
        if step == warmup:
            t_start = time.perf_counter()
            for o in all_owners:
                o.patch_rows = 0
        before = {id(b): b.stats["ticks"] for b in buckets}
        t0 = time.perf_counter()
        for o in all_owners:
            pool = min(o.B, 4096)
            n = max(1, int(pool * churn_frac))
            touched = (rng.choice(pool, size=n, replace=False)
                       if n < pool else np.arange(pool))
            o.up_vals[touched] = rng.integers(
                1, 2**32, (touched.size, o.S), dtype=np.uint32)
            core.enqueue_many(o.section, False, touched.tolist())
        while not all(b.stats["ticks"] > before[id(b)] for b in buckets):
            await asyncio.sleep(0.0002)
            if time.perf_counter() - last_progress > STALL_S:
                raise RuntimeError(f"fleet bench stalled at step {step}")
        last_progress = time.perf_counter()
        if step >= warmup:
            step_times.append(time.perf_counter() - t0)
            decided += total_rows  # every bucket decided all its rows
    wall = time.perf_counter() - t_start
    dispatches = (core._fleet.stats["ticks"] if fleet
                  else sum(b.stats["ticks"] for b in buckets))
    # dispatches since measurement start: subtract warmup's share
    warm_disp = warmup * (1 if fleet else len(buckets))
    dispatches -= warm_disp
    await core.stop()
    lat = np.asarray(step_times) * 1e3
    return {
        "rows": total_rows,
        "buckets": len(buckets),
        "sections": len(all_owners),
        "rows_per_sec": decided / wall,
        "dispatches": int(dispatches),
        "rows_per_dispatch": decided / max(dispatches, 1),
        "tick_ms_p50": float(np.percentile(lat, 50)),
        "tick_ms_p99": float(np.percentile(lat, 99)),
        "patch_rows": sum(o.patch_rows for o in all_owners),
        "stream_digests": [o.digest() for o in all_owners],
    }


async def _fleet_quarantine_drill(device=None) -> dict:
    """Green-path drill for the lane's gate: a poison row in a 2-bucket
    fleet must quarantine ONLY the poison (segment-scoped bisection)
    while every co-tenant's patch still lands."""
    faults.install(faults.FaultInjector("device.step:poison_row=3", seed=0))
    try:
        core = FusedCore(batch_window=0.0005, fleet=True, device=device)
        streams: dict[int, set] = {}

        class DrillOwner(_FleetOwner):
            def fused_apply(self, patches):
                streams.setdefault(id(self), set()).update(
                    int(k) for k, _c, _u in patches)

        owners = [DrillOwner(core, 32, w) for w in (8, 16)]
        await core.start()
        keys = list(range(20))
        for o in owners:
            o.up_vals[keys, 0] = 7
            core.enqueue_many(o.section, False, keys)
        deadline = time.perf_counter() + 60
        want = set(keys) - {3}
        while time.perf_counter() < deadline:
            if (core._fleet.stats["quarantined"] >= 2
                    and all(streams.get(id(o), set()) >= want
                            for o in owners)):
                break
            await asyncio.sleep(0.005)
        quarantined = core._fleet.stats["quarantined"]
        co_ok = all(streams.get(id(o), set()) >= want for o in owners)
        only_poison = all(3 not in streams.get(id(o), set()) for o in owners)
        faults.clear()
        await core.stop()
        return {"quarantined": int(quarantined), "co_tenants_ok": bool(co_ok),
                "only_poison": bool(only_poison),
                "ok": bool(quarantined >= 2 and co_ok and only_poison)}
    finally:
        faults.clear()


async def measure_fleet(device=None, on_mode=None) -> dict:
    """``--fleet``: per-bucket vs ragged fleet dispatch A/B at 10k
    clusters x mixed bucket sizes (a 64-slot main fleet, 32/16-slot mid
    and small buckets, plus many 1-4-row straggler sections in an
    8-slot bucket). Headline value = device-utilization gain (rows
    decided per device dispatch, ragged / per-bucket: the dispatch
    amortization ragged batching exists for); combined reconcile
    throughput and tick latency ride along, and the per-owner patch
    streams must hash identically across modes. Per-bucket dispatch
    launches the kernel's 3-output form once per bucket and tick, ragged
    dispatch its fleet form once per tick. ``on_mode(mode, result)``,
    if given, is called as each mode's run ends, before the next one
    (and the drill) starts."""
    device = resolve_device(device)
    rows = int(os.environ.get("KCP_BENCH_FLEET_ROWS", "131072"))
    stragglers = int(os.environ.get("KCP_BENCH_FLEET_STRAGGLERS", "24"))
    steps = int(os.environ.get("KCP_BENCH_FLEET_STEPS", "40"))
    warmup = int(os.environ.get("KCP_BENCH_FLEET_WARMUP", "8"))
    churn_frac = float(os.environ.get("KCP_BENCH_FLEET_CHURN_FRAC", "0.1"))
    shape = [(rows, 64), (max(rows // 8, 64), 32), (max(rows // 64, 16), 16)]
    tenants = sum(b for b, _s in shape) // 13

    results: dict[str, dict] = {}
    for mode, fleet in (("per_bucket", False), ("ragged", True)):
        print(f"--- fleet dispatch mode: {mode} ---", file=sys.stderr)
        r = await _fleet_mode_run(fleet, shape, stragglers, steps, warmup,
                                  churn_frac, device=device)
        results[mode] = r
        print(f"{mode}: {r['rows_per_sec'] / 1e6:.2f}M rows/s | "
              f"{r['dispatches']} dispatches | "
              f"{r['rows_per_dispatch'] / 1e3:.0f}k rows/dispatch | "
              f"tick p50 {r['tick_ms_p50']:.1f} ms p99 "
              f"{r['tick_ms_p99']:.1f} ms", file=sys.stderr)
        if on_mode is not None:
            on_mode(mode, r)

    streams_equal = (results["per_bucket"]["stream_digests"]
                     == results["ragged"]["stream_digests"])
    util_gain = (results["ragged"]["rows_per_dispatch"]
                 / max(results["per_bucket"]["rows_per_dispatch"], 1))
    speedup = (results["ragged"]["rows_per_sec"]
               / max(results["per_bucket"]["rows_per_sec"], 1e-9))
    drill = await _fleet_quarantine_drill(device)
    return {
        "metric": "fleet_device_utilization",
        "value": round(util_gain, 2),
        "unit": "x",
        "stage": "fleet-ab",
        "tenants": tenants,
        "fleet_bench": {
            "rows": results["ragged"]["rows"],
            "buckets": results["ragged"]["buckets"],
            "sections": results["ragged"]["sections"],
            "stragglers": stragglers,
            "streams_equal": streams_equal,
            "combined_speedup": round(speedup, 3),
            "combined_rows_per_sec": {
                m: round(r["rows_per_sec"]) for m, r in results.items()},
            "rows_per_dispatch": {
                m: round(r["rows_per_dispatch"]) for m, r in results.items()},
            "dispatches": {m: r["dispatches"] for m, r in results.items()},
            "tick_ms_p50": {
                m: round(r["tick_ms_p50"], 2) for m, r in results.items()},
            "tick_ms_p99": {
                m: round(r["tick_ms_p99"], 2) for m, r in results.items()},
            "quarantine_drill": drill,
        },
    }


# --------------------------------------------------------------------------
# --pagination: paged against one-shot relists


def _pagination_cm(i: int) -> dict:
    # a realistic ~0.5 KiB ConfigMap: the allocation the page bound caps
    # scales with per-object size
    return {
        "apiVersion": "v1", "kind": "ConfigMap",
        "metadata": {"name": f"cm-{i:06d}", "namespace": f"ns{i % 8}",
                     "uid": f"uid-{i}",
                     "labels": {"team": f"t{i % 64}", "tier": str(i % 7)},
                     "annotations": {
                         "kcp.dev/owned-by": f"workspace-{i % 128}",
                         "kubectl.kubernetes.io/last-applied-configuration":
                             f"cm-{i}/rev-0",
                         "config.example.dev/checksum": f"{i:08x}{i:08x}",
                     }},
        "data": {"server.yaml": f"replicas: {i % 9}\nshard: {i % 64}\n",
                 "feature-flags": f"a={i % 2},b={i % 3},c={i % 5}",
                 "rev": "0"},
    }


def _pagination_ab(n_objects: int, page: int) -> dict:
    """One paged-vs-unpaged relist A/B through the real RestHandler:
    peak allocation (tracemalloc) of a full one-shot relist vs iterating
    limit/continue pages holding at most one page at a time — with the
    concatenated page bytes proven sha256-identical to the one-shot
    ``items`` span. Used by ``--pagination`` and embedded in the
    gauntlet scorecard as the relist-memory column."""
    import tracemalloc

    from .apis.scheme import default_scheme
    from .server.handler import RestHandler
    from .server.httpd import Request
    from .store.store import LogicalStore

    marker = b'"items": ['
    rv_re = re.compile(rb'"resourceVersion": "(\d+)"')
    cont_re = re.compile(rb'"continue": "([^"]*)"')

    def span_of(body: bytes) -> bytes:
        i = body.find(marker)
        assert i >= 0 and body.endswith(b"]}")
        return body[i + len(marker):-2]

    def head_meta(body: bytes) -> tuple[str, str]:
        """(rv, continue) parsed from the envelope head bytes alone —
        what a streaming client reads; never materializes item dicts."""
        head = body[:body.find(marker)]
        rv_m = rv_re.search(head)
        cont_m = cont_re.search(head)
        return (rv_m.group(1).decode() if rv_m else "",
                cont_m.group(1).decode() if cont_m else "")

    async def run() -> dict:
        store = LogicalStore(indexed=True, encode_cache=True,
                             clock=lambda: 1_700_000_000.0)
        handler = RestHandler(store, default_scheme(), admission=None)
        for i in range(n_objects):
            store.create("configmaps", f"c{i % 16}", _pagination_cm(i))
        path = "/clusters/*/api/v1/configmaps"
        # warm the per-record byte cache outside both timed/traced
        # windows so the A/B measures body assembly, not first-encode
        await handler(Request("GET", path, {}, {}, b""))

        tracemalloc.start()
        tracemalloc.reset_peak()
        base = tracemalloc.get_traced_memory()[0]
        t0 = time.perf_counter()
        resp = await handler(Request("GET", path, {}, {}, b""))
        body = resp.body
        unpaged_s = time.perf_counter() - t0
        unpaged_peak = tracemalloc.get_traced_memory()[1] - base
        tracemalloc.stop()
        # verification outside the traced window: neither arm's peak
        # should include the A/B's own proof bookkeeping
        one_shot_sha = hashlib.sha256(span_of(body)).hexdigest()
        rv, _ = head_meta(body)
        del resp, body

        tracemalloc.start()
        tracemalloc.reset_peak()
        base = tracemalloc.get_traced_memory()[0]
        digest = hashlib.sha256()
        pages = 0
        cont = None
        first = True
        rv_paged = None
        t0 = time.perf_counter()
        while True:
            q = {"limit": [str(page)]}
            if cont:
                q["continue"] = [cont]
            resp = await handler(Request("GET", path, q, {}, b""))
            body = resp.body
            pages += 1
            # hash through a memoryview: the page's items bytes feed the
            # equality proof without a second whole-page copy
            i = body.find(marker)
            assert i >= 0 and body.endswith(b"]}")
            if len(body) - i - len(marker) > 2:
                if not first:
                    digest.update(b", ")
                digest.update(memoryview(body)[i + len(marker):-2])
                first = False
            page_rv, cont = head_meta(body)
            if rv_paged is None:
                rv_paged = page_rv
            del resp, body
            if not cont:
                break
        paged_s = time.perf_counter() - t0
        paged_peak = tracemalloc.get_traced_memory()[1] - base
        tracemalloc.stop()
        store.close()
        handler.close()
        return {
            "objects": n_objects, "page": page, "pages": pages,
            "rv_equal": rv == rv_paged,
            "bytes_equal": digest.hexdigest() == one_shot_sha,
            "sha256": one_shot_sha,
            "unpaged_peak_kb": round(unpaged_peak / 1024),
            "paged_peak_kb": round(paged_peak / 1024),
            "peak_cut": round(unpaged_peak / max(paged_peak, 1), 2),
            "unpaged_s": round(unpaged_s, 4),
            "paged_s": round(paged_s, 4),
        }

    return asyncio.run(run())


def _pagination_shape() -> tuple[int, int]:
    return (int(os.environ.get("KCP_BENCH_PAG_OBJECTS", "100000")),
            int(os.environ.get("KCP_BENCH_PAG_PAGE", "10000")))


def pagination_bench() -> dict:
    """Paged-relist A/B (``--pagination``): peak relist allocation with
    one-shot lists vs limit/continue pages at the BASELINE 100k-object
    watch-fan-out shape. The headline is the peak-allocation cut; the
    run self-verifies that concatenated pages are byte-identical to the
    one-shot body (anything else is a paging bug, not a measurement)."""
    ab = _pagination_ab(*_pagination_shape())
    return {
        "metric": "paged_relist_peak_cut",
        "value": ab["peak_cut"],
        "unit": "x",
        "pagination_bench": ab,
    }


# --------------------------------------------------------------------------
# --gauntlet: one composed scenario per BASELINE.json config


def gauntlet_specs() -> list:
    """The gauntlet's five full-scale specs, one per BASELINE.json config
    line, in file order; ``.scaled()`` brings each down to
    1/KCP_GAUNTLET_SCALE of the BASELINE shape (SLO targets never
    scale)."""
    from .scenarios.spec import SLO, Phase, ScenarioSpec

    slos_common = (
        SLO("no-lost-acked-writes", "lost_acked_writes", "==", 0),
        SLO("no-lost-watch-events", "lost_watch_events", "==", 0),
        SLO("bounded-rss-growth", "memory_growth_ratio", "<=", 3.0),
    )
    slos_crd = (
        SLO("no-lost-acked-cr-writes", "lost_acked_writes", "==", 0),
        SLO("all-crds-established", "crd_unestablished", "==", 0),
        SLO("bounded-rss-growth", "memory_growth_ratio", "<=", 3.0),
    )
    phases = (Phase("warm", ops_per_tenant=8),
              Phase("sustain", ops_per_tenant=24, settle_s=0.5),
              Phase("drain", ops_per_tenant=8, settle_s=0.5))
    return [
        # contrib/demo: splitter over 2 physical clusters, 1 logical
        ScenarioSpec(
            name="gauntlet-demo",
            description="demo shape: 2-shard fleet, a handful of "
                        "logical clusters, smart-client writers",
            topology="fleet", topology_args={"shards": 2},
            tenants=100, watchers_per_tenant=1, phases=phases,
            options={"smart_all": True}, slos=slos_common),
        # syncer diff batched across 1k logical clusters (cm churn)
        ScenarioSpec(
            name="gauntlet-syncer-churn",
            description="1k-logical-cluster ConfigMap churn through a "
                        "durable 4-shard fleet, smart-client writers",
            topology="fleet", topology_args={"shards": 4, "durable": True},
            tenants=1000, watchers_per_tenant=1, phases=phases,
            options={"smart_all": True}, slos=slos_common),
        # splitter bin-packing across 10k workspaces x 8 pclusters
        ScenarioSpec(
            name="gauntlet-splitter-10k",
            description="10k-workspace write fan-in across a 4-shard "
                        "fleet (the 10k-logical-cluster north-star "
                        "shape), smart-client writers",
            topology="fleet", topology_args={"shards": 4},
            tenants=10000, watchers_per_tenant=0, phases=phases,
            options={"smart_all": True},
            slos=(SLO("no-lost-acked-writes", "lost_acked_writes",
                      "==", 0),
                  SLO("bounded-rss-growth", "memory_growth_ratio",
                      "<=", 3.0))),
        # NegotiatedAPIResource schema-compat across 5k tenant CRD sets
        ScenarioSpec(
            name="gauntlet-crd-5k",
            description="5k-tenant CRD establish/negotiate churn with "
                        "live CR traffic (schema-compat reconcile)",
            topology="monolith", topology_args={"controllers": True},
            tenants=5000, watchers_per_tenant=0, workload="crd",
            phases=(Phase("establish", ops_per_tenant=10, settle_s=0.5),
                    Phase("negotiate", ops_per_tenant=16, settle_s=0.5)),
            slos=slos_crd),
        # informer watch fan-out: 100k objects, 10k watchers
        ScenarioSpec(
            name="gauntlet-watch-fanout",
            description="watch fan-out at the 10k-watcher shape: 100 "
                        "tenants x 100 streams over one server process "
                        "under sustained churn",
            topology="monolith", topology_args={"proc": True},
            tenants=100, watchers_per_tenant=100, phases=phases,
            options={"pace_s": 0.01, "coverage_timeout_s": 120.0},
            slos=slos_common),
    ]


def gauntlet_selected() -> list[int]:
    """The config indices ``KCP_GAUNTLET_CONFIGS`` selects (all by default)."""
    sel_env = os.environ.get("KCP_GAUNTLET_CONFIGS", "")
    return ([int(x) for x in sel_env.split(",") if x.strip() != ""]
            if sel_env else list(range(len(gauntlet_specs()))))


def gauntlet_bench(device=None) -> dict:
    """The north-star gauntlet (``--gauntlet``): one composed run per
    BASELINE.json config — router + shard fleets + replicas, smart
    clients as the default writers — each scored by the scenario
    engine (reconciles/sec as acked-writes/sec, spec->status
    convergence p50/p99 from assembled trace phases, per-phase RSS) and
    returned as one scorecard row. A paged-relist A/B at the 100k-object
    fan-out shape rides the scorecard as the relist-memory column.

    Knobs: KCP_GAUNTLET_SCALE (divisor, default 50 — 1/50th of the
    BASELINE shape; 1 is the full gauntlet), KCP_GAUNTLET_CONFIGS (csv
    of config indices, default all), KCP_GAUNTLET_SOAK (repeat each
    config's phases N times so the RSS-growth SLO spans a soak, with a
    scorecard snapshot per round), KCP_GAUNTLET_OPS (override ops per
    tenant per phase), KCP_GAUNTLET_OUT (``main`` also writes the
    scorecard to this file), KCP_BENCH_PAG_OBJECTS/_PAGE (relist A/B
    shape).

    A selected config whose server installs controllers runs them on
    ``device`` (``None``: the card), resolved before any config runs;
    the others resolve no device. Each row names the device its config
    ran on as ``device`` (null for a config without device work)."""
    import dataclasses
    import shutil
    import tempfile

    from .scenarios.engine import run_scenario, scenario_device

    divisor = float(os.environ.get("KCP_GAUNTLET_SCALE", "50"))
    scale = 1.0 / max(divisor, 1e-9)
    soak = int(os.environ.get("KCP_GAUNTLET_SOAK", "0"))
    ops_override = os.environ.get("KCP_GAUNTLET_OPS", "")

    try:
        with open(os.path.join(REPO_ROOT, "BASELINE.json"),
                  encoding="utf-8") as f:
            cfg_names = list(json.load(f).get("configs", []))
    except OSError:
        cfg_names = []

    specs = gauntlet_specs()
    selected = gauntlet_selected()
    # a missing card fails here, before any config runs (a config's own
    # failure below is scored as its row)
    devices = {idx: scenario_device(specs[idx], device) for idx in selected}

    # a FRESH workdir per invocation: fleet shards are durable by
    # default, and a reused root would replay a previous run's WAL
    # into this run's fold (stale objects -> phantom 409s/losses)
    workdir = tempfile.mkdtemp(prefix="kcp-gauntlet-")

    rows = []
    degraded_any = False
    for idx in selected:
        spec = specs[idx]
        if ops_override:
            n = int(ops_override)
            spec = dataclasses.replace(spec, phases=tuple(
                dataclasses.replace(p, ops_per_tenant=n if p.ops_per_tenant
                                    else 0) for p in spec.phases))
        if soak > 1:
            # soak mode: the same phase block repeated N rounds under
            # one topology — RSS is sampled at every phase boundary, so
            # rss_kb_per_phase is the periodic snapshot series and the
            # growth SLO spans the whole soak
            spec = dataclasses.replace(spec, phases=tuple(
                dataclasses.replace(p, name=f"{p.name}-r{r}")
                for r in range(soak) for p in spec.phases))
        cfg = (cfg_names[idx] if idx < len(cfg_names)
               else f"config[{idx}]")
        print(f"# gauntlet [{idx}] {spec.name}: {cfg}", file=sys.stderr)
        try:
            res = run_scenario(spec, seed=42, scale=scale,
                               workdir=workdir, device=devices[idx])
        except Exception as e:  # noqa: BLE001 - a wedged config must
            # not take down the other rows; the failure IS the row
            rows.append({"config": cfg, "name": spec.name,
                         "scale": f"1/{divisor:g}", "passed": False,
                         "degraded": True, "error": f"{type(e).__name__}: {e}"})
            degraded_any = True
            continue
        m = res.get("measurements", {})
        row = {
            "config": cfg,
            "name": spec.name,
            "scale": f"1/{divisor:g}",
            "tenants": res.get("tenants"),
            "reconciles_per_sec": m.get("acked_per_sec"),
            "acked": m.get("acked"),
            "convergence_p50_ms": m.get("p50_convergence_ms"),
            "convergence_p99_ms": m.get("p99_convergence_ms"),
            "lost_acked_writes": m.get("lost_acked_writes"),
            "lost_watch_events": m.get("lost_watch_events"),
            "rss_kb_per_phase": m.get("rss_kb_per_phase"),
            "memory_growth_ratio": m.get("memory_growth_ratio"),
            "duration_s": m.get("duration_s"),
            "passed": res.get("passed"),
            "slos": res.get("slos"),
            "device": devices[idx],
        }
        if res.get("aborted"):
            row["degraded"] = True
            row["error"] = res["aborted"]
            degraded_any = True
        rows.append(row)

    shutil.rmtree(workdir, ignore_errors=True)
    pag = _pagination_ab(*_pagination_shape())
    REGISTRY.counter(
        "gauntlet_runs_total",
        "composed gauntlet scorecard runs completed").inc()
    scorecard = {
        "metric": "gauntlet_configs_passed",
        "value": sum(1 for r in rows if r.get("passed")),
        "unit": f"of {len(rows)} configs",
        "scale": f"1/{divisor:g}",
        "soak_rounds": soak,
        "rows": rows,
        "relist": pag,
    }
    if degraded_any:
        scorecard["degraded"] = True
    return scorecard



# --------------------------------------------------------------------------
# --trace: tracing's off-path cost, wire neutrality, convergence attribution


def trace_bench() -> dict:
    """Distributed-tracing cost + convergence attribution (``--trace``).

    Three questions, answered in one lane:

    1. **Off-path cost** — the store-shaped serving hot path
       (list/get/update through the real RestHandler) and the
       watcher-shaped fan-out hot path (mutation → batched fan-out →
       encode-once event lines), each run three ways: ``KCP_TRACE=0``,
       default 1-in-64 sampling, and always-on.
    2. **Wire neutrality** — every response body and event line across
       all three modes feeds one sha256 per mode; the digests must be
       identical (tracing never touches the wire).
    3. **Attribution** — a router + 2 durable shards + standby topology
       with a host-backend sync engine over it: sampled spec writes are
       traced client → router → shard → store/WAL → standby ack →
       engine stage/tick/patch → downstream status → status upsync,
       assembled via the router's ``/debug/trace`` scatter + the
       engine's rv-linked fragment, and each trace's per-phase durations
       must sum-reconcile (±5%) with the measured spec→status wall time.

    No server here installs controllers and the engine runs the host
    backend: the lane resolves no device.
    """
    import tempfile

    from . import obs
    from .apis.scheme import default_scheme
    from .client import Client
    from .obs import assemble
    from .server.handler import RestHandler
    from .server.httpd import Request
    from .server.rest import RestClient
    from .store.store import LogicalStore
    from .utils import errors as kerrors

    n_objects = int(os.environ.get("KCP_BENCH_TRACE_OBJECTS", "5000"))
    n_reqs = int(os.environ.get("KCP_BENCH_TRACE_REQS", "400"))
    n_watchers = int(os.environ.get("KCP_BENCH_TRACE_WATCHES", "64"))
    n_muts = int(os.environ.get("KCP_BENCH_TRACE_MUTS", "300"))
    n_conv = int(os.environ.get("KCP_BENCH_TRACE_CONV", "4"))

    def _cm(i: int, v: str) -> dict:
        return {
            "apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": f"cm-{i}", "namespace": f"ns{i % 8}",
                         "uid": f"uid-{i}",  # fixed: modes must be byte-equal
                         "labels": {"team": f"t{i % 64}"}},
            "data": {"v": v, "pad": "x" * 64},
        }

    def _p50(vals: list[float]) -> float:
        s = sorted(vals)
        return s[len(s) // 2] if s else 0.0

    def set_mode(env: dict) -> None:
        for k in ("KCP_TRACE", "KCP_TRACE_SAMPLE"):
            os.environ.pop(k, None)
        os.environ.update(env)
        os.environ["KCP_TRACE_SEED"] = "7"
        obs.TRACER.reconfigure()

    mode_envs = (("off", {"KCP_TRACE": "0"}),
                 ("sampled", {"KCP_TRACE": "1", "KCP_TRACE_SAMPLE": "64"}),
                 ("always", {"KCP_TRACE": "1", "KCP_TRACE_SAMPLE": "1"}))

    def _greq(i: int) -> Request:
        return Request("GET", f"/clusters/c0/api/v1/namespaces/ns{i % 8}"
                              f"/configmaps/cm-{i}", {}, {}, b"")

    def _preq(i: int, v: str) -> Request:
        return Request("PUT", f"/clusters/c0/api/v1/namespaces/ns{i % 8}"
                              f"/configmaps/cm-{i}",
                       {}, {"content-type": "application/json"},
                       json.dumps(_cm(i, v)).encode())

    def _fan_mut(store, watches, i: int, v: str) -> None:
        """One production-shaped fan-out beat: mutate under the serving
        layer's sampling decision, flush, and encode every watcher's
        lines through the shared encode-once cache."""
        ctx = None
        if obs.TRACER.enabled and obs.TRACER.head_sampled():
            ctx = obs.TRACER.mint(sampled=True)
        if ctx is not None:
            with obs.use(ctx):
                store.update("configmaps", "c0", _cm(i, v))
        else:
            store.update("configmaps", "c0", _cm(i, v))
        store._flush_events()
        for w in watches:
            store.encode_events(w.drain())

    async def measure() -> dict:
        """Overhead A/B on ONE shared store, modes interleaved per
        small op block — host drift and cache state hit every mode
        equally, so a p50 delta is tracing cost, not weather. (Byte
        identity is proven separately on fresh per-mode stores, where
        response bytes are comparable.)"""
        set_mode({"KCP_TRACE": "0"})
        store = LogicalStore(indexed=True, clock=lambda: 1_700_000_000.0)
        handler = RestHandler(store, default_scheme(), admission=None)
        for i in range(n_objects):
            store.create("configmaps", "c0", _cm(i, str(i)))
        watches = [store.watch("configmaps") for _ in range(n_watchers)]
        lreq = Request("GET", "/clusters/c0/api/v1/configmaps", {}, {}, b"")
        times = {name: {"list": [], "get": [], "put": [], "fanout": []}
                 for name, _env in mode_envs}
        for j in range(30):  # warmup: caches hot before the first sample
            await handler(lreq if j % 5 == 0 else _greq(j))
            _fan_mut(store, watches, j, f"w{j}")
        pc = time.perf_counter
        blocks = max(8, n_reqs // 8)
        ctr = 0
        for _b in range(blocks):
            block: dict[str, dict[str, list[float]]] = {}
            for name, env in mode_envs:
                set_mode(env)
                bl = block[name] = {"list": [], "get": [], "put": [],
                                    "fanout": []}
                for _k in range(2):
                    t0 = pc()
                    await handler(lreq)
                    bl["list"].append(pc() - t0)
                for k in range(4):
                    i = (ctr * 13 + k * 5) % n_objects
                    t0 = pc()
                    resp = await handler(_greq(i))
                    bl["get"].append(pc() - t0)
                    assert resp.status == 200, resp.status
                for k in range(4):
                    i = (ctr * 11 + k * 7) % n_objects
                    t0 = pc()
                    resp = await handler(_preq(i, f"u{ctr}-{k}"))
                    bl["put"].append(pc() - t0)
                    assert resp.status == 200, resp.status
                for k in range(max(2, n_muts // (blocks * 3))):
                    i = (ctr * 17 + k * 3) % n_objects
                    t0 = pc()
                    _fan_mut(store, watches, i, f"m{ctr}-{k}")
                    bl["fanout"].append(pc() - t0)
                ctr += 1
            # paired per-block p50s: the ratio within one block cancels
            # the drift this host shows BETWEEN blocks
            for name, bl in block.items():
                for lane, vals in bl.items():
                    times[name][lane].append(_p50(vals))
        for w in watches:
            w.close()
        store.close()
        handler.close()
        out = {name: {"p50_list_us": round(_p50(tl["list"]) * 1e6, 2),
                      "p50_get_us": round(_p50(tl["get"]) * 1e6, 2),
                      "p50_put_us": round(_p50(tl["put"]) * 1e6, 2),
                      "p50_fanout_us": round(_p50(tl["fanout"]) * 1e6, 2)}
               for name, tl in times.items()}
        # per-lane overhead = median over blocks of the paired ratio;
        # the two GATED lanes pool every op class's per-block ratios
        # (ratios are dimensionless, so pooling list/get/put is sound
        # and the median over ~150 paired ratios beats any single
        # class's noise floor)
        for name, tl in times.items():
            if name == "off":
                continue
            ratios = {}
            pooled: dict[str, list[float]] = {"store": [], "watchers": []}
            for lane in ("list", "get", "put", "fanout"):
                pairs = [m / b for m, b in zip(tl[lane], times["off"][lane])
                         if b > 0]
                ratios[f"p50_{lane}_us"] = round(
                    100.0 * (_p50(pairs) - 1.0), 2)
                pooled["watchers" if lane == "fanout"
                       else "store"].extend(pairs)
            out[name]["paired_overhead_pct"] = ratios
            out[name]["lane_overhead_pct"] = {
                k: round(100.0 * (_p50(v) - 1.0), 2)
                for k, v in pooled.items()}
        return out

    async def byte_check() -> dict[str, str]:
        """The wire-neutrality proof: an identical op sequence against a
        fresh deterministic store per mode; every response body and
        event line feeds the mode's digest."""
        digests: dict[str, str] = {}
        for name, env in mode_envs:
            set_mode(env)
            store = LogicalStore(indexed=True,
                                 clock=lambda: 1_700_000_000.0)
            handler = RestHandler(store, default_scheme(), admission=None)
            for i in range(min(n_objects, 1000)):
                store.create("configmaps", "c0", _cm(i, str(i)))
            watches = [store.watch("configmaps")
                       for _ in range(min(n_watchers, 16))]
            digest = hashlib.sha256()
            lreq = Request("GET", "/clusters/c0/api/v1/configmaps",
                           {}, {}, b"")
            for j in range(min(n_reqs, 200)):
                i = j % min(n_objects, 1000)
                req = (lreq if j % 4 == 0
                       else _greq(i) if j % 4 == 1
                       else _preq(i, f"u{j}"))
                resp = await handler(req)
                digest.update(resp.body)
                for w in watches:
                    for line in store.encode_events(w.drain()):
                        digest.update(line)
            for w in watches:
                w.close()
            store.close()
            handler.close()
            digests[name] = digest.hexdigest()
        return digests

    modes = asyncio.run(measure())
    digests = asyncio.run(byte_check())
    for name in modes:
        modes[name]["sha256"] = digests[name]
    bytes_equal = (digests["off"] == digests["sampled"]
                   == digests["always"])
    sampled_overhead = modes["sampled"]["lane_overhead_pct"]
    headline = max(sampled_overhead.values())

    # ---- convergence attribution on a router + 2 shards + standby ----

    async def conv_drive(router_url: str, cluster: str) -> dict:
        from .syncer.engine import CLUSTER_LABEL, BatchSyncEngine

        phys = LogicalStore()
        up = RestClient(router_url, cluster=cluster)
        writer = RestClient(router_url, cluster=cluster)
        down = Client(phys, "phys")
        engine = BatchSyncEngine(up, down, "configmaps", "bench-loc",
                                 backend="host", batch_window=0.005,
                                 resync_period=None)
        await engine.start()
        profiles: list[dict] = []
        traces: list[dict] = []
        try:
            for k in range(n_conv):
                name = f"conv-{k}"
                body = {"apiVersion": "v1", "kind": "ConfigMap",
                        "metadata": {"name": name, "namespace": "default",
                                     "clusterName": cluster,
                                     "labels": {CLUSTER_LABEL: "bench-loc"}},
                        "data": {"v": "0"}}
                ctx = obs.TRACER.mint(sampled=True)
                t0 = time.time()
                with obs.use(ctx):
                    resp = writer.create("configmaps", body)
                t_ack = time.time()
                rv = resp["metadata"]["resourceVersion"]
                obs.phase("write", ctx, t0, t_ack, rv=str(rv), obj=name)
                deadline = time.time() + 30.0
                while time.time() < deadline:
                    try:
                        dobj = down.get("configmaps", name, "default")
                        break
                    except kerrors.NotFoundError:
                        await asyncio.sleep(0.01)
                else:
                    raise RuntimeError(f"{name} never synced downstream")
                dobj["status"] = {"observed": True, "k": k}
                down.update_status("configmaps", dobj)
                while time.time() < deadline:
                    o = writer.get("configmaps", name, "default")
                    if (o.get("status") or {}).get("observed"):
                        break
                    await asyncio.sleep(0.01)
                else:
                    raise RuntimeError(f"{name} status never upsynced")
                t_obs = time.time()
                obs.phase("e2e", ctx, t0, t_obs, rv=str(rv), obj=name)
                # assemble: router scatter (client→router→shard→repl
                # spans) + the engine's rv-linked convergence fragment
                rc = RestClient(router_url)
                try:
                    doc = rc._request(
                        "GET", f"/debug/trace?id={ctx.trace_id}") or {}
                finally:
                    rc.close()
                by_trace: dict[str, list[dict]] = {}
                for s in obs.TRACER.spans():
                    by_trace.setdefault(s["trace"], []).append(s)
                span_lists = [doc.get("spans", [])] + list(by_trace.values())
                merged = assemble.merge_fragments(span_lists, rv=rv)
                profiles.append(assemble.phase_profile(merged))
                traces.append(assemble.summarize_trace(merged,
                                                       ctx.trace_id))
        finally:
            await engine.stop()
            up.close()
            writer.close()
            phys.close()
        return {"profiles": profiles, "traces": traces}

    def conv_run() -> dict:
        from .server.server import Config
        from .server.threaded import ServerThread
        from .sharding import ShardRing

        set_mode({"KCP_TRACE": "1", "KCP_TRACE_SAMPLE": "1"})
        tmp = tempfile.mkdtemp(prefix="kcp-bench-trace-")
        threads: list = []
        try:
            s0 = ServerThread(Config(
                durable=True, root_dir=os.path.join(tmp, "s0"), tls=False,
                install_controllers=False)).start()
            threads.append(s0)
            s1 = ServerThread(Config(
                durable=True, root_dir=os.path.join(tmp, "s1"), tls=False,
                install_controllers=False)).start()
            threads.append(s1)
            standby = ServerThread(Config(
                role="standby", primary=s0.address, durable=True,
                root_dir=os.path.join(tmp, "sb"), tls=False)).start()
            threads.append(standby)
            spec = f"s0={s0.address}|{standby.address},s1={s1.address}"
            router = ServerThread(Config(role="router", shards=spec,
                                         durable=False, tls=False)).start()
            threads.append(router)
            ring = ShardRing.from_spec(spec)
            cluster = next(f"conv{i}" for i in range(256)
                           if ring.owner_index(f"conv{i}") == 0)
            # semi-sync must be live before the first traced write, or
            # the repl.ack span never appears: wait for the standby feed
            sc = RestClient(s0.address)
            try:
                deadline = time.time() + 30.0
                while time.time() < deadline:
                    st = sc._request("GET", "/replication/status") or {}
                    if st.get("subscribers", 0) >= 1:
                        break
                    time.sleep(0.05)
            finally:
                sc.close()
            out = asyncio.run(conv_drive(router.address, cluster))
            out["cluster"] = cluster
            out["topology"] = "router + 2 durable shards + standby(s0)"
            return out
        finally:
            for t in reversed(threads):
                try:
                    t.stop()
                except Exception:  # noqa: BLE001 - best-effort teardown
                    pass

    conv = conv_run()
    sums_ok = [bool(p.get("sum_ok")) for p in conv["profiles"]]
    phase_names = sorted({p for prof in conv["profiles"]
                          for p in prof.get("phases", {})})
    return {
        "metric": "trace_overhead_p50_pct",
        "value": round(headline, 2),
        "unit": "%",
        "trace_bench": {
            "objects": n_objects, "requests": n_reqs,
            "watchers": n_watchers, "mutations": n_muts,
            "modes": modes,
            "overhead_pct": {
                "sampled": sampled_overhead,
                "always": modes["always"]["lane_overhead_pct"]},
            "bytes_equal": bytes_equal,
            "convergence": {
                "runs": n_conv,
                "topology": conv.get("topology"),
                "cluster": conv.get("cluster"),
                "sum_reconciles": sums_ok,
                "all_sum_ok": all(sums_ok) and bool(sums_ok),
                "phases_seen": phase_names,
                "profiles": conv["profiles"],
                "traces": conv["traces"],
            },
        },
    }


def card_line() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    ``None`` where there is no ``nvidia-smi``."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--rows", type=int, default=131072)
    ap.add_argument("--churn", type=int, default=768)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--pipeline", choices=("serial", "double"), default=None)
    lane = ap.add_mutually_exclusive_group()
    lane.add_argument("--placement", action="store_true",
                      help="run the fleet bin-pack lane (BASELINE configs[2])")
    lane.add_argument("--fleet", action="store_true",
                      help="ragged against per-bucket fleet dispatch")
    lane.add_argument("--pagination", action="store_true",
                      help="paged against one-shot relists")
    lane.add_argument("--gauntlet", action="store_true",
                      help="one composed scenario per BASELINE.json config")
    lane.add_argument("--trace", action="store_true",
                      help="tracing's cost, wire neutrality, attribution")
    args = ap.parse_args(argv)
    if args.placement:
        env = lambda name, default: int(os.environ.get(  # noqa: E731
            f"KCP_BENCH_PLACEMENT_{name}", "") or default)
        print(json.dumps(placement_bench(
            args.device, W=env("WORKSPACES", 10000), P=env("PCLUSTERS", 8),
            spread=env("SPREAD", 2), iters=env("ITERS", 5),
            loop_rows=env("LOOP_ROWS", 0), dirty=env("DIRTY_ROWS", 37))))
        return
    if args.fleet or args.pagination or args.gauntlet or args.trace:
        try:
            # the lanes with device work resolve it before any run: a
            # missing card ends the lane here, with nothing measured
            if args.fleet:
                device = resolve_device(args.device)
            elif args.gauntlet:
                from .scenarios.engine import scenario_device

                specs = gauntlet_specs()
                for idx in gauntlet_selected():
                    scenario_device(specs[idx], args.device)
        except RuntimeError as err:
            print(f"bench: {err}", file=sys.stderr)
            sys.exit(2)
        if args.fleet:
            out = asyncio.run(measure_fleet(device))
            out["device"] = str(device)
        elif args.pagination:
            out = pagination_bench()
        elif args.gauntlet:
            out = gauntlet_bench(args.device)
        else:
            out = trace_bench()
        out["card"] = card_line()
        out_path = os.environ.get("KCP_GAUNTLET_OUT", "") if args.gauntlet else ""
        if out_path:
            with open(out_path, "w", encoding="utf-8") as f:
                json.dump(out, f, indent=1)
                f.write("\n")
        print(json.dumps(out))
        return
    core = FusedCore(batch_window=0.0005, pipeline=args.pipeline, device=args.device)
    out = asyncio.run(closed_loop(core, args.rows, churn=args.churn,
                                  seconds=args.seconds))
    out.pop("owner")
    out["device"] = str(core.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
