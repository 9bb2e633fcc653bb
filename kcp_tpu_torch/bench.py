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

More lanes, each one JSON line with the reference's keys (plus
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
- ``--suite`` (``KCP_BENCH_ROWS``): BASELINE configs[2..4] (the splitter,
  schema hashing, label fan-out) on the device, and the decision+fanout
  A/B: the plain version eager, compiled by ``torch.compile``, and the
  CUDA kernel. Device work: the card unless ``--device cpu``.
- ``--sharded`` (``KCP_BENCH_SHARD_*``): fleet write capacity at 1/2/4
  ``kcp start`` shard processes (time-sliced per shard, driven by
  ``--shard-loadgen`` children), the router's relay, merged list and
  watch, and the shard-kill drill.
- ``--smartclient`` (``KCP_BENCH_SMART_*``): direct (smart client)
  against routed writes, routed and direct bytes equal, the scatter
  wire against the joined one, and the ring-change drill under a
  ``router.proxy`` fault schedule.
- ``--elastic`` (``KCP_BENCH_ELASTIC_*``): capacity before and after the
  fleet doubles live under writers, with zero acked writes lost.

- ``--store`` (``KCP_BENCH_STORE_*``): the indexed store against the
  linear scan (``LogicalStore(indexed=False)``), lists and watch fan-out.
- ``--encode`` (``KCP_BENCH_ENCODE_*``): encode-once serving against
  per-request serialization through a socketless ``RestHandler``, the
  wires' sha256 equal.
- ``--admission`` (``KCP_BENCH_ADM_*``): the admission chain's overhead,
  direct and over HTTP, and a 100-tenant noisy-neighbor storm.
- ``--replica`` (``KCP_BENCH_REPL_*``): read capacity at 0/1/2 WAL-fed
  replicas, their lag and bytes, and the kill-the-primary drill.
- ``--consistent`` (``KCP_BENCH_CONS_*``): consistent-read capacity over
  the replicas, the RV barrier's wait under a ``repl.ship`` delay, and
  read-your-writes through the router.
- ``--writes`` (``KCP_BENCH_WRITES_*``): serial against grouped commit
  under ``KCP_WAL_SYNC=fsync``, state and RV sequences equal, and the
  kill-mid-window drill.
- ``--watchers`` (``KCP_BENCH_WATCH*``): live watch streams against a
  ``--watchers-serve`` child (delivery p50/p99, the child's RSS per
  watcher and under soak), coalesced against per-batch watch flushes
  (per-watcher stream sha256 equal), and the slow-watcher evict drill.

The sharded-fleet lanes and these seven start every server without
controllers, so they do no device work: their rates are the host's. A lane
with device work and no card (nor ``--device cpu``) exits 2 before any
run.
"""

from __future__ import annotations

import argparse
import asyncio
import functools
import hashlib
import json
import os
import re
import sys
import threading
import time

import numpy as np

from . import faults
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
# --suite: BASELINE configs 2-4 and the decision+fanout A/B on the device


def suite_inputs(rows: int = 131072) -> dict:
    """The suite's inputs from seed 3, drawn in the reference's order
    (``bench.py`` ``suite``): config 2's replicas and availability, config
    3's 5,000 schemas (no draw), config 4's pair hashes and selectors, then
    the A/B's upstream mirror (the downstream mirror is its copy), pair
    hashes and selectors at ``rows`` x 64 slots, L = 8, C = 64, with a
    bucket-wide mask whose last 8 slots are set. ``"ab"`` holds the
    kernel's seven arguments in order, as numpy arrays."""
    rng = np.random.default_rng(3)
    x = {"replicas": rng.integers(0, 100, 10_000).astype(np.int32),
         "avail": rng.random((10_000, 8)) < 0.9,
         "schemas": [{"type": "object",
                      "properties": {f"f{i}": {"type": "string"} for i in range(20)},
                      "description": str(k)} for k in range(5_000)]}
    x["fan_pair"] = rng.integers(1, 1000, (100_000, 8)).astype(np.uint32)
    x["fan_sels"] = rng.integers(1, 1000, 64).astype(np.uint32)
    s, l, c = 64, 8, 64
    up = rng.integers(1, 2**32, (rows, s), dtype=np.uint32)
    mask = np.zeros(s, bool)
    mask[-8:] = True
    pair = rng.integers(1, 2**32, (rows, l), dtype=np.uint32)
    sels = rng.integers(1, 2**32, c, dtype=np.uint32)
    x["ab"] = (up, np.ones(rows, bool), up.copy(), np.ones(rows, bool), mask, pair, sels)
    return x


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_kernel(fn, *args, iters: int = 30) -> float:
    """Seconds per call: the median of three averages over ``iters``
    back-to-back calls after one warm-up call (the reference's rule), the
    card synchronized where the reference blocks until ready."""
    dev = args[0].device
    fn(*args)
    _sync(dev)
    samples = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        _sync(dev)
        samples.append((time.perf_counter() - t0) / iters)
    return sorted(samples)[1]


def suite(device=None) -> dict:
    """The kernel lanes of BASELINE.json (configs[2..4]) and the A/B of the
    fused decision+fanout pass on ``device`` (the card by default), at the
    reference's shapes and rates (``bench.py --suite``); ``KCP_BENCH_ROWS``
    sets the A/B's rows as there. One row each:

    - splitter bin-packing: ``split_replicas`` over 10,000 x 8;
    - schema hash bucketing: 5,000 schemas tokenized on the host and
      hashed on the device, 1 / (host s + device s) per schema;
    - label fan-out: 100,000 objects x 8 pair hashes x 64 selectors;
    - the A/B: the plain version eager, the plain version compiled by
      ``torch.compile`` (the reference's XLA row), and the kernel, with its
      ratio to the compiled row. On the CPU the kernel's wrapper runs its
      plain version, and its row says so.

    Each time is the median of three averages over 30 calls; a compile
    happens in a warm-up call of its own and is reported as ``compile_s``,
    outside every rate. ``seconds`` holds each row's seconds per call."""
    import torch

    from .ops import cuda_kernels
    from .ops.labelmatch import fanout_match
    from .ops.placement import split_replicas
    from .ops.schemahash import schema_hashes, tokenize_schemas
    from .utils.device import resolve_device

    dev = resolve_device(device)
    x = suite_inputs(int(os.environ.get("KCP_BENCH_ROWS", "131072")))

    def put(a):
        a = np.ascontiguousarray(a)
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(dev)

    rows: list[tuple[str, str, str]] = []
    seconds: dict[str, float] = {}

    def row(name: str, scale: str, rate: str, dt: float) -> None:
        rows.append((name, scale, rate))
        seconds[name] = dt

    # configs[2]: splitter bin-packing, 10k workspaces x 8 pclusters
    dt = _time_kernel(split_replicas, put(x["replicas"]), put(x["avail"]))
    row("splitter bin-packing", "10k workspaces x 8 pclusters",
        f"{10_000 / dt / 1e6:.1f}M splits/s", dt)

    # configs[3]: host tokenization (per schema) + one device hash reduce
    n_schemas = len(x["schemas"])
    t0 = time.perf_counter()
    tokens = tokenize_schemas(x["schemas"])
    host_dt = time.perf_counter() - t0
    dev_dt = _time_kernel(schema_hashes, put(tokens))
    dt = host_dt / n_schemas + dev_dt / n_schemas
    row("schema hash bucketing", "5k tenant CRD sets", f"{1 / dt / 1e3:.0f}k schemas/s", dt)

    # configs[4]: informer fan-out, 100k objects x 64 selectors
    def fan(p, s):
        return fanout_match(p, s).sum(dim=0, dtype=torch.int32)

    dt = _time_kernel(fan, put(x["fan_pair"]), put(x["fan_sels"]))
    row("label fan-out", "100k objects x 64 selectors", f"{100_000 / dt / 1e6:.0f}M obj/s", dt)

    # the A/B: the fused decision+fanout pass at bench scale
    ab = tuple(put(a) for a in x["ab"])
    b, s = ab[0].shape
    scale = f"{b} rows x {s} slots"
    plain = cuda_kernels.decide_and_match_plain
    dt_e = _time_kernel(plain, *ab)
    row("decision+fanout eager", scale, f"{b / dt_e / 1e6:.0f}M rows/s", dt_e)
    fn = torch.compile(plain, dynamic=False)
    t0 = time.perf_counter()
    fn(*ab)
    _sync(dev)
    compile_s = time.perf_counter() - t0
    dt_c = _time_kernel(fn, *ab)
    row("decision+fanout torch.compile", scale, f"{b / dt_c / 1e6:.0f}M rows/s", dt_c)
    dt_k = _time_kernel(cuda_kernels.decide_and_match, *ab)
    name = ("decision+fanout CUDA" if dev.type == "cuda"
            else "decision+fanout plain (the CUDA wrapper on cpu)")
    row(name, scale, f"{b / dt_k / 1e6:.1f}M rows/s ({dt_c / dt_k:.2f}x vs torch.compile)", dt_k)

    print("| lane | scale | rate |", file=sys.stderr)
    print("|---|---|---|", file=sys.stderr)
    for r in rows:
        print("| " + " | ".join(r) + " |", file=sys.stderr)
    return {"suite": [{"lane": n, "scale": sc, "rate": r} for n, sc, r in rows],
            "seconds": seconds, "compile_s": compile_s, "device": str(dev),
            "host_cpus": os.cpu_count()}


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
    from .syncer.core import FusedCore

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
    from .syncer.core import FusedCore

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
    from .utils.device import resolve_device

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


# --------------------------------------------------------------------------
# --sharded, --smartclient, --elastic: the sharded fleet's host path

#: what the host lanes' numbers are: they start every server without
#: controllers, so no lane touches a device
HOST_PATH_NOTE = ("host path: no device work; every rate is the host CPU's, on the "
                  "machine whose card is named")
#: the --sharded lane's write-loadgen child (:func:`shard_loadgen`)
LOADGEN_ARGV = [sys.executable, "-m", "kcp_tpu_torch.bench", "--shard-loadgen"]


#: set for every server the three lanes start (children inherit it; an
#: in-process server reads it as it is built): a write-flow budget above any
#: rate a lane reaches, so that the lanes measure the write path and not the
#: admission throttle. The default budget (500 writes/s a tenant, burst
#: 1,000) is within reach of one writer a tenant on a fast host: at its
#: default shape the reference's ``bench.py --sharded`` meets it too (a 429
#: ends a loadgen in the middle of a 4-shard slice), and the reference's own
#: admission lane raises the budget the same way.
LANE_SERVER_ENV = {"KCP_FLOW_RATE": "1e9"}


def _lane_servers(fn):
    """Run ``fn`` with :data:`LANE_SERVER_ENV` set, restoring the
    environment after."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        saved = {k: os.environ.get(k) for k in LANE_SERVER_ENV}
        os.environ.update(LANE_SERVER_ENV)
        try:
            return fn(*args, **kwargs)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return run


def ring_partition(names: list[str], clusters: list[str]) -> list[list[str]]:
    """Each ring member's clusters, in ring order (the HRW owner over the
    ring's names): the slices the time-sliced capacity lanes drive."""
    from .sharding import owner_name

    return [[c for c in clusters if owner_name(names, c) == n] for n in names]


def _stop_all(procs) -> None:
    """SIGTERM every child still running, then reap each (SIGKILL after
    10 s)."""
    import signal
    import subprocess

    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()


def shard_loadgen() -> None:
    """Write-loadgen child for ``--sharded`` (``python -m
    kcp_tpu_torch.bench --shard-loadgen``, parameters via ``KCP_LG_*``): ring-routes configmap creates straight
    to each cluster's owning shard (the smart-client mode the rendezvous
    ring is deterministic FOR — a production fleet scales routers
    horizontally; the loadgen measures the shards, not one router
    process). Prints ``ready`` after warmup, starts on a ``go`` line from
    stdin (the cross-loadgen barrier), writes for KCP_LG_SECONDS, and
    reports ``{"writes": N, "seconds": measured}`` as JSON."""
    from .server.rest import MultiClusterRestClient
    from .sharding import ShardRing

    ring = ShardRing.from_spec(os.environ["KCP_LG_SPEC"])
    clusters = os.environ["KCP_LG_CLUSTERS"].split(",")
    seconds = float(os.environ["KCP_LG_SECONDS"])
    prefix = os.environ["KCP_LG_PREFIX"]
    # one wildcard client (= one kept-alive connection) per shard; writes
    # carry metadata.clusterName, which the shard's own wildcard-write
    # rule resolves — the same body works against a monolith unchanged
    clients = [MultiClusterRestClient(s.url) for s in ring]
    owner = {c: ring.owner_index(c) for c in clusters}

    def body(k: int, warm: bool = False) -> dict:
        c = clusters[k % len(clusters)]
        name = f"{prefix}-{'w' if warm else 'n'}{k}"
        return {"apiVersion": "v1", "kind": "ConfigMap",
                "metadata": {"name": name, "namespace": "default",
                             "clusterName": c},
                "data": {}}, owner[c]

    for k in range(2 * len(clients)):  # warm connections + discovery
        obj, idx = body(k, warm=True)
        clients[idx].create("configmaps", obj)
    print("ready", flush=True)
    sys.stdin.readline()  # the barrier: every loadgen starts together
    n = 0
    t0 = time.perf_counter()
    stop = t0 + seconds
    while time.perf_counter() < stop:
        obj, idx = body(n)
        clients[idx].create("configmaps", obj)
        n += 1
    print(json.dumps({"writes": n,
                      "seconds": time.perf_counter() - t0}), flush=True)


@_lane_servers
def sharded_bench() -> dict:
    """Sharded control plane A/B (``--sharded``): fleet write capacity at
    1/2/4 shards, merged wildcard list/watch behavior through the router,
    and the shard-kill drill. One JSON line; ``value`` is the fleet
    *capacity* speedup at the largest fleet vs the 1-shard monolith.

    Two scaling numbers, because they answer different questions:

    - ``capacity_speedup`` (the headline): shards share nothing — no
      cross-shard traffic on single-cluster writes, ring-partitioned
      keyspace — so fleet capacity on N hosts is the sum of per-shard
      rates. Each shard's rate is measured in its own time slice under
      exactly its ring partition of the clusters (idle peers cost
      nothing), which stays honest on CI hosts with fewer cores than
      server processes. The gate is real: a ring that routed everything
      to one shard, or any cross-shard chatter on the write path, drags
      the sum back toward 1x.
    - ``concurrent_speedup``: all shards driven simultaneously on THIS
      host — the wall-clock truth, bounded by host cores (~1x on a
      1-core CI runner; near the capacity number when cores >= fleet).

    The router phases measure what the frontend adds: single-cluster
    relay throughput through one router process, merged wildcard list
    latency, write->merged-watch-event latency, and the kill drill
    (victim SIGKILLed mid-traffic: fail-fast 503 once the breaker trips,
    terminal in-stream 410 on the merged watch, zero acked writes lost
    after the WAL-restored restart + relist catchup).
    """
    import subprocess
    import tempfile
    from urllib.parse import urlsplit

    from .scenarios.topology import spawn_server
    from .server.rest import MultiClusterRestClient, RestClient
    from .sharding import ShardRing
    from .utils import errors as kerrors

    fleets = sorted(int(x) for x in os.environ.get(
        "KCP_BENCH_SHARD_FLEETS", "1,2,4").split(",") if x)
    seconds = float(os.environ.get("KCP_BENCH_SHARD_SECONDS", "2.0"))
    n_loadgens = int(os.environ.get("KCP_BENCH_SHARD_CLIENTS", "2"))
    n_clusters = int(os.environ.get("KCP_BENCH_SHARD_CLUSTERS", "24"))
    lat_events = int(os.environ.get("KCP_BENCH_SHARD_EVENTS", "40"))
    clusters = [f"t{i}" for i in range(n_clusters)]

    def start_loadgens(spec: str, subset: list[str], secs: float,
                       tag: str) -> float:
        """n_loadgens barrier-synced loadgen children over ``subset`` of
        the clusters; returns the aggregate write rate."""
        procs = []
        for j in range(n_loadgens):
            env = dict(os.environ,
                       KCP_LG_SPEC=spec, KCP_LG_SECONDS=str(secs),
                       KCP_LG_CLUSTERS=",".join(
                           subset[j::n_loadgens] or subset),
                       KCP_LG_PREFIX=f"{tag}-lg{j}")
            env.pop("KCP_FAULTS", None)  # a chaos schedule must not leak in
            procs.append(subprocess.Popen(
                LOADGEN_ARGV, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, env=env, text=True, cwd=REPO_ROOT))
        for p in procs:
            if p.stdout.readline().strip() != "ready":
                raise RuntimeError(f"shard loadgen exited rc={p.wait()} before ready")
        for p in procs:  # release the barrier everywhere at once
            p.stdin.write("go\n")
            p.stdin.flush()
        rate = 0.0
        for p in procs:
            r = json.loads(p.stdout.readline())
            rate += r["writes"] / r["seconds"]
            p.stdin.close()
            p.wait(timeout=30)
        return rate

    # ---- phase 1: write capacity at each fleet size
    fleet_stats: dict[str, dict] = {}
    largest: tuple[list, str, ShardRing] | None = None
    for n in fleets:
        procs, urls = [], []
        try:
            for _ in range(n):
                p, addr = spawn_server(["--in-memory", "--listen-port", "0"])
                procs.append(p)
                urls.append(addr)
            spec = ",".join(f"s{i}={u}" for i, u in enumerate(urls))
            ring = ShardRing.from_spec(spec)
            owned = ring_partition([s.name for s in ring], clusters)
            concurrent = start_loadgens(spec, clusters, seconds, f"f{n}c")
            per_shard = []
            for i in range(n):
                # time-sliced capacity: only shard i's partition driven
                rate = start_loadgens(spec, owned[i], max(1.0, seconds / n),
                                      f"f{n}s{i}")
                per_shard.append({"shard": i, "clusters": len(owned[i]),
                                  "per_s": round(rate)})
            fleet_stats[str(n)] = {
                "concurrent_per_s": round(concurrent),
                "capacity_per_s": round(sum(s["per_s"] for s in per_shard)),
                "per_shard": per_shard,
            }
            if n == fleets[-1]:
                largest = (procs, spec, ring)
                procs = []  # keep the largest fleet alive for the router
        finally:
            _stop_all(procs)

    base = fleet_stats[str(fleets[0])]
    capacity_speedup = {
        str(n): round(fleet_stats[str(n)]["capacity_per_s"]
                      / max(base["capacity_per_s"], 1), 2)
        for n in fleets[1:]}
    concurrent_speedup = {
        str(n): round(fleet_stats[str(n)]["concurrent_per_s"]
                      / max(base["concurrent_per_s"], 1), 2)
        for n in fleets[1:]}

    # ---- phase 2: the router over the largest fleet
    assert largest is not None
    shard_procs, spec, ring = largest
    router_stats: dict = {}
    try:
        rp, raddr = spawn_server(["--role", "router", "--shards", spec,
                                  "--in-memory", "--listen-port", "0"])
        shard_procs.append(rp)
        wc = MultiClusterRestClient(raddr)

        # relay throughput: single-cluster writes through ONE router hop
        c0 = clusters[0]
        rc = RestClient(raddr, cluster=c0)
        rc.create("configmaps", {"apiVersion": "v1", "kind": "ConfigMap",
                                 "metadata": {"name": "relay-warm",
                                              "namespace": "default"}})
        t0 = time.perf_counter()
        relay_n = 0
        while time.perf_counter() - t0 < max(1.0, seconds / 2):
            rc.create("configmaps", {
                "apiVersion": "v1", "kind": "ConfigMap", "metadata": {
                    "name": f"relay-{relay_n}", "namespace": "default"}})
            relay_n += 1
        relay_per_s = relay_n / (time.perf_counter() - t0)

        # merged wildcard list latency (the fleet holds phase-1 objects)
        lists = []
        for _ in range(10):
            t0 = time.perf_counter()
            items, rv = wc.list("configmaps")
            lists.append(time.perf_counter() - t0)

        # write -> merged-watch-event latency across all shards
        async def watch_lat() -> list[float]:
            _items, rv = wc.list("configmaps")
            w = wc.watch("configmaps", since_rv=rv)
            await w.next_batch(0.05)
            await asyncio.sleep(0.2)
            lats = []
            try:
                for k in range(lat_events):
                    c = clusters[k % len(clusters)]
                    name = f"lat-{k}"
                    t0 = time.perf_counter()
                    wc.create("configmaps", {
                        "apiVersion": "v1", "kind": "ConfigMap",
                        "metadata": {"name": name, "namespace": "default",
                                     "clusterName": c}})
                    seen = False
                    for _ in range(400):
                        for ev in await w.next_batch(0.05):
                            if ev.name == name:
                                lats.append(time.perf_counter() - t0)
                                seen = True
                        if seen:
                            break
                    assert seen, f"merged watch never delivered {name}"
            finally:
                w.close()
            return lats

        lats = asyncio.run(watch_lat())
        router_stats = {
            "shards": len(ring),
            "relay_per_s": round(relay_per_s),
            "list_p50_ms": round(
                float(np.percentile(np.asarray(lists), 50)) * 1e3, 2),
            "watch_events": len(lats),
            "watch_lat_p50_ms": round(
                float(np.percentile(np.asarray(lats), 50)) * 1e3, 2),
            "watch_lat_p99_ms": round(
                float(np.percentile(np.asarray(lats), 99)) * 1e3, 2),
        }
    finally:
        _stop_all(shard_procs)

    # ---- phase 3: shard-kill drill (2 durable shards + router)
    kill_stats: dict = {}
    with tempfile.TemporaryDirectory(prefix="kcp-sharded-") as tmp:
        procs = []
        try:
            urls = []
            for i in range(2):
                p, addr = spawn_server(["--root-dir",
                                        os.path.join(tmp, f"shard{i}"),
                                        "--listen-port", "0"])
                procs.append(p)
                urls.append(addr)
            spec = ",".join(f"s{i}={u}" for i, u in enumerate(urls))
            ring = ShardRing.from_spec(spec)
            rp, raddr = spawn_server(["--role", "router", "--shards", spec,
                                      "--in-memory", "--listen-port", "0"])
            procs.append(rp)
            wc = MultiClusterRestClient(raddr)
            # two clusters on distinct shards: a victim and a survivor
            owners: dict[int, str] = {}
            for i in range(64):
                owners.setdefault(ring.owner_index(f"k{i}"), f"k{i}")
                if len(owners) == 2:
                    break
            victim_idx, victim_c = sorted(owners.items())[0]
            _surv_idx, surv_c = sorted(owners.items())[1]
            acked: set[tuple[str, str]] = set()

            def write(c: str, name: str, retry: bool = False) -> None:
                while True:
                    try:
                        wc.create("configmaps", {
                            "apiVersion": "v1", "kind": "ConfigMap",
                            "metadata": {"name": name,
                                         "namespace": "default",
                                         "clusterName": c}})
                        acked.add((c, name))
                        return
                    except kerrors.AlreadyExistsError:
                        acked.add((c, name))
                        return
                    except (kerrors.UnavailableError, ConnectionError,
                            OSError):
                        if not retry:
                            raise
                        time.sleep(0.05)

            for k in range(20):
                write(victim_c, f"pre-{k}")
                write(surv_c, f"pre-{k}")

            async def drill() -> None:
                _items, rv = wc.list("configmaps")
                w = wc.watch("configmaps", since_rv=rv)
                await w.next_batch(0.05)
                await asyncio.sleep(0.2)
                t_kill = time.perf_counter()
                procs[victim_idx].kill()
                procs[victim_idx].wait(timeout=10)
                # the merged watch must end with a terminal in-stream 410
                gone_ms = None
                try:
                    for _ in range(600):
                        await w.next_batch(0.05)
                except kerrors.GoneError:
                    gone_ms = (time.perf_counter() - t_kill) * 1e3
                finally:
                    w.close()
                kill_stats["watch_terminal_410"] = gone_ms is not None
                kill_stats["watch_410_ms"] = round(gone_ms or -1.0, 1)
                # victim-owned requests fail; once the breaker trips they
                # fail FAST (503 without a connect attempt)
                vc = RestClient(raddr, cluster=victim_c)
                first_503_ms = None
                attempt_ms = []
                for k in range(8):
                    t0 = time.perf_counter()
                    try:
                        vc.get("configmaps", "pre-0", "default")
                    except (kerrors.UnavailableError, ConnectionError,
                            OSError):
                        pass
                    dt = (time.perf_counter() - t0) * 1e3
                    attempt_ms.append(dt)
                    if first_503_ms is None:
                        first_503_ms = round(
                            (time.perf_counter() - t_kill) * 1e3, 1)
                kill_stats["unavailable_after_kill_ms"] = first_503_ms
                kill_stats["failfast_ms"] = round(min(attempt_ms[-3:]), 2)
                # survivor keeps serving through the router all along
                for k in range(10):
                    write(surv_c, f"out-{k}")
                # revive the victim on its OLD address, WAL-restored
                port = urlsplit(urls[victim_idx]).port
                deadline = time.time() + 30
                while True:
                    try:
                        p2, _ = spawn_server(
                            ["--root-dir",
                             os.path.join(tmp, f"shard{victim_idx}"),
                             "--listen-port", str(port)])
                        procs[victim_idx] = p2
                        break
                    except RuntimeError:
                        if time.time() > deadline:
                            raise
                        # must yield the loop: the merged-watch reader
                        # runs on it while we wait out the shard restart
                        await asyncio.sleep(0.3)
                # catchup writes land once the breaker's probe re-closes
                for k in range(10):
                    write(victim_c, f"back-{k}", retry=True)

            asyncio.run(drill())
            # relist catchup: every acked write is present — zero lost
            deadline = time.time() + 30
            while True:
                items, _rv = wc.list("configmaps")
                have = {(o["metadata"]["clusterName"], o["metadata"]["name"])
                        for o in items}
                missing = acked - have
                if not missing or time.time() > deadline:
                    break
                time.sleep(0.3)
            kill_stats["acked_writes"] = len(acked)
            kill_stats["lost_after_catchup"] = len(missing)
        finally:
            _stop_all(procs)

    top = str(fleets[-1])
    out = {
        "metric": "sharded_write_capacity_speedup",
        "value": capacity_speedup.get(top, 1.0),
        "unit": "x",
        "sharded_bench": {
            "host_cpus": os.cpu_count(),
            "clusters": n_clusters,
            "loadgens": n_loadgens,
            "seconds": seconds,
            "fleets": fleet_stats,
            "capacity_speedup": capacity_speedup,
            "concurrent_speedup": concurrent_speedup,
            "router": router_stats,
            "kill": kill_stats,
        },
    }
    return out


@_lane_servers
def smartclient_bench() -> dict:
    """Smart-client + zero-copy wire A/B (``--smartclient``): single-
    cluster write throughput routed (client→router→shard) vs DIRECT
    (client→owning shard over the rendezvous ring, ``GET /ring``
    handshake), byte-equality of routed vs direct responses, the
    scatter-vs-join wire A/B (sha256 over real sockets), and the
    mid-bench ring-change drill — a shard drains, restarts on a NEW
    port, the ring republishes, and smart writers under an injected
    ``router.proxy`` fault schedule must complete with zero lost acked
    writes and zero surfaced errors (one-shot fallbacks absorb the
    move).

    One JSON line; ``value`` is the single-cluster write CAPACITY
    speedup: direct capacity (per-shard time slices summed — shards
    share nothing once the router hop is gone, the --sharded bench's
    honest-on-1-cpu discipline) over the routed ceiling through ONE
    router (routers don't sum: the hop being deleted IS the shared
    bottleneck). ``concurrent_speedup`` rides along — all writers at
    once on THIS host, the wall-clock truth (≈(client+router+shard) /
    (client+shard) cpu per op on a host with fewer cores than
    processes; near the capacity number when cores ≥ processes)."""
    import tempfile

    from .client.smart import SmartRestClient
    from .scenarios.topology import move_shard, shard_fleet, spawn_server
    from .server.rest import RestClient
    from .utils import errors as kerrors

    n_shards = int(os.environ.get("KCP_BENCH_SMART_SHARDS", "2"))
    seconds = float(os.environ.get("KCP_BENCH_SMART_SECONDS", "2.0"))
    n_clusters = int(os.environ.get("KCP_BENCH_SMART_CLUSTERS", "8"))
    n_threads = int(os.environ.get("KCP_BENCH_SMART_THREADS", "2"))
    clusters = [f"t{i}" for i in range(n_clusters)]
    names = ",".join(f"s{i}" for i in range(n_shards))

    def obj(cluster: str, name: str) -> dict:
        return {"apiVersion": "v1", "kind": "ConfigMap",
                "metadata": {"name": name, "namespace": "default",
                             "clusterName": cluster}, "data": {}}

    def write_loop(make_base, tag: str, pool: list[str] | None = None,
                   secs: float | None = None) -> tuple[float, list[float]]:
        """n_threads barrier-synced writer threads, each rotating its
        slice of ``pool`` (default: all clusters); returns
        (aggregate writes/s, per-op seconds)."""
        pool = pool if pool is not None else clusters
        secs = secs if secs is not None else seconds
        counts = [0] * n_threads
        lats: list[list[float]] = [[] for _ in range(n_threads)]
        barrier = threading.Barrier(n_threads + 1)

        def worker(k: int) -> None:
            base = make_base()
            subset = pool[k::n_threads] or pool
            scoped = {c: base.scoped(c) for c in subset}
            for j, c in enumerate(subset):  # warm conns + ring + schema
                scoped[c].create("configmaps", obj(c, f"{tag}-w{k}-{j}"))
            barrier.wait()
            stop_at = time.perf_counter() + secs
            n = 0
            while time.perf_counter() < stop_at:
                c = subset[n % len(subset)]
                t0 = time.perf_counter()
                scoped[c].create("configmaps", obj(c, f"{tag}-{k}-{n}"))
                lats[k].append(time.perf_counter() - t0)
                n += 1
            counts[k] = n
            base.close()

        threads = [threading.Thread(target=worker, args=(k,), daemon=True)
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        barrier.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        return sum(counts) / max(wall, 1e-9), [x for la in lats for x in la]

    def pct(vals: list[float], q: float) -> float:
        return round(float(np.percentile(np.asarray(vals), q)) * 1e3, 3)

    # ---- phase 1: routed vs direct throughput on a real subprocess fleet
    procs: list = []
    ab: dict = {}
    bytes_equal = True
    try:
        urls = []
        for i in range(n_shards):
            p, addr = spawn_server(["--in-memory", "--listen-port", "0",
                                    "--shard-name", f"s{i}",
                                    "--ring-names", names,
                                    "--ring-epoch", "1"])
            procs.append(p)
            urls.append(addr)
        spec = ",".join(f"s{i}={u}" for i, u in enumerate(urls))
        rp, raddr = spawn_server(["--role", "router", "--shards", spec,
                                  "--in-memory", "--listen-port", "0"])
        procs.append(rp)
        # alternating segments (r,d,r,d): host-load drift lands on both
        # arms instead of whichever ran second
        segs = max(1, int(os.environ.get("KCP_BENCH_SMART_SEGMENTS", "2")))
        d0 = REGISTRY.counter("smart_client_direct_total").value
        f0 = REGISTRY.counter("smart_client_fallback_total").value
        routed_rates, direct_rates = [], []
        routed_lat: list[float] = []
        direct_lat: list[float] = []
        for s in range(segs):
            rate, lat = write_loop(
                lambda: RestClient(raddr, cluster=clusters[0]), f"r{s}")
            routed_rates.append(rate)
            routed_lat.extend(lat)
            rate, lat = write_loop(
                lambda: SmartRestClient(raddr, cluster=clusters[0]),
                f"d{s}")
            direct_rates.append(rate)
            direct_lat.extend(lat)
        routed_rate = sum(routed_rates) / len(routed_rates)
        direct_rate = sum(direct_rates) / len(direct_rates)
        # direct CAPACITY: each shard's ring partition driven alone in
        # its own time slice (idle peers cost nothing on a 1-cpu host),
        # summed — shards share nothing on the direct write path, so
        # the sum is what N hosts serve. The routed ceiling is the ONE
        # router's concurrent rate: routers are the shared hop, they
        # don't sum — which is exactly the bottleneck going direct
        # deletes.
        per_shard = []
        for i, owned in enumerate(ring_partition(names.split(","), clusters)):
            if not owned:
                continue
            rate, _lat = write_loop(
                lambda: SmartRestClient(raddr, cluster=owned[0]),
                f"c{i}", pool=owned, secs=max(1.0, seconds / n_shards))
            per_shard.append({"shard": i, "clusters": len(owned),
                              "per_s": round(rate)})
        capacity_direct = sum(s["per_s"] for s in per_shard)
        direct_n = REGISTRY.counter("smart_client_direct_total").value - d0
        fallback_n = REGISTRY.counter(
            "smart_client_fallback_total").value - f0
        # byte equality: the same GETs and lists, routed vs direct
        sc = SmartRestClient(raddr, cluster=clusters[0])
        rc = RestClient(raddr, cluster=clusters[0])

        paths = [f"/clusters/{c}/api/v1/namespaces/default/configmaps"
                 for c in clusters[:4]]
        paths.append(f"/clusters/{clusters[0]}/api/v1/namespaces/"
                     f"default/configmaps/r0-w0-0")
        for path in paths:
            s1, _h1, b1 = sc.request_raw("GET", path)
            s2, _h2, b2 = rc.request_raw("GET", path)
            if (s1, hashlib.sha256(b1).hexdigest()) != (
                    s2, hashlib.sha256(b2).hexdigest()):
                bytes_equal = False
        sc.close()
        rc.close()
        ab = {
            "routed_per_s": round(routed_rate),
            "direct_per_s": round(direct_rate),
            "direct_capacity_per_s": capacity_direct,
            "per_shard": per_shard,
            "capacity_speedup": round(
                capacity_direct / max(routed_rate, 1e-9), 2),
            "concurrent_speedup": round(
                direct_rate / max(routed_rate, 1e-9), 2),
            "routed_p50_ms": pct(routed_lat, 50),
            "routed_p99_ms": pct(routed_lat, 99),
            "direct_p50_ms": pct(direct_lat, 50),
            "direct_p99_ms": pct(direct_lat, 99),
            "direct_requests": int(direct_n),
            "fallbacks_during_ab": int(fallback_n),
            "bytes_equal": bytes_equal,
        }
    finally:
        _stop_all(procs)

    # ---- phase 2: scatter-vs-join wire A/B over real sockets
    from .server.rest import MultiClusterRestClient
    from .server.server import Config
    from .server.threaded import ServerThread

    wire: dict = {}
    with ServerThread(Config(durable=False, install_controllers=False,
                             tls=False)) as srv:
        import http.client as hc
        from urllib.parse import urlsplit

        wc = MultiClusterRestClient(srv.address)
        pad = "y" * 50000
        for i in range(400):
            wc.create("configmaps", {
                "apiVersion": "v1", "kind": "ConfigMap",
                "metadata": {"name": f"w-{i}", "namespace": "default",
                             "clusterName": "wire"},
                "data": {"v": str(i), "pad": pad if i % 37 == 0 else "s"}})

        def fetch(scatter: bool) -> tuple[bytes, float]:
            os.environ["KCP_WIRE_SCATTER"] = "1" if scatter else "0"
            parts = urlsplit(srv.address)
            conn = hc.HTTPConnection(parts.hostname, parts.port,
                                     timeout=60)
            try:
                t0 = time.perf_counter()
                conn.request(
                    "GET",
                    "/clusters/wire/api/v1/namespaces/default/configmaps")
                resp = conn.getresponse()
                body = resp.read()
                return body, time.perf_counter() - t0
            finally:
                conn.close()
                os.environ.pop("KCP_WIRE_SCATTER", None)

        fetch(True)  # warm the encode caches so both arms splice
        sp0 = REGISTRY.counter("wire_spans_written_total").value
        jv0 = REGISTRY.counter("wire_join_avoided_total").value
        b_scatter, t_scatter = fetch(True)
        spans_written = REGISTRY.counter(
            "wire_spans_written_total").value - sp0
        join_avoided = REGISTRY.counter(
            "wire_join_avoided_total").value - jv0
        b_join, t_join = fetch(False)
        wire = {
            "list_bytes": len(b_scatter),
            "identical": hashlib.sha256(b_scatter).hexdigest()
            == hashlib.sha256(b_join).hexdigest(),
            "scatter_ms": round(t_scatter * 1e3, 2),
            "join_ms": round(t_join * 1e3, 2),
            "spans_written": int(spans_written),
            "join_avoided_bytes": int(join_avoided),
        }
        wc.close()

    # ---- phase 3: mid-bench ring change under an injected router fault
    drill: dict = {}
    with tempfile.TemporaryDirectory(prefix="kcp-smart-") as tmp:
        with shard_fleet(2, durable=True, root_dir=str(tmp)) as (
                router, shards, ring):
            dcl = ["da", "db"]
            victim = ring.owner_index(dcl[0])
            acked: set[tuple[str, str]] = set()
            errors_surfaced = 0
            retries = 0
            f0 = REGISTRY.counter("smart_client_fallback_total").value
            r0 = REGISTRY.counter(
                "smart_client_ring_refreshes_total").value
            base = SmartRestClient(router.address, cluster=dcl[0])
            scoped = {c: base.scoped(c) for c in dcl}
            faults.install(faults.FaultInjector(
                "router.proxy:error=0.15", seed=7))
            try:
                moved = False
                for k in range(80):
                    if k == 30:
                        # the ring change, mid-workload: drain the
                        # owner of dcl[0], restart on a NEW port,
                        # republish /ring
                        move_shard(shards, victim, router.address)
                        moved = True
                    c = dcl[k % 2]
                    name = f"drill-{k}"
                    deadline = time.time() + 30
                    while True:
                        try:
                            scoped[c].create("configmaps", obj(c, name))
                            acked.add((c, name))
                            break
                        except kerrors.AlreadyExistsError:
                            acked.add((c, name))
                            break
                        except (kerrors.UnavailableError,
                                kerrors.GoneError, ConnectionError,
                                OSError):
                            # the production retry discipline: a move
                            # window answers 503/refused; retry until
                            # the fallback+republish absorbs it
                            retries += 1
                            if time.time() > deadline:
                                errors_surfaced += 1
                                break
                            time.sleep(0.05)
                assert moved
            finally:
                faults.clear()
                base.close()
            # every acked write present through the router (WAL carried
            # the victim's data across the move)
            wc = MultiClusterRestClient(router.address)
            deadline = time.time() + 30
            missing: set = set()
            while True:
                items, _rv = wc.list("configmaps")
                have = {(o["metadata"]["clusterName"],
                         o["metadata"]["name"]) for o in items}
                missing = acked - have
                if not missing or time.time() > deadline:
                    break
                time.sleep(0.2)
            wc.close()
            drill = {
                "acked_writes": len(acked),
                "lost_after_move": len(missing),
                "errors_surfaced": errors_surfaced,
                "retries": retries,
                "fallbacks": int(REGISTRY.counter(
                    "smart_client_fallback_total").value - f0),
                "ring_refreshes": int(REGISTRY.counter(
                    "smart_client_ring_refreshes_total").value - r0),
                "ring_epoch_after": RestClient(
                    router.address)._request("GET", "/ring")["epoch"],
            }

    out = {
        "metric": "smartclient_write_capacity_speedup",
        "value": ab.get("capacity_speedup", 0.0),
        "unit": "x",
        "smartclient_bench": {
            "host_cpus": os.cpu_count(),
            "shards": n_shards,
            "clusters": n_clusters,
            "threads": n_threads,
            "seconds": seconds,
            "ab": ab,
            "wire": wire,
            "ring_change_drill": drill,
        },
    }
    return out


@_lane_servers
def elastic_bench() -> dict:
    """Elastic scale-out A/B (``--elastic``): write capacity on an
    N-shard fleet, then the fleet DOUBLES live — new shards join the
    ring, every moving cluster's WAL streams to its new owner behind a
    fence, ownership flips atomically per cluster — and capacity is
    re-measured on 2N shards. One JSON line; ``value`` is the
    post-scale-out capacity speedup (target >= 1.6x for a doubling:
    migration cannot conjure capacity beyond the hardware, but it must
    deliver most of it).

    Capacity is honest on few-core CI hosts (the --sharded discipline):
    each shard's ring partition is driven DIRECT (smart client, no
    router hop) alone in its own time slice and the rates sum — shards
    share nothing on the direct write path, so the sum is what N hosts
    serve. The during-move lane rides along: writer threads (half
    smart, half routed) run THROUGH both migrations with the production
    retry discipline, and the bench reports their p99, the fence-window
    503s, the migrated record count, and — the point — zero acked
    writes lost across the move."""
    from .client.smart import SmartRestClient
    from .server.rest import MultiClusterRestClient, RestClient
    from .server.server import Config
    from .server.threaded import ServerThread
    from .sharding import migrate
    from .utils import errors as kerrors

    n_before = int(os.environ.get("KCP_BENCH_ELASTIC_SHARDS", "2"))
    n_after = 2 * n_before
    seconds = float(os.environ.get("KCP_BENCH_ELASTIC_SECONDS", "2.0"))
    # 16 clusters: enough keyspace that HRW lands work on EVERY shard of
    # the doubled ring (fewer leaves a shard idle and understates the
    # honest capacity sum)
    n_clusters = int(os.environ.get("KCP_BENCH_ELASTIC_CLUSTERS", "16"))
    n_threads = int(os.environ.get("KCP_BENCH_ELASTIC_THREADS", "2"))
    clusters = [f"t{i}" for i in range(n_clusters)]

    def obj(cluster: str, name: str) -> dict:
        return {"apiVersion": "v1", "kind": "ConfigMap",
                "metadata": {"name": name, "namespace": "default",
                             "clusterName": cluster}, "data": {}}

    def pct(vals: list[float], q: float) -> float:
        if not vals:
            return 0.0
        return round(float(np.percentile(np.asarray(vals), q)) * 1e3, 3)

    threads: list[ServerThread] = []
    try:
        # ---- the starting fleet: n_before in-process shards + router
        names0 = ",".join(f"s{i}" for i in range(n_before))
        for i in range(n_before):
            threads.append(ServerThread(Config(
                durable=False, install_controllers=False, tls=False,
                shard_name=f"s{i}", ring_names=names0,
                ring_epoch=1)).start())
        spec = ",".join(f"s{i}={t.address}"
                        for i, t in enumerate(threads))
        router = ServerThread(Config(role="router", shards=spec,
                                     durable=False, tls=False)).start()
        threads.append(router)
        raddr = router.address

        def slice_capacity(tag: str) -> list[dict]:
            """Per-shard time slices over the router's CURRENT ring:
            each shard's owned clusters driven direct, alone; summing
            the slices is the N-host capacity claim."""
            rc = RestClient(raddr)
            doc = rc._request("GET", "/ring")
            rc.close()
            ring_names = [s["name"] for s in doc["shards"]]
            per = []
            for i, (nm, owned) in enumerate(zip(
                    ring_names, ring_partition(ring_names, clusters))):
                if not owned:
                    continue
                sc = SmartRestClient(raddr, cluster=owned[0])
                scoped = {c: sc.scoped(c) for c in owned}
                for j, c in enumerate(owned):  # warm conns + ring
                    scoped[c].create("configmaps",
                                     obj(c, f"{tag}-warm-{i}-{j}"))
                stop_at = time.perf_counter() + max(
                    0.5, seconds / len(ring_names))
                n = 0
                t0 = time.perf_counter()
                while time.perf_counter() < stop_at:
                    c = owned[n % len(owned)]
                    scoped[c].create("configmaps", obj(c, f"{tag}-{i}-{n}"))
                    n += 1
                wall = time.perf_counter() - t0
                sc.close()
                per.append({"shard": nm, "clusters": len(owned),
                            "per_s": round(n / max(wall, 1e-9))})
            return per

        per_before = slice_capacity("cb")
        cap_before = sum(s["per_s"] for s in per_before)

        # ---- the move: writers run THROUGH the 2N doubling
        mr0 = REGISTRY.counter("migration_records_total").value
        mf0 = REGISTRY.counter("migration_fenced_writes_total").value
        acked: set[tuple[str, str]] = set()
        acked_lock = threading.Lock()
        lats: list[list[float]] = [[] for _ in range(n_threads)]
        retries = [0] * n_threads
        surfaced = [0] * n_threads
        stop = threading.Event()

        def mover_writer(k: int) -> None:
            # half smart (direct + fallback), half routed: both client
            # shapes must survive the move with plain retry discipline
            cls = SmartRestClient if k % 2 == 0 else RestClient
            base = cls(raddr, cluster=clusters[0])
            scoped = {c: base.scoped(c) for c in clusters}
            n = 0
            while not stop.is_set():
                c = clusters[n % len(clusters)]
                name = f"mv-{k}-{n}"
                t0 = time.perf_counter()
                deadline = t0 + 30.0
                while True:
                    try:
                        scoped[c].create("configmaps", obj(c, name))
                        with acked_lock:
                            acked.add((c, name))
                        break
                    except kerrors.AlreadyExistsError:
                        with acked_lock:
                            acked.add((c, name))
                        break
                    except (kerrors.UnavailableError, kerrors.GoneError,
                            ConnectionError, OSError):
                        # fence-window 503s and flip-window 410s are the
                        # mechanism, not failures; retry until the ring
                        # settles (a stuck client would surface below)
                        retries[k] += 1
                        if time.perf_counter() > deadline:
                            surfaced[k] += 1
                            break
                        time.sleep(0.02)
                lats[k].append(time.perf_counter() - t0)
                n += 1
                time.sleep(0.005)
            base.close()

        writers = [threading.Thread(target=mover_writer, args=(k,),
                                    daemon=True) for k in range(n_threads)]
        for t in writers:
            t.start()
        time.sleep(0.3)
        t_move0 = time.perf_counter()
        migrated = []
        for i in range(n_before, n_after):
            grown = ",".join(f"s{j}" for j in range(i + 1))
            shard = ServerThread(Config(
                durable=False, install_controllers=False, tls=False,
                shard_name=f"s{i}", ring_names=grown,
                ring_epoch=1)).start()
            threads.append(shard)
            migrated.append(migrate.scale_out(
                raddr, f"s{i}={shard.address}"))
        t_move = time.perf_counter() - t_move0
        time.sleep(0.3)
        stop.set()
        for t in writers:
            t.join()

        # zero lost acked writes: every ack readable through the router
        wc = MultiClusterRestClient(raddr)
        items, _rv = wc.list("configmaps")
        have = {(o["metadata"].get("clusterName", ""),
                 o["metadata"]["name"]) for o in items}
        rc = RestClient(raddr)
        epoch_after = rc._request("GET", "/ring")["epoch"]
        rc.close()
        wc.close()
        missing = acked - have
        move_lat = [x for la in lats for x in la]

        per_after = slice_capacity("ca")
        cap_after = sum(s["per_s"] for s in per_after)
        speedup = round(cap_after / max(cap_before, 1e-9), 2)
    finally:
        for t in reversed(threads):
            t.stop()

    out = {
        "metric": "elastic_scaleout_capacity_speedup",
        "value": speedup,
        "unit": "x",
        "elastic_bench": {
            "host_cpus": os.cpu_count(),
            "shards_before": n_before,
            "shards_after": n_after,
            "clusters": n_clusters,
            "seconds": seconds,
            "capacity_before_per_s": cap_before,
            "capacity_after_per_s": cap_after,
            "per_shard_before": per_before,
            "per_shard_after": per_after,
            "during_move": {
                "move_seconds": round(t_move, 3),
                "acked_writes": len(acked),
                "lost_after_move": len(missing),
                "errors_surfaced": sum(surfaced),
                "retries": sum(retries),
                "write_p50_ms": pct(move_lat, 50),
                "write_p99_ms": pct(move_lat, 99),
                "migrated_clusters": sum(
                    len(m["migrated"]) for m in migrated),
                "migration_records": int(REGISTRY.counter(
                    "migration_records_total").value - mr0),
                "fenced_write_503s": int(REGISTRY.counter(
                    "migration_fenced_writes_total").value - mf0),
                "ring_epoch_after": epoch_after,
            },
        },
    }
    return out


# --------------------------------------------------------------------------
# --store, --encode, --admission: the store, the encode cache and the admission
# chain in one process (no device)


def store_bench() -> dict:
    """BASELINE configs[4] host-side scenario: 100k-object list + watch
    fan-out against C selector-bound watches, A/B across the indexed
    (KCP_STORE_INDEX=1, CoW + batched fan-out) and legacy (linear scan +
    per-event deepcopy) store read paths. Pure host — no device, no
    orchestrator; one JSON line with the combined speedup as the value.
    """
    from .store.selectors import parse_selector
    from .store.store import LogicalStore

    n_objects = int(os.environ.get("KCP_BENCH_STORE_OBJECTS", "100000"))
    n_watches = int(os.environ.get("KCP_BENCH_STORE_WATCHES", "64"))
    n_lists = int(os.environ.get("KCP_BENCH_STORE_LISTS", "3"))
    n_muts = int(os.environ.get("KCP_BENCH_STORE_MUTS", "2000"))
    teams = [f"t{i}" for i in range(n_watches)]
    clusters = [f"c{i}" for i in range(16)]
    namespaces = [f"ns{i}" for i in range(8)]

    def run(indexed: bool) -> dict:
        s = LogicalStore(indexed=indexed)
        rng = np.random.default_rng(11)
        for i in range(n_objects):
            s.create("configmaps", clusters[i % 16], {
                "apiVersion": "v1", "kind": "ConfigMap",
                "metadata": {"name": f"cm-{i}",
                             "namespace": namespaces[i % 8],
                             "labels": {"team": teams[i % n_watches],
                                        "tier": str(i % 7)}},
                "data": {"v": str(i)},
            })
        watches = [s.watch("configmaps", selector=parse_selector(f"team={t}"))
                   for t in teams]

        t0 = time.perf_counter()
        for _ in range(n_lists):
            items, _rv = s.list("configmaps")
            assert len(items) == n_objects
            items, _rv = s.list("configmaps", clusters[0], namespaces[0])
        t_list = time.perf_counter() - t0

        events = 0
        t0 = time.perf_counter()
        for m in range(n_muts):
            i = int(rng.integers(n_objects))
            # every 8th mutation flips the team label — the selector-bound
            # ADDED/DELETED rewrite path, not just the match
            team = teams[(i + m) % n_watches] if m % 8 == 0 else teams[i % n_watches]
            s.update("configmaps", clusters[i % 16], {
                "apiVersion": "v1", "kind": "ConfigMap",
                "metadata": {"name": f"cm-{i}",
                             "namespace": namespaces[i % 8],
                             "labels": {"team": team, "tier": str(i % 7)}},
                "data": {"v": f"m{m}"},
            })
            if m % 128 == 127:
                events += sum(len(w.drain()) for w in watches)
        events += sum(len(w.drain()) for w in watches)
        t_fanout = time.perf_counter() - t0
        s.close()
        return {"list_s": round(t_list, 4), "fanout_s": round(t_fanout, 4),
                "events": events}

    legacy = run(False)
    indexed = run(True)
    combined = (legacy["list_s"] + legacy["fanout_s"]) / max(
        indexed["list_s"] + indexed["fanout_s"], 1e-9)
    out = {
        "metric": "store_read_path_speedup",
        "value": round(combined, 2),
        "unit": "x",
        "store_bench": {
            "objects": n_objects, "watches": n_watches,
            "lists": n_lists, "mutations": n_muts,
            "list_speedup": round(legacy["list_s"] / max(indexed["list_s"], 1e-9), 2),
            "fanout_speedup": round(legacy["fanout_s"] / max(indexed["fanout_s"], 1e-9), 2),
            "events_equal": legacy["events"] == indexed["events"],
            "indexed": indexed, "legacy": legacy,
        },
    }
    return out


def encode_bench() -> dict:
    """Encode-once serving A/B (``--encode``): list-encode and
    watch-fan-out-encode through the real RestHandler at the BASELINE
    fan-out shape (100k objects x 64 watchers by default), with the
    store's serialization cache on vs off (``KCP_ENCODE_CACHE=1`` vs
    ``=0`` equivalent, toggled per-store in-process). Pure host, no
    sockets: watch producers stream into capture sinks that perform
    exactly the encoding ``httpd.StreamResponse`` would, so the measured
    delta is the serialization work itself. The runs also cross-check
    that cached and uncached serving produce byte-identical wires.
    """
    from .apis.scheme import default_scheme
    from .server.handler import RestHandler
    from .server.httpd import Request
    from .store.store import LogicalStore

    n_objects = int(os.environ.get("KCP_BENCH_ENCODE_OBJECTS", "100000"))
    n_watchers = int(os.environ.get("KCP_BENCH_ENCODE_WATCHES", "64"))
    n_lists = int(os.environ.get("KCP_BENCH_ENCODE_LISTS", "3"))
    n_muts = int(os.environ.get("KCP_BENCH_ENCODE_MUTS", "500"))

    class _CaptureStream:
        """StreamResponse's encode surface without a socket: the json
        sends re-serialize exactly like httpd.StreamResponse (that cost
        is what the uncached arm measures), the raw send takes the
        relay's pre-encoded lines. Wire bytes are kept and digested
        *after* the timed window so hashing never dilutes the A/B."""

        def __init__(self):
            self.chunks: list[bytes] = []
            self.events = 0
            self.encode_s = 0.0  # time spent serializing (json arms)

        async def send_json(self, obj):
            t0 = time.perf_counter()
            data = json.dumps(obj).encode() + b"\n"
            self.encode_s += time.perf_counter() - t0
            self.chunks.append(data)
            self.events += 1

        async def send_json_many(self, objs):
            if not objs:
                return
            t0 = time.perf_counter()
            data = b"".join(json.dumps(o).encode() + b"\n" for o in objs)
            self.encode_s += time.perf_counter() - t0
            self.chunks.append(data)
            self.events += len(objs)

        async def send_raw_many(self, lines):
            if not lines:
                return
            self.chunks.append(b"".join(lines))
            self.events += len(lines)

    def _cm(i: int, v: str) -> dict:
        # a realistically-sized ConfigMap (~0.5 KiB encoded): listed
        # k8s objects carry annotations and multi-key payloads, and the
        # serialization cost the cache removes scales with that
        return {
            "apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": f"cm-{i}", "namespace": f"ns{i % 8}",
                         "uid": f"uid-{i}",  # fixed: runs must be byte-equal
                         "labels": {"team": f"t{i % 64}", "tier": str(i % 7)},
                         "annotations": {
                             "kcp.dev/owned-by": f"workspace-{i % 128}",
                             "kubectl.kubernetes.io/last-applied-configuration":
                                 f"cm-{i}/rev-{v}",
                             "config.example.dev/checksum": f"{i:08x}{i:08x}",
                         }},
            "data": {"server.yaml": f"replicas: {i % 9}\nshard: {i % 64}\n",
                     "feature-flags": f"a={i % 2},b={i % 3},c={i % 5}",
                     "rev": v},
        }

    async def run(cache_on: bool) -> dict:
        hist = REGISTRY.histogram("response_encode_seconds")
        store = LogicalStore(indexed=True, encode_cache=cache_on,
                             clock=lambda: 1_700_000_000.0)
        handler = RestHandler(store, default_scheme(), admission=None)
        for i in range(n_objects):
            store.create("configmaps", f"c{i % 16}", _cm(i, str(i)))

        digest = hashlib.sha256()
        lreq = Request("GET", "/clusters/*/api/v1/configmaps", {}, {}, b"")
        # cold pass populates the byte cache (all misses); timed apart so
        # the steady-state number is the warm cache the fleet serves from
        t0 = time.perf_counter()
        resp = await handler(lreq)
        cold_list_s = time.perf_counter() - t0
        digest.update(resp.body)
        bodies = []
        enc0 = hist.total
        t0 = time.perf_counter()
        for _ in range(n_lists):
            resp = await handler(lreq)
            bodies.append(resp.body)
        t_list = time.perf_counter() - t0
        # serialization seconds alone (the handler meters both the splice
        # and the dict-dump list paths into response_encode_seconds)
        list_encode_s = hist.total - enc0
        for body in bodies:
            digest.update(body)
        bodies = []
        # churned lists: a mutation between lists moves the store RV, so
        # the RV-keyed body cache misses and the byte-splice over the
        # (warm) per-record cache is what gets measured
        enc0 = hist.total
        t0 = time.perf_counter()
        for j in range(n_lists):
            store.update("configmaps", "c0", _cm(0, f"l{j}"))
            resp = await handler(lreq)
            bodies.append(resp.body)
        t_churn = time.perf_counter() - t0
        churn_encode_s = hist.total - enc0
        for body in bodies:
            digest.update(body)
        del bodies

        wreq = Request("GET", "/clusters/*/api/v1/configmaps",
                       {"watch": ["true"]}, {}, b"")
        sinks, tasks = [], []
        for _ in range(n_watchers):
            stream = await handler(wreq)
            sink = _CaptureStream()
            sinks.append(sink)
            tasks.append(asyncio.ensure_future(stream.producer(sink)))
        await asyncio.sleep(0.01)  # let every producer subscribe

        enc0 = hist.total
        t0 = time.perf_counter()
        for m in range(n_muts):
            i = m % n_objects
            store.update("configmaps", f"c{i % 16}", _cm(i, f"m{m}"))
            if m % 64 == 63:
                await asyncio.sleep(0)  # let the relays drain the burst
        deadline = time.monotonic() + 120
        while (min(s.events for s in sinks) < n_muts
               and time.monotonic() < deadline):
            await asyncio.sleep(0)
        t_fanout = time.perf_counter() - t0
        # serialization seconds alone: the raw relay meters its line
        # encodes into response_encode_seconds, the json arms meter their
        # dumps in the sink — exactly one term is nonzero per arm
        fanout_encode_s = (hist.total - enc0
                           + sum(s.encode_s for s in sinks))
        store.close()
        await asyncio.gather(*tasks, return_exceptions=True)
        handler.close()
        for s in sinks:
            for chunk in s.chunks:
                digest.update(chunk)
        return {"cold_list_s": round(cold_list_s, 4),
                "list_s": round(t_list, 4),
                "churn_list_s": round(t_churn, 4),
                "fanout_s": round(t_fanout, 4),
                "list_encode_s": round(list_encode_s, 4),
                "churn_encode_s": round(churn_encode_s, 4),
                "fanout_encode_s": round(fanout_encode_s, 4),
                "events": sum(s.events for s in sinks),
                "sha256": digest.hexdigest()}

    cached = asyncio.run(run(True))
    legacy = asyncio.run(run(False))
    combined = (
        legacy["list_s"] + legacy["churn_list_s"] + legacy["fanout_s"]
    ) / max(
        cached["list_s"] + cached["churn_list_s"] + cached["fanout_s"], 1e-9)
    out = {
        "metric": "encode_once_speedup",
        "value": round(combined, 2),
        "unit": "x",
        "encode_bench": {
            "objects": n_objects, "watchers": n_watchers,
            "lists": n_lists, "mutations": n_muts,
            "list_speedup": round(
                legacy["list_s"] / max(cached["list_s"], 1e-9), 2),
            "churn_list_speedup": round(
                legacy["churn_list_s"] / max(cached["churn_list_s"], 1e-9), 2),
            "fanout_speedup": round(
                legacy["fanout_s"] / max(cached["fanout_s"], 1e-9), 2),
            "list_encode_speedup": round(
                legacy["list_encode_s"] / max(cached["list_encode_s"], 1e-9), 2),
            "churn_encode_speedup": round(
                legacy["churn_encode_s"]
                / max(cached["churn_encode_s"], 1e-9), 2),
            "fanout_encode_speedup": round(
                legacy["fanout_encode_s"]
                / max(cached["fanout_encode_s"], 1e-9), 2),
            "events_equal": legacy["events"] == cached["events"],
            "bytes_equal": legacy["sha256"] == cached["sha256"],
            "cached": cached, "legacy": legacy,
        },
    }
    return out


def admission_bench() -> dict:
    """Admission & flow control A/B (``--admission``): happy-path write
    overhead with the chain enabled (quota + flow on, no contention),
    plus the noisy-neighbor storm — 1 tenant flooding writes at 10x its
    token rate alongside quiet tenants. Pure host — no device, no
    orchestrator; one JSON line whose value is the happy-path overhead
    in percent.

    Two overhead measurements ride along:
    - ``overhead_pct`` (the headline): over the full serving path —
      real HTTP server, real client, keep-alive — chain on vs off;
    - ``direct_overhead_pct``: handler-dispatch only (no sockets), the
      strictest view of what the chain itself costs per write.
    """
    from .admission import FlowController, build_chain
    from .apis.scheme import default_scheme
    from .server.handler import RestHandler
    from .server.httpd import Request
    from .store.store import LogicalStore

    writes = int(os.environ.get("KCP_BENCH_ADM_WRITES", "4000"))
    tenants = int(os.environ.get("KCP_BENCH_ADM_TENANTS", "100"))
    storm_s = float(os.environ.get("KCP_BENCH_ADM_STORM_S", "2.5"))
    flow_rate = float(os.environ.get("KCP_BENCH_ADM_RATE", "40"))
    flood_x = 10  # the storm tenant's send rate vs its token rate
    scheme = default_scheme()

    def cm_body(name: str) -> bytes:
        return json.dumps({
            "apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": name, "namespace": "default"},
            "data": {"v": name},
        }).encode()

    def path(cluster: str) -> str:
        return f"/clusters/{cluster}/api/v1/namespaces/default/configmaps"

    # ---- direct-dispatch A/B: the chain's own cost per write
    def fresh_handler(admission_on: bool):
        store = LogicalStore(indexed=True)
        chain = None
        if admission_on:
            chain = build_chain(store, flow=FlowController(
                concurrency=64, rate=1e9, burst=1e9))
        return RestHandler(store, scheme, admission=chain)

    async def run_direct_ab() -> dict[bool, float]:
        """Alternating small segments against two live handlers; best
        segment rate per mode. Heap/GC drift lands on both modes instead
        of whichever ran second (a fresh-process A/B here shows +-15us
        run-to-run noise — 3x the true chain cost)."""
        import gc

        handlers = {on: fresh_handler(on) for on in (False, True)}
        seg_n = max(128, writes // 8)
        counters = {False: 0, True: 0}
        best = {False: 0.0, True: 0.0}

        async def burst(on: bool) -> None:
            handler = handlers[on]
            k0 = counters[on]
            counters[on] = k0 + seg_n
            reqs = [Request("POST", path(f"t{(k0 + i) % tenants}"), {}, {},
                            cm_body(f"d{int(on)}-{k0 + i}"))
                    for i in range(seg_n)]
            gc.collect()
            t0 = time.perf_counter()
            for r in reqs:
                resp = await handler(r)
                assert resp.status == 201, resp.body
            best[on] = max(best[on], seg_n / (time.perf_counter() - t0))

        for on in (False, True):  # warmup segment, untimed
            await burst(on)
            best[on] = 0.0
        for _seg in range(8):
            await burst(bool(_seg % 2))
        return best

    direct = asyncio.run(run_direct_ab())
    direct_overhead = (direct[False] / direct[True] - 1.0) * 100.0

    # ---- serving-path A/B: chain on/off over real HTTP (the overhead a
    # client actually observes; TLS off so the delta is the chain, not
    # handshake noise). Both servers run CONCURRENTLY and the timed
    # segments alternate between them, so host-wide drift (GC, noisy CI
    # neighbors) hits both modes symmetrically instead of whichever mode
    # ran second.
    def run_http_ab() -> dict:
        from .server import Config, RestClient
        from .server.threaded import ServerThread

        # ONE server, one client, one kept-alive connection; the A/B
        # toggles the handler's admission chain between alternating
        # segments (an attribute swap, done on the serving loop). Two
        # separate server processes showed whole-percentage systematic
        # bias from thread/core/allocator luck — with a single serving
        # stack the only difference between segments IS the chain.
        # Happy path means NO throttling: budgets are out of reach, so
        # one client hammering one flow measures the chain, not a 429.
        prev = {k: os.environ.get(k)
                for k in ("KCP_ADMISSION", "KCP_FLOW_RATE", "KCP_FLOW_BURST")}
        os.environ["KCP_ADMISSION"] = "1"
        os.environ["KCP_FLOW_RATE"] = "1000000000"
        os.environ["KCP_FLOW_BURST"] = "1000000000"
        # many SHORT alternating segments: host drift over the ~seconds
        # of measurement (thermal, background load) changes slowly, so
        # toggling modes every few tens of ms makes each mode sample the
        # same drift profile
        segments = 40
        seg_n = max(48, writes // 20)
        lat: dict[bool, list[float]] = {False: [], True: []}
        rates: dict[bool, float] = {False: 0.0, True: 0.0}
        try:
            with ServerThread(Config(durable=False,
                                     install_controllers=False,
                                     tls=False)) as st:
                handler = st.server.handler
                chain = handler.admission
                assert chain is not None
                c = RestClient(st.server.address, cluster="bench")
                for i in range(64):  # warm connection + discovery
                    c.create("configmaps", json.loads(
                        cm_body(f"warm-{i}")), "default")
                for seg in range(segments):
                    on = bool(seg % 2)
                    # swap on the serving loop so no request observes a
                    # half-written handler
                    st.call(setattr, handler, "admission",
                            chain if on else None)
                    samples = lat[on]
                    t0 = time.perf_counter()
                    for i in range(seg_n):
                        body = json.loads(cm_body(f"h{seg}-{i}"))
                        ts = time.perf_counter()
                        c.create("configmaps", body, "default")
                        samples.append(time.perf_counter() - ts)
                    rates[on] = max(rates[on],
                                    seg_n / (time.perf_counter() - t0))
                c.close()
        finally:
            for k, v in prev.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        # MEDIAN per-request latency, not best throughput: robust to the
        # stragglers (GC pauses, scheduler hiccups) that make a rate
        # ratio of two short runs swing by whole percentage points
        med = {on: float(np.median(np.asarray(lat[on]))) for on in lat}
        return {
            "overhead_pct": (med[True] / med[False] - 1.0) * 100.0,
            "med_off_us": med[False] * 1e6,
            "med_on_us": med[True] * 1e6,
            "rates": rates,
        }

    http_ab = run_http_ab()
    http_rates = http_ab["rates"]
    overhead = http_ab["overhead_pct"]

    # ---- noisy-neighbor storm: 1 flooding tenant vs quiet tenants
    async def run_phase(flood: bool, quiet_rps: float) -> dict:
        store = LogicalStore(indexed=True)
        chain = build_chain(store, flow=FlowController(
            concurrency=16, rate=flow_rate, burst=2 * flow_rate,
            queues=16, queue_depth=32, seed=1))
        handler = RestHandler(store, scheme, admission=chain)
        quiet_lat: list[float] = []
        counters = {"quiet_ok": 0, "quiet_rejected": 0, "flood_ok": 0,
                    "flood_429": 0, "flood_other": 0, "retry_after": 0}

        async def tenant(cluster: str, rps: float, is_flood: bool) -> None:
            loop = asyncio.get_running_loop()
            t0 = loop.time()
            k = 0
            while True:
                target = t0 + k / rps
                if target - t0 >= storm_s:
                    return
                now = loop.time()
                if target > now:
                    await asyncio.sleep(target - now)
                body = cm_body(f"{cluster}-{'f' if is_flood else 'q'}-{k}")
                ts = loop.time()
                resp = await handler(
                    Request("POST", path(cluster), {}, {}, body))
                dt = loop.time() - ts
                if is_flood:
                    if resp.status == 201:
                        counters["flood_ok"] += 1
                    elif resp.status == 429:
                        counters["flood_429"] += 1
                        if resp.headers.get("Retry-After"):
                            counters["retry_after"] += 1
                    else:
                        counters["flood_other"] += 1
                else:
                    quiet_lat.append(dt)
                    if resp.status == 201:
                        counters["quiet_ok"] += 1
                    else:
                        counters["quiet_rejected"] += 1
                k += 1

        tasks = [tenant(f"q{i}", quiet_rps, False)
                 for i in range(tenants - 1)]
        if flood:
            tasks.append(tenant("storm", flood_x * flow_rate, True))
        await asyncio.gather(*tasks)
        lat = np.asarray(quiet_lat)
        return {
            "quiet_p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 3),
            "quiet_p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 3),
            **counters,
        }

    quiet_rps = max(1.0, flow_rate / 8)
    baseline = asyncio.run(run_phase(flood=False, quiet_rps=quiet_rps))
    storm = asyncio.run(run_phase(flood=True, quiet_rps=quiet_rps))
    # ratio floor 0.5ms: sub-millisecond baselines would turn scheduler
    # jitter into the headline; queueing-induced starvation is >> 1ms
    p99_ratio = storm["quiet_p99_ms"] / max(baseline["quiet_p99_ms"], 0.5)
    flood_total = storm["flood_ok"] + storm["flood_429"] + storm["flood_other"]

    out = {
        "metric": "admission_overhead_pct",
        "value": round(overhead, 2),
        "unit": "%",
        "admission_bench": {
            "happy": {
                "writes": writes,
                "http_off_per_s": round(http_rates[False]),
                "http_on_per_s": round(http_rates[True]),
                "http_med_off_us": round(http_ab["med_off_us"], 1),
                "http_med_on_us": round(http_ab["med_on_us"], 1),
                "overhead_pct": round(overhead, 2),
                "direct_off_per_s": round(direct[False]),
                "direct_on_per_s": round(direct[True]),
                "direct_overhead_pct": round(direct_overhead, 2),
            },
            "storm": {
                "tenants": tenants,
                "flow_rate_per_s": flow_rate,
                "flood_x": flood_x,
                "storm_s": storm_s,
                "baseline_quiet_p99_ms": baseline["quiet_p99_ms"],
                "storm_quiet_p99_ms": storm["quiet_p99_ms"],
                "quiet_p99_ratio": round(p99_ratio, 3),
                "quiet_ok": storm["quiet_ok"],
                "quiet_rejected": storm["quiet_rejected"],
                "flood_ok": storm["flood_ok"],
                "flood_429": storm["flood_429"],
                "flood_sent": flood_total,
                "flood_retry_after_seen": storm["retry_after"] > 0,
            },
        },
    }
    return out


# --------------------------------------------------------------------------
# --replica, --consistent, --writes: replication and the write path, every
# server a ServerThread of this process (no controllers, no device)


def _lane_cm(name: str, cluster: str, data: str = "") -> dict:
    """The replication and write-path lanes' ConfigMap, its logical
    cluster named in the body."""
    return {"apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": name, "namespace": "default",
                         "clusterName": cluster}, "data": {"v": data}}


def _repl_status(address: str) -> dict:
    from .server.rest import RestClient

    c = RestClient(address)
    try:
        return c._request("GET", "/replication/status")
    finally:
        c.close()


def _wait_applied(address: str, rv: int, timeout: float = 60.0) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if _repl_status(address)["applied_rv"] >= rv:
            return
        time.sleep(0.02)
    raise RuntimeError(f"replica {address} never reached rv {rv}")


def _read_rate(address: str, target: str, secs: float,
               headers: dict | None = None) -> float:
    """GETs of ``target`` a second on one kept-alive connection, for
    ``secs`` after a warm-up request."""
    from .server.rest import RestClient

    c = RestClient(address)
    try:
        c.request_raw("GET", target, headers=headers)  # warm connection + caches
        n = 0
        t0 = time.perf_counter()
        stop = t0 + secs
        while time.perf_counter() < stop:
            s, _h, _b = c.request_raw("GET", target, headers=headers)
            assert s == 200, s
            n += 1
        return n / (time.perf_counter() - t0)
    finally:
        c.close()


def replica_bench() -> dict:
    """HA replication A/B (``--replica``): read capacity at 0/1/2 read
    replicas, replica visibility lag, byte-equality at the same RV, and
    the kill-the-primary drill. One JSON line; ``value`` is the fleet
    read-capacity speedup at the largest replica count vs the bare
    primary.

    Like the sharded lane, capacity is honest on few-core CI hosts:
    each serving endpoint (primary + each replica) is measured in its
    own time slice under the same fixed list query, and fleet capacity
    is the sum — replicas share nothing on the read path (each serves
    from its own store + encode cache), so the sum is what N hosts
    would serve. Lag is measured as write-to-replica-visibility: after
    each primary write, the time until the replica's applied RV covers
    it (p50/p99 ms). The kill drill runs durable primary+standby,
    SIGKILL-equivalent death mid-workload, and reports promotion
    latency (kill -> first successful standby write) and acked-write
    loss (floor: zero).
    """
    import tempfile

    from .server.rest import MultiClusterRestClient, RestClient
    from .server.server import Config
    from .server.threaded import ServerThread
    from .utils import errors as kerrors

    objects = int(os.environ.get("KCP_BENCH_REPL_OBJECTS", "2000"))
    seconds = float(os.environ.get("KCP_BENCH_REPL_SECONDS", "1.0"))
    counts = sorted(int(x) for x in os.environ.get(
        "KCP_BENCH_REPL_COUNTS", "0,1,2").split(",") if x.strip())
    lag_writes = int(os.environ.get("KCP_BENCH_REPL_LAG_WRITES", "200"))
    drill_writes = int(os.environ.get("KCP_BENCH_REPL_DRILL_WRITES", "80"))
    clusters = [f"t{i}" for i in range(8)]

    primary = ServerThread(Config(durable=False, install_controllers=False,
                                  tls=False)).start()
    replicas: list[ServerThread] = []
    results: dict = {"host_cpus": os.cpu_count(), "objects": objects,
                     "seconds": seconds}
    capacities: dict[str, float] = {}
    bytes_equal = True
    try:
        pc = MultiClusterRestClient(primary.address)
        for i in range(objects):
            pc.create("configmaps", _lane_cm(f"seed{i}", clusters[i % 8], str(i)))
        seed_rv = _repl_status(primary.address)["applied_rv"]
        target = "/clusters/t0/api/v1/namespaces/default/configmaps"
        per_slice = max(0.25, seconds / (max(counts) + 1))
        for n in counts:
            while len(replicas) < n:
                replicas.append(ServerThread(Config(
                    durable=False, install_controllers=False, tls=False,
                    role="replica", primary=primary.address)).start())
                _wait_applied(replicas[-1].address, seed_rv)
            endpoints = [primary.address] + [r.address for r in replicas[:n]]
            capacities[str(n)] = round(sum(
                _read_rate(a, target, per_slice) for a in endpoints), 1)
        base = capacities.get("0") or 1.0
        speedup = {k: round(v / base, 2) for k, v in capacities.items()}

        # byte equality at the same RV (encode-once path on both sides)
        c0 = RestClient(primary.address)
        _s, _h, pb = c0.request_raw("GET", target)
        c0.close()
        for r in replicas:
            cr = RestClient(r.address)
            _s, _h, rb = cr.request_raw("GET", target)
            cr.close()
            if rb != pb:
                bytes_equal = False

        # replica visibility lag (1 replica attached is the common case)
        lags_ms: list[float] = []
        if replicas:
            rep = replicas[0]
            rc = RestClient(rep.address)
            for i in range(lag_writes):
                out = pc.create("configmaps", _lane_cm(f"lag{i}", "t1", str(i)))
                rv = int(out["metadata"]["resourceVersion"])
                t0 = time.perf_counter()
                while True:
                    st = rc._request("GET", "/replication/status")
                    if st["applied_rv"] >= rv:
                        break
                    time.sleep(0.0005)
                lags_ms.append((time.perf_counter() - t0) * 1e3)
            rc.close()
        pc.close()
    finally:
        for r in replicas:
            r.stop()
        primary.stop()

    lag_stats = {}
    if lags_ms:
        lag_stats = {"p50_ms": round(float(np.percentile(lags_ms, 50)), 3),
                     "p99_ms": round(float(np.percentile(lags_ms, 99)), 3),
                     "writes": len(lags_ms)}

    # ---- kill-the-primary drill (durable pair, real WAL on disk) ----
    drill: dict = {}
    with tempfile.TemporaryDirectory() as td:
        p = ServerThread(Config(durable=True, install_controllers=False,
                                tls=False,
                                root_dir=os.path.join(td, "p"))).start()
        s = ServerThread(Config(durable=True, install_controllers=False,
                                tls=False, role="standby",
                                primary=p.address, repl_hysteresis_s=0.4,
                                root_dir=os.path.join(td, "s"))).start()
        try:
            deadline = time.time() + 10
            while time.time() < deadline:
                if p.call(lambda: p.server.repl_hub.has_sync_subscribers):
                    break
                time.sleep(0.05)
            pc = MultiClusterRestClient(p.address)
            sc = MultiClusterRestClient(s.address)
            acked: list[str] = []
            killed_at = None
            promoted_at = None
            kill_at = drill_writes // 2
            for i in range(drill_writes):
                name = f"d{i}"
                if i == kill_at:
                    killed_at = time.perf_counter()
                    p.kill()
                stop = time.time() + 30
                while True:
                    client = pc if killed_at is None else sc
                    try:
                        client.create("configmaps", _lane_cm(name, "t1", str(i)))
                        acked.append(name)
                        if killed_at is not None and promoted_at is None:
                            promoted_at = time.perf_counter()
                        break
                    except Exception as e:
                        if isinstance(e, kerrors.AlreadyExistsError):
                            acked.append(name)
                            break
                        if time.time() > stop:
                            raise
                        time.sleep(0.02)
            items, _rv = sc.list("configmaps", namespace="default")
            names = {o["metadata"]["name"] for o in items}
            st = _repl_status(s.address)
            drill = {
                "acked_writes": len(acked),
                "lost_after_promotion": len(
                    [n for n in acked if n not in names]),
                "promote_ms": round((promoted_at - killed_at) * 1e3, 1)
                if promoted_at else None,
                "promoted_role": st["role"],
                "epoch": st["epoch"],
            }
            pc.close()
            sc.close()
        finally:
            s.stop()
            p.stop()

    top = str(max(counts))
    out = {
        "metric": "replica_read_capacity_speedup",
        "value": speedup.get(top, 1.0),
        "unit": "x",
        "stage": "replica-bench",
        "replica_bench": {
            **results,
            "read_capacity_rps": capacities,
            "capacity_speedup": speedup,
            "bytes_equal": bytes_equal,
            "lag": lag_stats,
            "kill": drill,
        },
    }
    return out


def consistent_bench() -> dict:
    """Consistent-read A/B (``--consistent``, the ``--replica`` lane's
    KEP-2340 growth): read capacity when every read must be *consistent*
    (no staler than the issuing session's own writes), primary-pinned vs
    RV-barrier reads spread over the replicas at matched freshness. One
    JSON line; ``value`` is the consistent-read capacity speedup at 2
    replicas vs the primary-only pin.

    Riders: (1) wait-for-frontier latency — under an active
    ``repl.ship`` delay, write on the primary then immediately read the
    replica pinned to the write's RV; p50/p99 of the observed barrier
    park (the consistent read's freshness cost, vs the replica lane's
    raw visibility lag). (2) session read-your-writes through the
    router — every read of the session's own write must come back fresh
    (zero stale), with a replica-local share high enough to prove the
    barrier parks instead of falling back. (3) byte equality — the
    replica's consistent list bytes sha256-equal the primary's at the
    same RV (encode-once on both sides)."""
    from .server.rest import MultiClusterRestClient, RestClient
    from .server.server import Config
    from .server.threaded import ServerThread

    objects = int(os.environ.get("KCP_BENCH_CONS_OBJECTS", "2000"))
    seconds = float(os.environ.get("KCP_BENCH_CONS_SECONDS", "1.0"))
    n_replicas = int(os.environ.get("KCP_BENCH_CONS_REPLICAS", "2"))
    lag_writes = int(os.environ.get("KCP_BENCH_CONS_LAG_WRITES", "120"))
    rywr_steps = int(os.environ.get("KCP_BENCH_CONS_RYWR_STEPS", "120"))
    clusters = [f"t{i}" for i in range(8)]

    primary = ServerThread(Config(durable=False, install_controllers=False,
                                  tls=False)).start()
    replicas = [ServerThread(Config(
        durable=False, install_controllers=False, tls=False,
        role="replica", primary=primary.address)).start()
        for _ in range(n_replicas)]
    router = ServerThread(Config(
        role="router", durable=False, tls=False,
        shards="s0=" + "|".join(
            [primary.address] + [r.address for r in replicas]))).start()
    out: dict = {}
    try:
        pc = MultiClusterRestClient(primary.address)
        for i in range(objects):
            pc.create("configmaps", _lane_cm(f"seed{i}", clusters[i % 8], str(i)))
        seed_rv = int(_repl_status(primary.address)["applied_rv"])
        for r in replicas:
            _wait_applied(r.address, seed_rv)
        target = "/clusters/t0/api/v1/namespaces/default/configmaps"
        pin = {"X-Kcp-Min-Rv": str(seed_rv)}

        # --- capacity A/B at matched freshness (every read carries the
        # session pin; the primary IS the frontier, replicas barrier) ---
        per_slice = max(0.25, seconds / (n_replicas + 1))
        primary_pinned = _read_rate(primary.address, target, per_slice,
                                   headers=pin)
        spread = primary_pinned + sum(
            _read_rate(r.address, target, per_slice, headers=pin)
            for r in replicas)
        speedup = round(spread / max(primary_pinned, 1e-9), 2)

        # --- byte equality at the same RV (sha256 rider) ---
        c0 = RestClient(primary.address)
        _s, _h, pb = c0.request_raw("GET", target)
        c0.close()
        digest = hashlib.sha256(pb).hexdigest()
        bytes_equal = True
        for r in replicas:
            _s, rb = 0, b""
            cr = RestClient(r.address)
            _s, _h, rb = cr.request_raw("GET", target, headers=pin)
            cr.close()
            if hashlib.sha256(rb).hexdigest() != digest:
                bytes_equal = False

        # --- wait-for-frontier latency under a real ship delay ---
        faults.install(faults.FaultInjector("repl.ship:latency=5ms",
                                            seed=20260807))
        rep = replicas[0]
        waits_ms: list[float] = []
        rc = RestClient(rep.address)
        one = "/clusters/t1/api/v1/namespaces/default/configmaps"
        for i in range(lag_writes):
            w = pc.create("configmaps", _lane_cm(f"lag{i}", "t1", str(i)))
            rv = w["metadata"]["resourceVersion"]
            t0 = time.perf_counter()
            s, _h, _b = rc.request_raw(
                "GET", one, headers={"X-Kcp-Min-Rv": str(rv)})
            waits_ms.append((time.perf_counter() - t0) * 1e3)
            assert s == 200, s
        rc.close()

        # --- session read-your-writes through the router ---
        reads_before = REGISTRY.counter("router_replica_reads_total").value
        fb_before = REGISTRY.counter("router_replica_fallback_total").value
        sc = RestClient(router.address, cluster="t2")
        stale = 0
        for i in range(rywr_steps):
            sc.create("configmaps", _lane_cm(f"rw{i}", "t2", str(i)))
            got = sc.get("configmaps", f"rw{i}", "default")
            if got["data"]["v"] != str(i):
                stale += 1
        sc.close()
        faults.clear()
        replica_reads = (REGISTRY.counter(
            "router_replica_reads_total").value - reads_before)
        fallbacks = (REGISTRY.counter(
            "router_replica_fallback_total").value - fb_before)
        replica_local = round(
            replica_reads / max(replica_reads + fallbacks, 1), 3)

        out = {
            "metric": "consistent_read_capacity_speedup",
            "value": speedup,
            "unit": "x",
            "stage": "consistent-bench",
            "consistent_bench": {
                "host_cpus": os.cpu_count(), "objects": objects,
                "replicas": n_replicas,
                "capacity_rps": {"primary_pinned": round(primary_pinned, 1),
                                 "spread": round(spread, 1)},
                "capacity_speedup": speedup,
                "bytes_equal": bytes_equal,
                "list_sha256": digest[:16],
                "wait_for_frontier": {
                    "p50_ms": round(float(np.percentile(waits_ms, 50)), 3),
                    "p99_ms": round(float(np.percentile(waits_ms, 99)), 3),
                    "writes": len(waits_ms)},
                "read_your_writes": {
                    "reads": rywr_steps, "stale": stale,
                    "replica_local_share": replica_local,
                    "fallbacks": int(fallbacks)},
            },
        }
        pc.close()
    finally:
        faults.clear()
        router.stop()
        for r in replicas:
            r.stop()
        primary.stop()
    return out


def _raise_nofile() -> None:
    """Lift RLIMIT_NOFILE's soft cap to the hard cap: every writer thread
    of the write-path lanes holds a connection, and 10k live watch streams
    are 10k fds on each side of the wire."""
    try:
        import resource

        _soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    except (ImportError, ValueError, OSError):
        pass


def writes_bench() -> dict:
    """Write-path group commit A/B (``--writes``): serial
    (``KCP_GROUP_COMMIT=0``) vs grouped (``=1``) at 1/16/64/256
    concurrent writers under honest per-commit durability
    (``KCP_WAL_SYNC=fsync`` by default — the cost the commit window
    exists to amortize).

    Two measurement altitudes. The HEADLINE (``value``) is the
    **write-path component**: concurrent writer tasks driving
    ``store.create`` + the durability barrier directly on one event
    loop — the mutation + WAL append + sync + fan-out work the commit
    window batches, with no HTTP serving overhead diluting it (median of 3
    trials per lane; the same altitude discipline as ``--store`` /
    ``--encode``). The **end-to-end** lanes run the same A/B through
    real HTTP serving (threads x RestClient against a ServerThread) and
    are reported alongside — on a 1-cpu host request serving dominates
    there, so the ratio is honest-but-smaller. Plus: (1) a seeded
    sequential CRUD equality pass — serial and grouped final state
    byte-identical modulo per-process identity fields
    (uid/creationTimestamp; the store-level fuzz in
    tests/test_group_commit.py pins those and proves FULL byte equality
    incl. the WAL), with identical RV sequences; (2) the
    kill-mid-window drill — durable primary + semi-sync standby,
    SIGKILL mid-storm, offline WAL replay (the repo's format-level reader,
    ``scripts/walreplay.py``) must carry every acked write.
    ``value`` is the grouped/serial write-path ratio at 64 writers.
    """
    import importlib.util
    import shutil
    import tempfile

    from .server.rest import RestClient
    from .server.server import Config
    from .server.threaded import ServerThread
    from .store.store import LogicalStore

    seconds = float(os.environ.get("KCP_BENCH_WRITES_SECONDS", "1.5"))
    concs = [int(x) for x in os.environ.get(
        "KCP_BENCH_WRITES_CONC", "1,16,64,256").split(",") if x.strip()]
    sync_mode = os.environ.get("KCP_BENCH_WRITES_SYNC", "fsync")
    eq_ops = int(os.environ.get("KCP_BENCH_WRITES_EQ_OPS", "400"))
    drill_writers = int(os.environ.get("KCP_BENCH_WRITES_DRILL_CONC", "8"))
    store_ops = int(os.environ.get("KCP_BENCH_WRITES_STORE_OPS", "200"))
    _raise_nofile()

    def pctile(vals: list[float], q: float) -> float:
        if not vals:
            return 0.0
        s = sorted(vals)
        return s[max(0, min(len(s) - 1, int(q * len(s)) - 1))]

    def spawn(root: str, grouped: bool, role: str = "",
              primary: str = "") -> ServerThread:
        # the store reads KCP_GROUP_COMMIT/KCP_WAL_SYNC at construction:
        # patch only for the constructor window (scenario-topology
        # discipline), restore after
        saved = {k: os.environ.get(k)
                 for k in ("KCP_GROUP_COMMIT", "KCP_WAL_SYNC",
                           "KCP_FLOW_CONCURRENCY")}
        os.environ["KCP_GROUP_COMMIT"] = "1" if grouped else "0"
        os.environ["KCP_WAL_SYNC"] = sync_mode
        # flow control off: a 1-writer lane would saturate one tenant's
        # default token rate and measure throttling, not the write path
        # (bench.py --admission owns the flow-control story)
        os.environ["KCP_FLOW_CONCURRENCY"] = "0"
        try:
            kw: dict = dict(durable=True, install_controllers=False,
                            tls=False, root_dir=root)
            if role:
                kw.update(role=role, primary=primary,
                          repl_hysteresis_s=30.0)
            return ServerThread(Config(**kw)).start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def hammer(address: str, writers: int, secs: float
               ) -> tuple[int, list[float], int]:
        """N writer threads creating as fast as acks return; returns
        (acked, per-write latencies, errors)."""
        lock = threading.Lock()
        acked = [0]
        errs = [0]
        lats: list[float] = []
        stop_at = time.perf_counter() + secs
        start = threading.Barrier(writers + 1)

        def work(wi: int) -> None:
            c = RestClient(address, cluster=f"t{wi % 8}")
            i = 0
            my: list[float] = []
            n = e = 0
            start.wait()
            try:
                while time.perf_counter() < stop_at:
                    t0 = time.perf_counter()
                    try:
                        c.create("configmaps",
                                 _lane_cm(f"w{wi}-{i}", f"t{wi % 8}", str(i)))
                        n += 1
                        my.append(time.perf_counter() - t0)
                    except Exception:
                        e += 1
                    i += 1
            finally:
                c.close()
            with lock:
                acked[0] += n
                errs[0] += e
                lats.extend(my)

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(writers)]
        for t in threads:
            t.start()
        start.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0
        return int(acked[0] / max(dt, 1e-9)), lats, errs[0]

    # ------------------------------------ write-path component (headline)
    def store_lane(grouped: bool, conc: int) -> tuple[float, list[float]]:
        """One trial: conc writer tasks on one loop, store.create + the
        durability barrier; returns (writes/s, latencies)."""
        os.environ["KCP_GROUP_COMMIT"] = "1" if grouped else "0"
        os.environ["KCP_WAL_SYNC"] = sync_mode
        # comparable sample sizes per lane: low-concurrency lanes get
        # proportionally more ops per writer so a 1-writer trial is not
        # a 50ms noise measurement
        per_writer = store_ops * max(1, 64 // max(conc, 1))
        with tempfile.TemporaryDirectory() as root:
            store = LogicalStore(wal_path=os.path.join(root, "w.wal"))

            async def drive():
                async def writer(wi: int) -> list[float]:
                    lat: list[float] = []
                    for i in range(per_writer):
                        t0 = time.perf_counter()
                        store.create("configmaps", f"t{wi % 8}",
                                     _lane_cm(f"w{wi}-{i}", f"t{wi % 8}", str(i)))
                        aw = store.commit_durable(store.resource_version)
                        if aw is not None:
                            await aw
                        else:
                            await asyncio.sleep(0)
                        lat.append(time.perf_counter() - t0)
                    return lat

                t0 = time.perf_counter()
                per = await asyncio.gather(
                    *(writer(i) for i in range(conc)))
                dt = time.perf_counter() - t0
                return conc * per_writer / dt, [x for ls in per for x in ls]

            rps, lats = asyncio.run(drive())
            store.close()
        return rps, lats

    saved_env = {k: os.environ.get(k)
                 for k in ("KCP_GROUP_COMMIT", "KCP_WAL_SYNC")}
    path_lanes: dict[str, dict] = {}
    try:
        for mode, grouped in (("serial", False), ("grouped", True)):
            path_lanes[mode] = {}
            for n in concs:
                trials = [store_lane(grouped, n) for _ in range(3)]
                trials.sort(key=lambda t: t[0])
                rps, lats = trials[1]  # median by throughput
                path_lanes[mode][str(n)] = {
                    "rps": round(rps),
                    "p50_ms": round(pctile(lats, 0.50) * 1e3, 3),
                    "p99_ms": round(pctile(lats, 0.99) * 1e3, 3),
                }
                print(f"write-path {mode} x{n}: {round(rps)} w/s  p99 "
                      f"{path_lanes[mode][str(n)]['p99_ms']}ms",
                      file=sys.stderr, flush=True)
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # --------------------------------------- end-to-end HTTP serving lanes
    lanes: dict[str, dict] = {}
    for mode, grouped in (("serial", False), ("grouped", True)):
        lanes[mode] = {}
        for n in concs:
            with tempfile.TemporaryDirectory() as root:
                srv = spawn(root, grouped)
                try:
                    rps, lats, errors = hammer(srv.address, n, seconds)
                finally:
                    srv.stop()
            lanes[mode][str(n)] = {
                "rps": rps, "errors": errors,
                "p50_ms": round(pctile(lats, 0.50) * 1e3, 3),
                "p99_ms": round(pctile(lats, 0.99) * 1e3, 3),
            }
            print(f"writes http {mode} x{n}: {rps} acks/s  "
                  f"p99 {lanes[mode][str(n)]['p99_ms']}ms "
                  f"({errors} errors)", file=sys.stderr, flush=True)

    # ------------------------------------------------ equality (A/B state)
    def equality_pass(grouped: bool) -> tuple[str, list[int]]:
        """One seeded sequential CRUD stream; returns (state digest
        modulo identity fields, rv sequence)."""
        rng = np.random.default_rng(7)
        rvs: list[int] = []
        with tempfile.TemporaryDirectory() as root:
            srv = spawn(root, grouped)
            try:
                c = RestClient(srv.address, cluster="t0")
                live: set[str] = set()
                for i in range(eq_ops):
                    name = f"eq{int(rng.integers(eq_ops // 4))}"
                    kind = int(rng.integers(3))
                    try:
                        if kind == 0 or name not in live:
                            out = c.create("configmaps",
                                           _lane_cm(name, "t0", str(i)))
                            live.add(name)
                        elif kind == 1:
                            cur = c.get("configmaps", name, "default")
                            cur["data"] = {"v": str(i)}
                            out = c.update("configmaps", cur)
                        else:
                            c.delete("configmaps", name, "default")
                            live.discard(name)
                            out = None
                    except Exception:
                        out = None
                    if out is not None:
                        rvs.append(int(out["metadata"]["resourceVersion"]))
                items, rv = c.list("configmaps", "default")
                stripped = [
                    {**o, "metadata": {
                        k: v for k, v in o["metadata"].items()
                        if k not in ("uid", "creationTimestamp")}}
                    for o in items]
                digest = hashlib.sha256(json.dumps(
                    [rv, stripped], sort_keys=True).encode()).hexdigest()
                c.close()
            finally:
                srv.stop()
        return digest, rvs

    d_serial, rv_serial = equality_pass(grouped=False)
    d_grouped, rv_grouped = equality_pass(grouped=True)
    state_equal = d_serial == d_grouped and rv_serial == rv_grouped

    # ------------------------------------------ kill-mid-window drill
    win0 = REGISTRY.counter("store_commit_windows_total").value
    ack0 = REGISTRY.counter("repl_ack_batched_total").value
    drill_root = tempfile.mkdtemp(prefix="kcp-writes-drill-")
    p = spawn(os.path.join(drill_root, "p"), grouped=True)
    s = spawn(os.path.join(drill_root, "s"), grouped=True,
              role="standby", primary=p.address)
    acked_names: list[str] = []
    lock = threading.Lock()

    # storm bounded in time, not ops: the kill must land mid-storm, and
    # a slow server teardown must not stretch the drill indefinitely
    drill_deadline = time.perf_counter() + max(0.5, seconds / 3) + 3.0

    def drill_writer(wi: int) -> None:
        c = RestClient(p.address, cluster="t1")
        try:
            for i in range(100_000):
                if time.perf_counter() > drill_deadline:
                    return
                name = f"dr{wi}-{i}"
                try:
                    c.create("configmaps", _lane_cm(name, "t1", str(i)))
                except Exception:
                    return  # dead primary: unacked by definition
                with lock:
                    acked_names.append(name)
        finally:
            c.close()

    storm = [threading.Thread(target=drill_writer, args=(i,))
             for i in range(drill_writers)]
    for t in storm:
        t.start()
    time.sleep(max(0.5, seconds / 3))
    p.kill()  # SIGKILL-equivalent: mid-window, no compaction
    for t in storm:
        t.join(timeout=30)
    s.stop()
    windows = REGISTRY.counter("store_commit_windows_total").value - win0
    acks_batched = REGISTRY.counter("repl_ack_batched_total").value - ack0
    spec = importlib.util.spec_from_file_location(
        "walreplay", os.path.join(REPO_ROOT, "scripts", "walreplay.py"))
    walreplay = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(walreplay)
    st = walreplay.replay(os.path.join(drill_root, "p", "store.wal"))
    shutil.rmtree(drill_root, ignore_errors=True)
    have = {key.decode().split("\x00")[3] for key in st.objects}
    lost = [nm for nm in acked_names if nm not in have]
    drill = {
        "writers": drill_writers,
        "acked_writes": len(acked_names),
        "lost_after_kill": len(lost),
        "commit_windows": windows,
        "acks_batched": acks_batched,
        "ok": not lost and windows > 0 and len(acked_names) > 0,
    }

    at = str(64 if 64 in concs else max(concs))
    base = max(path_lanes["serial"][at]["rps"], 1)
    http_base = max(lanes["serial"][at]["rps"], 1)
    out = {
        "metric": "write_group_commit_speedup",
        "value": round(path_lanes["grouped"][at]["rps"] / base, 2),
        "unit": "x",
        "stage": "writes-bench",
        "writes_bench": {
            "host_cpus": os.cpu_count(),
            "seconds": seconds,
            "wal_sync": sync_mode,
            "concurrency": concs,
            "write_path": {
                "serial": path_lanes["serial"],
                "grouped": path_lanes["grouped"],
                "speedup": {
                    str(n): round(
                        path_lanes["grouped"][str(n)]["rps"]
                        / max(path_lanes["serial"][str(n)]["rps"], 1), 2)
                    for n in concs},
            },
            "end_to_end_http": {
                "serial": lanes["serial"],
                "grouped": lanes["grouped"],
                "speedup_at_top": round(
                    lanes["grouped"][at]["rps"] / http_base, 2),
            },
            "p99_1_writer_ms": {
                "serial": path_lanes["serial"].get("1", {}).get("p99_ms"),
                "grouped": path_lanes["grouped"].get("1", {}).get("p99_ms"),
            },
            "state_equal": state_equal,
            "rv_sequence_equal": rv_serial == rv_grouped,
            "kill_drill": drill,
        },
    }
    return out

# --------------------------------------------------------------------------
# --watchers: watcher-scale serving (flush coalescing, slow-watcher eviction)

#: the ``--watchers`` lane's server child (:func:`watchers_serve`)
WATCHERS_SERVE_ARGV = [sys.executable, "-m", "kcp_tpu_torch.bench", "--watchers-serve"]


def watchers_serve() -> None:
    """Internal child for ``--watchers`` (``python -m kcp_tpu_torch.bench
    --watchers-serve``): one in-process asyncio server (LogicalStore +
    RestHandler + HttpServer, admission off) seeded with
    ``KCP_WB_OBJECTS`` deterministic configmaps across
    ``KCP_WB_CLUSTERS`` tenants, announced as one JSON line on stdout.
    It runs no controller and loads no torch.

    Split across processes deliberately: the parent holds the client end
    of every stream and this child holds the server end, so a 10k-stream
    run bills ~10k fds to EACH process instead of 20k to one (the
    RLIMIT_NOFILE wall). Determinism (fixed clock, preset uids, preset
    RV sequence) is what lets the A/B passes compare per-watcher stream
    hashes across separate child processes.
    """
    import signal

    from .apis.scheme import default_scheme
    from .server.handler import RestHandler
    from .server.httpd import HttpServer
    from .store.store import LogicalStore

    _raise_nofile()
    n_objects = int(os.environ.get("KCP_WB_OBJECTS", "100000"))
    n_clusters = int(os.environ.get("KCP_WB_CLUSTERS", "100"))

    async def run() -> None:
        store = LogicalStore(clock=lambda: 0.0)
        per = max(1, n_objects // n_clusters)
        for c in range(n_clusters):
            cl = f"w{c}"
            for i in range(per):
                store.create("configmaps", cl, {
                    "apiVersion": "v1", "kind": "ConfigMap",
                    "metadata": {"name": f"cm-{i}", "namespace": "default",
                                 "uid": f"uid-{cl}-{i}"},
                    "data": {"v": "0"},
                })
        handler = RestHandler(store, default_scheme(), admission=None)
        handler.ready = True
        srv = HttpServer(handler)
        await srv.start()
        # the parent terminates us: SIGTERM ends the serve and the process
        # exits 0, its exit hooks run
        stop = asyncio.Event()
        asyncio.get_running_loop().add_signal_handler(signal.SIGTERM, stop.set)
        print(json.dumps({"addr": srv.address, "objects": len(store),
                          "pid": os.getpid()}), flush=True)
        await stop.wait()
        await srv.stop()

    asyncio.run(run())


_WB_TOKEN_RE = re.compile(rb'"v": "m(\d+)"')


class _WatcherStats:
    """Shared accounting the raw watcher tasks append into."""

    def __init__(self):
        self.lines = 0
        self.established = 0
        self.lat: list[float] = []
        self.t_send: dict[int, float] = {}  # token -> just-before-send
        self.hashes: dict[int, str] = {}    # watcher idx -> stream sha256


async def _wb_watcher(i: int, host: str, port: int, cluster: str,
                      stats: _WatcherStats, ready: asyncio.Event,
                      hash_lines: bool = False) -> None:
    """One raw watch stream: minimal HTTP, chunked-line reassembly,
    latency sampling off the mutation tokens. Deliberately NOT RestWatch
    — 10k of these must cost a task + a socket + a buffer, nothing else."""
    reader, writer = await asyncio.open_connection(host, port)
    h = hashlib.sha256() if hash_lines else None
    try:
        writer.write(
            f"GET /clusters/{cluster}/api/v1/configmaps?watch=true "
            f"HTTP/1.1\r\nHost: bench\r\n\r\n".encode())
        await writer.drain()
        await reader.readuntil(b"\r\n\r\n")
        stats.established += 1
        ready.set()
        buf = b""
        while True:
            size_line = await reader.readline()
            if not size_line:
                return
            size = int(size_line.strip() or b"0", 16)
            if size == 0:
                return
            payload = await reader.readexactly(size)
            await reader.readexactly(2)  # \r\n
            now = time.monotonic()
            buf += payload
            *lines, buf = buf.split(b"\n")
            for line in lines:
                if not line:
                    continue
                stats.lines += 1
                if h is not None:
                    h.update(line + b"\n")
                m = _WB_TOKEN_RE.search(line)
                if m is not None:
                    t0 = stats.t_send.get(int(m.group(1)))
                    if t0 is not None:
                        stats.lat.append(now - t0)
    except (ConnectionError, asyncio.IncompleteReadError, OSError,
            ValueError):
        return
    finally:
        if h is not None:
            stats.hashes[i] = h.hexdigest()
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass


def _wb_spawn_child(objects: int, clusters: int, coalesce: bool,
                    flush_ms: str, extra_env: dict | None = None):
    """Spawn the --watchers-serve child; returns (Popen, host, port)."""
    import subprocess
    from urllib.parse import urlsplit

    env = dict(os.environ)
    env.pop("KCP_FAULTS", None)
    env["KCP_WB_OBJECTS"] = str(objects)
    env["KCP_WB_CLUSTERS"] = str(clusters)
    env["KCP_WATCH_COALESCE"] = "1" if coalesce else "0"
    env["KCP_WATCH_FLUSH_MS"] = flush_ms
    env.update(extra_env or {})
    p = subprocess.Popen(WATCHERS_SERVE_ARGV, stdout=subprocess.PIPE,
                         stderr=subprocess.DEVNULL, env=env, text=True,
                         cwd=REPO_ROOT)
    line = p.stdout.readline()
    if not line:
        raise RuntimeError(f"--watchers-serve child died rc={p.poll()}")
    info = json.loads(line)
    parts = urlsplit(info["addr"])
    return p, parts.hostname, parts.port


def _wb_slow_socket():
    """The evict drill's slow client socket, unconnected and non-blocking.
    A tiny SO_RCVBUF keeps the kernel from absorbing megabytes on the
    client's behalf — backpressure must reach the server's transport
    buffer, where the eviction policy watches."""
    import socket

    sk = socket.socket()
    sk.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
    sk.setblocking(False)
    return sk


def _wb_child_rss_kb(pid: int) -> int:
    with open(f"/proc/{pid}/status", encoding="ascii") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    return 0


def _wb_scrape_counter(host: str, port: int, name: str) -> float:
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=10)
    try:
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
    finally:
        conn.close()
    for line in text.splitlines():
        if line.startswith(name + " ") or line.startswith(name + "{"):
            return float(line.rsplit(None, 1)[-1])
    return 0.0


def _wb_mutate(host: str, port: int, schedule: list[tuple[str, str]],
               stats: _WatcherStats, threads: int = 4,
               pad: int = 0) -> float:
    """Drive the seeded update schedule over HTTP from worker threads
    (the serving loop lives in the child; the parent loop must stay free
    for 10k readers). Tokens stamp ``data.v`` so watchers can clock
    send→delivery without sharing a wall clock with the child. Returns
    elapsed seconds."""
    from .server.rest import RestClient

    lock = threading.Lock()
    pos = 0

    def worker() -> None:
        nonlocal pos
        # wildcard client: each update routes to the cluster named in
        # metadata.clusterName (the schedule spans many tenants)
        c = RestClient(f"http://{host}:{port}", cluster="*")
        try:
            while True:
                with lock:
                    if pos >= len(schedule):
                        return
                    tok = pos
                    cl, name = schedule[pos]
                    pos += 1
                stats.t_send[tok] = time.monotonic()
                data = {"v": f"m{tok}"}
                if pad:
                    data["pad"] = "x" * pad
                c.update("configmaps", {
                    "apiVersion": "v1", "kind": "ConfigMap",
                    "metadata": {"name": name, "namespace": "default",
                                 "clusterName": cl},
                    "data": data,
                })
        finally:
            c.close()

    t0 = time.perf_counter()
    ts = [threading.Thread(target=worker, daemon=True) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return time.perf_counter() - t0


async def _wb_mutate_pipelined(host: str, port: int,
                               schedule: list[tuple[str, str]],
                               stats: _WatcherStats,
                               pace_s: float = 0.0) -> float:
    """Drive the seeded update schedule over ONE pipelined HTTP/1.1
    connection: requests go out back-to-back and responses are reaped
    concurrently, so the commit rate is the server's processing rate,
    not one client round trip per write — the sustained-burst shape the
    flush A/B measures. A single connection also makes the COMMIT ORDER
    (and with it every rv and every watcher's byte stream) exactly the
    schedule order, which is what lets two separate child processes be
    compared hash-for-hash."""
    reader, writer = await asyncio.open_connection(host, port)
    t0 = time.perf_counter()

    async def reap() -> None:
        for _ in schedule:
            head = await reader.readuntil(b"\r\n\r\n")
            clen = 0
            for line in head.split(b"\r\n"):
                if line.lower().startswith(b"content-length:"):
                    clen = int(line.split(b":", 1)[1])
            if clen:
                await reader.readexactly(clen)

    reaper = asyncio.ensure_future(reap())
    try:
        for tok, (cl, name) in enumerate(schedule):
            body = json.dumps({
                "apiVersion": "v1", "kind": "ConfigMap",
                "metadata": {"name": name, "namespace": "default",
                             "clusterName": cl},
                "data": {"v": f"m{tok}"},
            }).encode()
            stats.t_send[tok] = time.monotonic()
            writer.write(
                f"PUT /clusters/{cl}/api/v1/configmaps/{name} HTTP/1.1\r\n"
                f"Host: bench\r\nContent-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
            if pace_s:
                # sustained rate, not one mega-burst: the A/B measures
                # flush amortization under a steady commit stream (a
                # burst that outruns every producer collapses both modes
                # into one flush and measures nothing)
                await asyncio.sleep(pace_s)
            elif tok % 32 == 31:
                await writer.drain()
        await writer.drain()
        await reaper
    finally:
        reaper.cancel()
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass
    return time.perf_counter() - t0


def watchers_bench() -> dict:
    """Watcher-scale serving bench (``--watchers``): can ONE server
    sustain 10k live watch streams at 100k objects with bounded memory
    and bounded delivery latency?

    Three lanes, one ``--watchers-serve`` child server process per lane
    (fd bill split across processes; see :func:`watchers_serve`):

    - **scale**: connect ``KCP_BENCH_WATCHERS`` streams in two halves
      against a 100k-object store, drive seeded update bursts, measure
      send→delivery p50/p99 across every stream and the child's RSS at
      each checkpoint — the gate is the RSS *slope* (per-watcher cost
      bounded, plateau under sustained load), not a magic number;
    - **flush A/B** (the headline value): the same seeded schedule at
      reduced scale against coalesced (KCP_WATCH_COALESCE=1) and
      per-batch (=0) children — per-watcher stream sha256 must be
      IDENTICAL across modes while ``watch_flush_total`` drops by the
      reported factor;
    - **evict drill**: a watcher that never reads while writes flood a
      tiny KCP_WATCH_BUFFER_MAX child — the slow socket must be evicted
      (metric + terminal typed 410 on the wire) while a healthy watcher
      on the same cluster keeps every event.
    """
    _raise_nofile()
    n_watchers = int(os.environ.get("KCP_BENCH_WATCHERS", "10000"))
    n_objects = int(os.environ.get("KCP_BENCH_WATCH_OBJECTS", "100000"))
    n_clusters = int(os.environ.get("KCP_BENCH_WATCH_CLUSTERS", "100"))
    n_muts = int(os.environ.get("KCP_BENCH_WATCH_MUTS", "1200"))
    # A/B width: small enough that the PER-BATCH baseline can actually
    # flush once per event batch (a saturated baseline auto-batches in
    # self-defense, flattering itself) — the reduction is measured where
    # the comparison is honest
    ab_watchers = int(os.environ.get("KCP_BENCH_WATCH_AB", "64"))
    ab_muts = int(os.environ.get("KCP_BENCH_WATCH_AB_MUTS", "600"))
    # scale lane serves at the production cadence; the A/B lane runs a
    # throughput-shaped tick (merging is bounded by commits-per-tick, so
    # the amortization factor is measured AT a declared cadence — the
    # docs' latency/syscall tradeoff, not a hidden knob)
    flush_ms = os.environ.get("KCP_BENCH_WATCH_FLUSH_MS", "2")
    ab_flush_ms = os.environ.get("KCP_BENCH_WATCH_AB_FLUSH_MS", "100")
    ab_pace_ms = float(os.environ.get("KCP_BENCH_WATCH_AB_PACE_MS", "3"))
    per_cluster = max(1, n_objects // n_clusters)

    def schedule_for(muts: int, clusters: int, focus: int = 0) -> list:
        """Seeded (cluster, name) update schedule. ``focus`` > 0 pins
        all updates onto that many clusters — the fan-out pressure
        shape the flush A/B measures."""
        rng = np.random.default_rng(1234)
        span = focus if focus else clusters
        return [(f"w{int(rng.integers(span))}",
                 f"cm-{int(rng.integers(per_cluster))}")
                for _ in range(muts)]

    async def stop(p, tasks: list) -> None:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        _stop_all([p])

    async def scale_lane() -> dict:
        p, host, port = _wb_spawn_child(n_objects, n_clusters, True,
                                        flush_ms)
        stats = _WatcherStats()
        out: dict = {"watchers": n_watchers, "objects": n_objects,
                     "clusters": n_clusters, "mutations": n_muts}
        tasks: list[asyncio.Task] = []
        loop = asyncio.get_running_loop()
        try:
            rss0 = _wb_child_rss_kb(p.pid)

            async def connect(count: int, base: int) -> None:
                chunk = 200
                for at in range(0, count, chunk):
                    evs = []
                    for i in range(at, min(at + chunk, count)):
                        ready = asyncio.Event()
                        evs.append(ready)
                        tasks.append(asyncio.ensure_future(_wb_watcher(
                            base + i, host, port,
                            f"w{(base + i) % n_clusters}", stats, ready)))
                    await asyncio.gather(*(e.wait() for e in evs))

            half = n_watchers // 2
            await connect(half, 0)
            await loop.run_in_executor(
                None, _wb_mutate, host, port,
                schedule_for(n_muts // 2, n_clusters), stats)
            await asyncio.sleep(0.5)
            rss_half = _wb_child_rss_kb(p.pid)
            stats.lat.clear()
            await connect(n_watchers - half, half)
            out["streams_established"] = stats.established
            await loop.run_in_executor(
                None, _wb_mutate, host, port,
                schedule_for(n_muts // 2, n_clusters), stats)
            await asyncio.sleep(0.5)
            rss_full = _wb_child_rss_kb(p.pid)
            lat = sorted(stats.lat)
            out["delivery_p50_ms"] = round(
                1000 * lat[len(lat) // 2], 2) if lat else None
            out["delivery_p99_ms"] = round(
                1000 * lat[int(len(lat) * 0.99) - 1], 2) if lat else None
            out["latency_samples"] = len(lat)
            # plateau: more sustained load at FULL width must not grow
            # the resident set (bounded queues + bounded caches)
            await loop.run_in_executor(
                None, _wb_mutate, host, port,
                schedule_for(n_muts // 2, n_clusters), stats)
            await asyncio.sleep(0.5)
            rss_soak = _wb_child_rss_kb(p.pid)
            out["rss_kb"] = {"start": rss0, "half": rss_half,
                             "full": rss_full, "soak": rss_soak}
            out["rss_per_watcher_kb"] = round(
                (rss_full - rss_half) / max(n_watchers - half, 1), 2)
            out["rss_soak_growth"] = round(
                rss_soak / max(rss_full, 1), 4)
            out["lines_delivered"] = stats.lines
            out["evicted"] = _wb_scrape_counter(
                host, port, "watch_evicted_total")
            out["resumes_shared"] = _wb_scrape_counter(
                host, port, "watch_resume_shared_total")
        finally:
            await stop(p, tasks)
        return out

    async def ab_lane() -> dict:
        """Coalesced vs per-batch flush A/B: identical seeded schedule,
        per-watcher stream hashes must match; flush count is the value."""
        ab_objects = min(n_objects, 10000)
        ab_clusters = 2  # all pressure on few clusters: every event
        # fans out to ~half the A/B watchers, the shape coalescing serves
        results: dict[str, dict] = {}
        for label, coalesce in (("per_batch", False), ("coalesced", True)):
            p, host, port = _wb_spawn_child(ab_objects, ab_clusters,
                                            coalesce, ab_flush_ms)
            stats = _WatcherStats()
            tasks: list[asyncio.Task] = []
            try:
                flush0 = _wb_scrape_counter(host, port, "watch_flush_total")
                evs = []
                for i in range(ab_watchers):
                    ready = asyncio.Event()
                    evs.append(ready)
                    tasks.append(asyncio.ensure_future(_wb_watcher(
                        i, host, port, f"w{i % ab_clusters}", stats, ready,
                        hash_lines=True)))
                await asyncio.gather(*(e.wait() for e in evs))
                elapsed = await _wb_mutate_pipelined(
                    host, port,
                    schedule_for(ab_muts, ab_clusters, focus=ab_clusters),
                    stats, pace_s=ab_pace_ms / 1000.0)
                # let the tail of the fan-out land before hashing stops:
                # every watcher sees its cluster's share
                for _ in range(200):
                    if stats.lines >= ab_muts * (ab_watchers // ab_clusters):
                        break
                    await asyncio.sleep(0.05)
                flush1 = _wb_scrape_counter(host, port, "watch_flush_total")
            finally:
                await stop(p, tasks)
            results[label] = {
                "flushes": flush1 - flush0,
                "lines": stats.lines,
                "elapsed_s": round(elapsed, 3),
                "hashes": dict(stats.hashes),
            }
        a, b = results["per_batch"], results["coalesced"]
        bytes_equal = (a["hashes"] == b["hashes"]
                       and len(a["hashes"]) == ab_watchers)
        reduction = a["flushes"] / max(b["flushes"], 1.0)
        return {
            "watchers": ab_watchers, "mutations": ab_muts,
            "clusters": ab_clusters, "flush_ms": ab_flush_ms,
            "pace_ms": ab_pace_ms,
            "bytes_equal": bytes_equal,
            "lines_equal": a["lines"] == b["lines"],
            "flushes_per_batch": a["flushes"],
            "flushes_coalesced": b["flushes"],
            "flush_reduction": round(reduction, 2),
            "per_batch_s": a["elapsed_s"], "coalesced_s": b["elapsed_s"],
        }

    async def evict_lane() -> dict:
        """Slow-watcher eviction drill: one stream that never reads, one
        healthy stream, writes until the slow socket passes the buffer
        bound — expect the eviction metric, a terminal typed 410 on the
        wire, and zero disturbance to the healthy stream."""
        p, host, port = _wb_spawn_child(
            64, 1, True, "1", {"KCP_WATCH_BUFFER_MAX": "4096"})
        out: dict = {}
        stats = _WatcherStats()
        tasks: list[asyncio.Task] = []
        try:
            # the slow client: sends the watch request, never reads
            sk = _wb_slow_socket()
            await asyncio.get_running_loop().sock_connect(sk, (host, port))
            s_reader, s_writer = await asyncio.open_connection(sock=sk)
            s_writer.write(b"GET /clusters/w0/api/v1/configmaps?watch=true "
                           b"HTTP/1.1\r\nHost: bench\r\n\r\n")
            await s_writer.drain()
            ready = asyncio.Event()
            tasks.append(asyncio.ensure_future(_wb_watcher(
                0, host, port, "w0", stats, ready)))
            await ready.wait()
            loop = asyncio.get_running_loop()
            writes = 400
            await loop.run_in_executor(
                None, _wb_mutate, host, port,
                [("w0", f"cm-{i % 64}") for i in range(writes)], stats, 2,
                16384)  # padded events: the backlog must outrun the
            # kernel's own socket buffering to reach the eviction bound
            deadline = loop.time() + 20
            evicted = 0.0
            while loop.time() < deadline:
                evicted = _wb_scrape_counter(host, port,
                                             "watch_evicted_total")
                if evicted:
                    break
                await asyncio.sleep(0.2)
            out["evicted_total"] = evicted
            # now read what the server buffered for the slow client: the
            # stream must end in a terminal typed 410 Status
            data = b""
            try:
                while True:
                    chunk = await asyncio.wait_for(s_reader.read(65536),
                                                   timeout=5)
                    if not chunk:
                        break
                    data += chunk
            except asyncio.TimeoutError:
                pass
            out["terminal_410"] = (b'"code": 410' in data
                                   and b'"reason": "Expired"' in data)
            s_writer.close()
            # the healthy stream saw every committed write
            for _ in range(100):
                if stats.lines >= writes:
                    break
                await asyncio.sleep(0.05)
            out["healthy_lines"] = stats.lines
            out["healthy_expected"] = writes
            out["ok"] = bool(out["terminal_410"]) and evicted >= 1 \
                and stats.lines >= writes
        finally:
            await stop(p, tasks)
        return out

    async def run() -> dict:
        scale = await scale_lane()
        ab = await ab_lane()
        drill = await evict_lane()
        return {"scale": scale, "ab": ab, "evict_drill": drill}

    res = asyncio.run(run())
    return {
        "metric": "watch_flush_reduction",
        "value": res["ab"]["flush_reduction"],
        "unit": "x",
        "stage": "watchers",
        "watchers_bench": res,
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
    lane.add_argument("--suite", action="store_true",
                      help="BASELINE configs 2-4 and the decision+fanout A/B")
    lane.add_argument("--sharded", action="store_true",
                      help="fleet write capacity at 1/2/4 shards, the kill drill")
    lane.add_argument("--smartclient", action="store_true",
                      help="direct against routed writes, the ring-change drill")
    lane.add_argument("--elastic", action="store_true",
                      help="the fleet doubles live under writers")
    lane.add_argument("--store", action="store_true",
                      help="indexed against linear-scan store reads and watch fan-out")
    lane.add_argument("--encode", action="store_true",
                      help="encode-once against per-request serialization")
    lane.add_argument("--admission", action="store_true",
                      help="the admission chain's overhead, the noisy-neighbor storm")
    lane.add_argument("--replica", action="store_true",
                      help="read capacity at 0/1/2 replicas, the kill-the-primary drill")
    lane.add_argument("--consistent", action="store_true",
                      help="RV-barrier consistent reads, read-your-writes via the router")
    lane.add_argument("--writes", action="store_true",
                      help="serial against grouped commit, the kill-mid-window drill")
    lane.add_argument("--watchers", action="store_true",
                      help="10k live watch streams, the flush A/B, the evict drill")
    lane.add_argument("--shard-loadgen", action="store_true", help=argparse.SUPPRESS)
    lane.add_argument("--watchers-serve", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.shard_loadgen:
        shard_loadgen()
        return
    if args.watchers_serve:
        watchers_serve()
        return
    if args.placement:
        env = lambda name, default: int(os.environ.get(  # noqa: E731
            f"KCP_BENCH_PLACEMENT_{name}", "") or default)
        print(json.dumps(placement_bench(
            args.device, W=env("WORKSPACES", 10000), P=env("PCLUSTERS", 8),
            spread=env("SPREAD", 2), iters=env("ITERS", 5),
            loop_rows=env("LOOP_ROWS", 0), dirty=env("DIRTY_ROWS", 37))))
        return
    host_lanes = {"sharded": sharded_bench, "smartclient": smartclient_bench,
                  "elastic": elastic_bench, "store": store_bench,
                  "encode": encode_bench, "admission": admission_bench,
                  "replica": replica_bench, "consistent": consistent_bench,
                  "writes": writes_bench, "watchers": watchers_bench}
    host_lane = next((k for k in host_lanes if getattr(args, k)), None)
    if (args.fleet or args.pagination or args.gauntlet or args.trace or args.suite
            or host_lane):
        try:
            # the lanes with device work resolve it before any run: a
            # missing card ends the lane here, with nothing measured
            if args.fleet or args.suite:
                from .utils.device import resolve_device

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
        elif args.suite:
            out = suite(device)
        elif host_lane:
            out = host_lanes[host_lane]()
            out["note"] = HOST_PATH_NOTE
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
    from .syncer.core import FusedCore

    core = FusedCore(batch_window=0.0005, pipeline=args.pipeline, device=args.device)
    out = asyncio.run(closed_loop(core, args.rows, churn=args.churn,
                                  seconds=args.seconds))
    out.pop("owner")
    out["device"] = str(core.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
