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
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import time

import numpy as np

from .syncer.core import FusedCore


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


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--rows", type=int, default=131072)
    ap.add_argument("--churn", type=int, default=768)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--pipeline", choices=("serial", "double"), default=None)
    ap.add_argument("--placement", action="store_true",
                    help="run the fleet bin-pack lane (BASELINE configs[2])")
    args = ap.parse_args(argv)
    if args.placement:
        env = lambda name, default: int(os.environ.get(  # noqa: E731
            f"KCP_BENCH_PLACEMENT_{name}", "") or default)
        print(json.dumps(placement_bench(
            args.device, W=env("WORKSPACES", 10000), P=env("PCLUSTERS", 8),
            spread=env("SPREAD", 2), iters=env("ITERS", 5),
            loop_rows=env("LOOP_ROWS", 0), dirty=env("DIRTY_ROWS", 37))))
        return
    core = FusedCore(batch_window=0.0005, pipeline=args.pipeline, device=args.device)
    out = asyncio.run(closed_loop(core, args.rows, churn=args.churn,
                                  seconds=args.seconds))
    out.pop("owner")
    out["device"] = str(core.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
