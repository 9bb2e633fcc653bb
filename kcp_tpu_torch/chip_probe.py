"""Probes of the port on a CUDA card that ``chip_smoke.py`` does not run.

Run from the repo root on a card:

- ``python3 -m kcp_tpu_torch.chip_probe host`` — the host cost of one
  ``decide_and_match`` call at the serving shape, 3-output and fleet
  form, whole and piece by piece (check, tile plan, output allocation,
  device and stream lookup, the launch), and of one
  ``decide_and_match_sharded`` call over mesh ``"4"`` (fleet form), before
  and after a torch.profiler session;
- ``python3 -m kcp_tpu_torch.chip_probe host TREE [TREE ...]`` — for each
  TREE, in a process of its own and in the order given (parent, change,
  change, parent to compare two commits): the host µs of one call of the
  public wrappers at the serving shape (fleet form, 3-output form,
  ``decide_and_match_sharded`` over mesh ``"4"``) and their launches per call;
- ``python3 -m kcp_tpu_torch.chip_probe sweep`` — the fleet form's device
  time at the serving shape under other tile plans (blocks per SM, stage
  bytes, ring depth), each checked against the plain version;
- ``python3 -m kcp_tpu_torch.chip_probe readings [REPEATS [TREE ...]]`` — the
  kernel's device time at the serving shape (fleet form, 3-output form,
  mesh ``"4"``) and at the suite lane's (bucket-wide mask, L=8, C=64,
  3-output form), REPEATS times (5 by default), read the plain way (one
  profile of 20 back-to-back calls, no unmeasured call first,
  ``key_averages``' sum over 20; back to back and with 256 MiB read
  before each call), with the events that profile saw, and the way
  ``chip_smoke.py`` reads it (``kernel_device_ms``: every call's events
  counted) back to back and with the L2 flushed by reading 256 MiB, by
  writing them, and by writing them and then reading another 256 MiB
  (the L2 left clean, holding none of the inputs). With TREEs, each
  TREE's package is read so in a process of its own, in the order given;
- ``python3 -m kcp_tpu_torch.chip_probe ab TREE [TREE ...]`` — for each
  TREE (a checkout of this repo, say a parent commit unpacked with
  ``git archive`` into a git-ignored directory), in the order given and
  each in a process of its own: chip_smoke.py's phase-4 step, unsharded
  and over mesh ``"4"`` (CUDA events, upload included; the median of 5
  runs of 20 steps), the phase-5/5b closed loops and their tick-phase
  means (``KCP_PROBE_SECONDS`` each, 8 by default; 0 skips them), and
  last each step's device events and device time (profiler). Give the
  trees as parent, change, change, parent to compare two commits on one
  card;
- ``python3 -m kcp_tpu_torch.chip_probe lanes [PAIRS [LOG]]`` — the reference's
  ``python bench.py --admission`` and ``--sharded`` against the port's
  ``python -m kcp_tpu_torch.bench`` lanes at ``scripts/ci.sh``'s shapes
  (``chip_smoke.py``'s ``STORE_LANES_CI`` and ``HOST_LANES_CI``), in
  PAIRS alternating pairs (10 by default; reference first in even pairs,
  the port first in odd ones), each run a child process of its own
  through ``chip_smoke.py``'s ``WRAPPER``: the gate readings (the
  admission overhead, the storm's quiet p99 ratio, the 2-shard capacity
  ratio), the JAX modules the child loaded, its full collections and CPU
  seconds, and ``/proc/loadavg`` before it; then each side's readings and
  misses per gate. Host path: it needs no card. With LOG, every record
  is also appended to that file as a JSON line.

- ``python3 -m kcp_tpu_torch.chip_probe wire`` — ``wire_scatter``'s two
  launches at ``fleet-1m``'s shape (1,048,576 rows, S=64, per-row mask, a
  wire of 128 entries, 1,024 acks) against the torch path they replace on
  the card: host µs per call, device ms per call and device events per call
  (profiler), and the bytes each stage needs over the card's peak.

Each prints one line per reading and, for ``ab``, one JSON line per tree.
The measuring code and its cases are this tree's (``chip_smoke.py``'s
helpers); only the package under test comes from TREE.
"""

from __future__ import annotations

import asyncio
import functools
import importlib.util
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVING_B, SERVING_S = 131072, 64


@functools.cache
def _smoke():
    """This tree's chip_smoke.py as a module (its helpers import the
    package lazily, so they use whichever ``kcp_tpu_torch`` is loaded)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _host_us(fn, torch, n: int = 300) -> tuple[float, float]:
    """(host µs per call to enqueue, µs per call with the device drained)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) / n * 1e6, (t2 - t0) / n * 1e6


def _use_tree(tree: str) -> str:
    """Import ``kcp_tpu_torch`` from ``tree`` in this process."""
    tree = os.path.abspath(tree)
    sys.path[:] = [tree] + [p for p in sys.path[1:]
                            if os.path.abspath(p or ".") not in (REPO, tree)]
    import kcp_tpu_torch

    if not kcp_tpu_torch.__file__.startswith(tree + os.sep):
        raise SystemExit(f"loaded {kcp_tpu_torch.__file__}, not the package in {tree}")
    return tree


def _serving_calls(torch, ck, pm, dev) -> dict:
    """The public wrappers' calls at the serving shape: name -> call."""
    import numpy as np

    cs = _smoke()
    rng = np.random.default_rng(2024)
    case = cs.kernel_case(rng, SERVING_B, SERVING_S, 1, 8, True, torch, dev)
    seg = cs.segments(rng, SERVING_B, torch, dev)
    mesh = cs.smoke_mesh("4", dev)
    layouts = (pm.ROWS, pm.FLAGS, pm.ROWS, pm.FLAGS, pm.ROWS, pm.FLAGS, pm.REPLICATED, pm.FLAGS)
    args = [pm.ShardedTensor.put(x, mesh, lay) for x, lay in zip((*case, seg), layouts)]
    return {
        "fleet": lambda: ck.decide_and_match(*case, seg_ids=seg, seg_capacity=cs.SEG_CAPACITY),
        "3-output": lambda: ck.decide_and_match(*case),
        "mesh 4": lambda: ck.decide_and_match_sharded(mesh, *args,
                                                      seg_capacity=cs.SEG_CAPACITY),
    }


def host_calls(tree: str) -> None:
    """One tree's host µs per public wrapper call (run in a process of its
    own by ``host TREE ...``)."""
    tree = _use_tree(tree)
    import torch

    from kcp_tpu_torch.ops import cuda_kernels as ck
    from kcp_tpu_torch.parallel import mesh as pm

    rec = {"tree": tree}
    for name, fn in _serving_calls(torch, ck, pm, torch.device("cuda")).items():
        before = ck.decide_and_match.launches + ck.decide_and_match_sharded.launches
        enq, drained = _host_us(fn, torch)
        launched = ck.decide_and_match.launches + ck.decide_and_match_sharded.launches - before
        rec[name] = dict(host_us=enq, drained_us=drained, launches_per_call=launched / 320)
    print(json.dumps(rec))


def host_ab(trees: list[str], card: str) -> None:
    runs = []
    for tree in trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "host-calls", tree],
                              capture_output=True, text=True, timeout=600, cwd=REPO)
        if proc.returncode != 0:
            raise SystemExit(f"host: {tree} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]))
    for name in ("fleet", "3-output", "mesh 4"):
        print(f"host {name}: " + ", ".join(
            f"{os.path.relpath(r['tree'], REPO)} {r[name]['host_us']:.1f} us "
            f"({r[name]['launches_per_call']:g} launches a call)" for r in runs)
            + f" per call on the host [{card}]")


def host(card: str) -> None:
    import numpy as np
    import torch

    from kcp_tpu_torch.ops import cuda_kernels as ck
    from kcp_tpu_torch.parallel import mesh as pm

    cs = _smoke()
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    b = SERVING_B
    case = cs.kernel_case(rng, b, SERVING_S, 1, 8, True, torch, dev)
    seg = cs.segments(rng, b, torch, dev)
    up, upe, down, dne, mask, pair, sel = case
    forms = {"3-output": {}, "fleet": dict(seg_ids=seg, seg_capacity=cs.SEG_CAPACITY)}
    counts = torch.zeros(8, dtype=torch.int32, device=dev)
    seg_counts = torch.zeros(cs.SEG_CAPACITY, dtype=torch.int32, device=dev)
    ptrs = tuple(x.data_ptr() for x in (up, down, mask, upe, dne, pair, seg))
    sms = ck._sm_count(dev)

    def stream():  # as _launch finds the device and its stream
        idx = ck._index(dev)
        return idx != torch.cuda.current_device(), torch.cuda.current_stream(idx).cuda_stream

    pieces = {
        "_check": lambda: ck._check(*case, seg),
        "_group_plan": lambda: ck._group_plan(
            ((b, ck._aligned(ptrs, ck._row_bytes(SERVING_S, 1, True, True))),),
            SERVING_S, 1, 8, True, True, cs.SEG_CAPACITY, sms),
        "torch.zeros([8])": lambda: torch.zeros(8, dtype=torch.int32, device=dev),
        "torch.empty([B])": lambda: torch.empty(b, dtype=torch.uint8, device=dev),
        "device + stream": stream,
        "_launch (fleet, counts given)": lambda: ck._launch([(*case, seg)], counts, seg_counts),
    }
    sharded = _serving_calls(torch, ck, pm, dev)["mesh 4"]
    for when in ("before any profiler session", "after a profiler session"):
        if when.startswith("after"):
            cs.kernel_device_ms(lambda: ck.decide_and_match(*case, **forms["fleet"]), torch, 1,
                                "host probe")
        for form, kw in forms.items():
            enq, drained = _host_us(lambda: ck.decide_and_match(*case, **kw), torch)
            ev = cs.time_ms(lambda: ck.decide_and_match(*case, **kw), torch, 50)
            print(f"host [{when}] decide_and_match {form}: {enq:.1f} us per call on the host, "
                  f"{drained:.1f} us with the device drained, {ev * 1e3:.1f} us per "
                  f"back-to-back call (events) [{card}]")
        enq, drained = _host_us(sharded, torch)
        print(f"host [{when}] decide_and_match_sharded mesh 4, fleet: {enq:.1f} us per call on "
              f"the host, {drained:.1f} us with the device drained [{card}]")
        for name, fn in pieces.items():
            enq, _ = _host_us(fn, torch)
            print(f"host [{when}] piece {name}: {enq:.1f} us per call [{card}]")


def sweep(card: str) -> None:
    import numpy as np
    import torch

    from kcp_tpu_torch.ops import cuda_kernels as ck

    cs = _smoke()
    dev = torch.device("cuda")
    rng = np.random.default_rng(2026)
    case = cs.kernel_case(rng, SERVING_B, SERVING_S, 1, 8, True, torch, dev)
    kw = dict(seg_ids=cs.segments(rng, SERVING_B, torch, dev), seg_capacity=cs.SEG_CAPACITY)
    want = ck.decide_and_match_plain(*case, **kw)
    got = ck.decide_and_match(*case, **kw)
    bound_ms = cs.bound((*case, kw["seg_ids"]), got)[0]
    default = (ck.BLOCKS_PER_SM, ck.STAGE_TARGET, ck.MAX_STAGES)
    variants = [default, (1, 24 * 1024, 4), (1, 24 * 1024, 2), (1, 40 * 1024, 3),
                (2, 24 * 1024, 3), (2, 12 * 1024, 3), (3, 24 * 1024, 2), default]
    try:
        for bps, target, stages in variants:
            ck.BLOCKS_PER_SM, ck.STAGE_TARGET, ck.MAX_STAGES = bps, target, stages
            ck._group_plan.cache_clear()
            got = ck.decide_and_match(*case, **kw)
            if any(not torch.equal(g, w) for g, w in zip(got, want)):
                raise SystemExit(f"sweep: plan {ck.last_plan} differs from the plain version")
            ms, _n = cs.kernel_device_ms(lambda: ck.decide_and_match(*case, **kw), torch, 1,
                                         "sweep")
            print(f"sweep [serving, fleet form]: {bps} block(s) per SM, "
                  f"{cs.plan_text(ck.last_plan)}: equal; kernel {ms:.4f} ms "
                  f"({bound_ms / ms * 100:.1f}% of the bound rate) on the device"
                  f"{' (default plan)' if (bps, target, stages) == default else ''} [{card}]")
    finally:
        ck.BLOCKS_PER_SM, ck.STAGE_TARGET, ck.MAX_STAGES = default
        ck._group_plan.cache_clear()


def readings(card: str, repeats: int) -> None:
    import numpy as np
    import torch

    from kcp_tpu_torch.ops import cuda_kernels as ck
    from kcp_tpu_torch.parallel import mesh as pm

    cs = _smoke()
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    case = cs.kernel_case(rng, SERVING_B, SERVING_S, 1, 8, True, torch, dev)
    seg = cs.segments(rng, SERVING_B, torch, dev)
    mesh = cs.smoke_mesh("4", dev)
    layouts = (pm.ROWS, pm.FLAGS, pm.ROWS, pm.FLAGS, pm.ROWS, pm.FLAGS, pm.REPLICATED, pm.FLAGS)
    args = [pm.ShardedTensor.put(x, mesh, lay) for x, lay in zip((*case, seg), layouts)]
    suite = cs.kernel_case(rng, SERVING_B, SERVING_S, 8, 64, False, torch, dev)
    fleet_bound = cs.bound((*case, seg), ck.decide_and_match_plain(
        *case, seg_ids=seg, seg_capacity=cs.SEG_CAPACITY))[0]
    forms = {  # form -> (call, bound ms)
        "fleet form": (lambda: ck.decide_and_match(*case, seg_ids=seg,
                                                   seg_capacity=cs.SEG_CAPACITY), fleet_bound),
        "3-output": (lambda: ck.decide_and_match(*case),
                     cs.bound(case, ck.decide_and_match_plain(*case))[0]),
        "mesh 4": (lambda: ck.decide_and_match_sharded(mesh, *args,
                                                       seg_capacity=cs.SEG_CAPACITY),
                   fleet_bound),
        "suite": (lambda: ck.decide_and_match(*suite),
                  cs.bound(suite, ck.decide_and_match_plain(*suite))[0]),
    }
    buf = torch.ones(cs.L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    other = torch.ones_like(buf)
    flushes = {"back to back": None, "L2 flushed by reading": buf.sum,
               "by writing": buf.zero_,
               "by writing, then reading another 256 MiB": lambda: (buf.zero_(), other.sum())}

    def earlier(fn, flush) -> str:
        run = (lambda: [fn() for _ in range(20)]) if flush is None else (
            lambda: [(flush(), fn()) for _ in range(20)])
        _wall, ev = cs.device_profile(run, torch)
        seen = sum(n for k, (n, _us) in ev.items() if "decide_match_kernel" in k)
        us = sum(us for k, (_n, us) in ev.items() if "decide_match_kernel" in k)
        return f"{us / 20 / 1e3:.4f} ms from {seen} kernel events"

    def launches_of(fn) -> int:  # kernel launches of one call (a parent tree's may be several)
        before = ck.decide_and_match.launches + ck.decide_and_match_sharded.launches
        fn()
        return ck.decide_and_match.launches + ck.decide_and_match_sharded.launches - before

    for rep in range(repeats):
        for form, (fn, bound_ms) in forms.items():
            launches = launches_of(fn)
            for _ in range(3):
                fn()
            old = (f"back to back {earlier(fn, None)}, L2 flushed by reading "
                   f"{earlier(fn, buf.sum)}")
            new = []
            for how, flush in flushes.items():
                ms, _n = cs.kernel_device_ms(fn, torch, launches, form, flush=flush)
                new.append(f"{how} {ms:.4f} ms ({bound_ms / ms * 100:.1f}%)")
            print(f"readings {rep + 1}/{repeats} [{form}; {20 * launches} kernel "
                  f"events a reading]: one profile over 20 calls: {old}; as chip_smoke.py reads it "
                  f"({launches} event(s) in each of 20 calls): " + ", ".join(new)
                  + f"; bound {bound_ms:.5f} ms [{card}]", flush=True)


def wire(card: str) -> None:
    import torch

    from kcp_tpu_torch.models import reconcile_model as tm
    from kcp_tpu_torch.ops.cuda_kernels import wire_scatter
    from kcp_tpu_torch.ops.diff import apply_deltas

    cs = _smoke()
    dev = torch.device("cuda")
    state, seg, packed, acks, pk, ak = cs.wire_case(torch, dev)
    b, s = cs.WIRE_B, cs.SERVING["s"]
    st = tm.state_from_numpy(state, dev)
    sg = tm.to_device(seg, dev)
    lanes = (st.up_vals, st.up_exists, st.down_vals, st.down_exists)
    deltas = tm.unpack_deltas(pk)

    def torch_stamps():
        tm.apply_side_lanes_plain(st, pk, ak, sg)
        tm.unpack_deltas(pk)

    def torch_scatter():
        d = deltas
        apply_deltas(st.up_vals, st.up_exists, d.idx, d.vals, d.exists, d.valid & ~d.side)
        apply_deltas(st.down_vals, st.down_exists, d.idx, d.vals, d.exists, d.valid & d.side)
        d.valid.sum(dtype=torch.int32)

    need = cs.wire_bytes(packed, acks, b, True)
    calls = {  # label -> (call, kernel name or None for every device event, bytes)
        "wire_scatter stamps": (lambda: wire_scatter("stamps", pk, *lanes, st.status_mask, sg,
                                                     ak), "wire_scatter_kernel", need["stamps"]),
        "wire_scatter deltas": (lambda: wire_scatter("deltas", pk, *lanes),
                                "wire_scatter_kernel", need["deltas"]),
        "torch stamps (step.stamps on the CPU path)": (torch_stamps, None, need["stamps"]),
        "torch scatter (step.scatter on the CPU path)": (torch_scatter, None, need["deltas"]),
    }
    for label, (fn, kernel, nbytes) in calls.items():
        enq, drained = _host_us(fn, torch)
        ms, events = cs.kernel_device_ms(fn, torch, 1 if kernel else None, label, kernel=kernel)
        bound_ms = nbytes / cs.HBM_BYTES_PER_S * 1e3
        print(f"wire [{label}; B={b} S={s} wire {packed.shape[0]} entries, "
              f"{acks.shape[0]} acks]: host {enq:.1f} us per call, {drained:.1f} us with the "
              f"device drained; device {ms:.4f} ms per call in {events} device event(s) "
              f"(profiler, back to back); {nbytes} B needed, bound {bound_ms:.6f} ms at "
              f"{cs.HBM_BYTES_PER_S / 1e12:.2f} TB/s ({bound_ms / ms * 100:.2f}%) [{card}]",
              flush=True)


def readings_ab(trees: list[str], repeats: int) -> None:
    for tree in trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "readings-in", tree,
                               str(repeats)], capture_output=True, text=True, timeout=1200,
                              cwd=REPO)
        if proc.returncode != 0:
            raise SystemExit(f"readings: {tree} failed ({proc.returncode}):\n"
                             f"{proc.stderr[-4000:]}")
        for line in proc.stdout.strip().splitlines():
            print(f"{os.path.relpath(os.path.abspath(tree), REPO)}: {line}", flush=True)


def _phase_means(before: dict, after: dict) -> dict:
    """Tick-phase means (ms) of the ``fused_*_seconds`` histograms over the
    observations between two registry snapshots."""
    out = {}
    for k, v in after.items():
        if k.startswith("fused_") and k.endswith("_seconds") and isinstance(v, dict):
            b = before.get(k) or {"count": 0, "mean": 0.0}
            n = v["count"] - b["count"]
            if n:
                out[k[6:-8]] = (v["mean"] * v["count"] - b["mean"] * b["count"]) / n * 1e3
    return out


def measure(tree: str, seconds: float, device: str = "cuda", b: int = SERVING_B) -> None:
    """One tree's readings (run in a process of its own by ``ab``)."""
    tree = _use_tree(tree)
    import numpy as np
    import torch

    from kcp_tpu_torch.bench import closed_loop
    from kcp_tpu_torch.models import reconcile_model as tm
    from kcp_tpu_torch.parallel.mesh import FLAGS, ShardedTensor, shard_state
    from kcp_tpu_torch.syncer.core import FusedCore
    from kcp_tpu_torch.utils.trace import REGISTRY

    cs = _smoke()
    dev = torch.device(device)
    s = SERVING_S
    state, seg, packed, acks = cs.step_case(np.random.default_rng(7), b, s, 1024, torch)
    mesh = cs.smoke_mesh("4", dev)
    one = [tm.state_from_numpy(state, dev), tm.to_device(seg, dev)]
    sh = [shard_state(state, mesh), ShardedTensor.put(tm.to_device(seg, dev), mesh, FLAGS)]

    def step(side, **kw):
        side[0], side[1], _w = tm.reconcile_step_fleet(
            side[0], side[1], tm.to_device(packed, dev), tm.to_device(acks, dev),
            patch_capacity=8192, seg_capacity=8, **kw)

    def median_ms(fn, reps: int = 5) -> float:
        return sorted(cs.time_ms(fn, torch, 20) for _ in range(reps))[reps // 2]

    rec = dict(tree=tree, step_ms=median_ms(lambda: step(one)),
               step_sharded_ms=median_ms(lambda: step(sh, mesh=mesh)))
    loops = (("loop", FusedCore(device=dev, batch_window=0.0005)),
             ("loop_sharded", FusedCore(mesh=mesh, device=dev, batch_window=0.0005)))
    for key, core in loops if seconds > 0 else ():
        before = REGISTRY.snapshot()
        out = asyncio.run(closed_loop(core, b, s, churn=768, seconds=seconds, warmup_ticks=24))
        torch.cuda.synchronize()
        if not out["converged"]:
            raise SystemExit(f"measure: {key} left rows unconverged")
        rec[key] = {k: out[k] for k in ("ticks", "ms_per_tick", "reconciles_per_s",
                                        "convergence_p50_ms", "convergence_p99_ms")}
        rec[key]["phases_ms"] = _phase_means(before, REGISTRY.snapshot())
    # the device's work per step, counted last: a profiler session may
    # slow later host-timed work
    for key, fn in (("step", lambda: step(one)), ("step_sharded", lambda: step(sh, mesh=mesh))):
        _wall, ev = cs.device_profile(lambda: [fn() for _ in range(5)], torch)
        rec[f"{key}_device_events"] = sum(n for n, _us in ev.values()) / 5
        rec[f"{key}_device_ms"] = sum(us for _n, us in ev.values()) / 5 / 1e3
    print(json.dumps(rec))


def ab(trees: list[str], seconds: float, card: str) -> None:
    runs = []
    for tree in trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "measure", tree,
                               str(seconds)], capture_output=True, text=True, timeout=900,
                              cwd=REPO)
        if proc.returncode != 0:
            raise SystemExit(f"ab: {tree} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(rec)
        print(json.dumps(rec))
    for key in ("step_ms", "step_sharded_ms", "step_device_events", "step_device_ms",
                "step_sharded_device_events", "step_sharded_device_ms"):
        print(f"ab {key}: " + ", ".join(f"{os.path.relpath(r['tree'], REPO)} {r[key]:.4f}"
                                        for r in runs) + f" [{card}]")
    for loop in ("loop", "loop_sharded") if seconds > 0 else ():
        for key in ("ms_per_tick", "reconciles_per_s", "convergence_p50_ms", "convergence_p99_ms"):
            print(f"ab {loop} {key}: " + ", ".join(
                f"{os.path.relpath(r['tree'], REPO)} {r[loop][key]:.4f}" for r in runs)
                + f" [{card}]")


#: the timing gates of ``scripts/ci.sh`` that the ``lanes`` probe reads:
#: lane -> (reading's name, how to read it from the lane's JSON line, passes)
LANE_GATES = {
    "admission": (
        ("overhead_pct", lambda r: r["value"], lambda x: x < 5.0),
        ("quiet_p99_ratio", lambda r: r["admission_bench"]["storm"]["quiet_p99_ratio"],
         lambda x: x <= 2.0)),
    "sharded": (
        ("capacity_2", lambda r: r["sharded_bench"]["capacity_speedup"]["2"],
         lambda x: x >= 1.6),),
}


def _lane_run(side: str, lane: str) -> dict:
    """One run of a lane at the CI shape, in a child of its own: the
    reference's ``bench.py`` or the port's ``kcp_tpu_torch.bench``."""
    cs = _smoke()
    knobs = {**cs.STORE_LANES_CI, **cs.HOST_LANES_CI}[lane]
    target = os.path.join(REPO, "bench.py") if side == "reference" else "kcp_tpu_torch.bench"
    env = {k: v for k, v in os.environ.items() if not k.startswith("KCP_")}
    env.update(knobs, PYTHONPATH=REPO)
    with open("/proc/loadavg", encoding="ascii") as f:
        load = f.read().split()[:3]
    code = cs.WRAPPER % (("jax", "jaxlib"), target.rsplit(".", 1)[-1] if side == "port"
                         else target, target, target)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", code, f"--{lane}"], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    rc, report, out, err = cs._exit_report(proc, timeout=600)
    rec = {"side": side, "lane": lane, "rc": rc, "wall_s": round(time.perf_counter() - t0, 2),
           "loadavg_before": load, "report": report}
    lines = [x for x in out.splitlines() if x.startswith("{")]
    if rc != 0 or not lines:
        rec["error"] = err[-1500:]
        return rec
    r = json.loads(lines[-1])
    rec["readings"] = {name: read(r) for name, read, _ok in LANE_GATES[lane]}
    return rec


def lanes(pairs: int, log_path: str = os.devnull) -> None:
    runs = []
    with open(log_path, "a", encoding="utf-8") as log:
        for p in range(pairs):
            for lane in LANE_GATES:
                order = ("reference", "port") if p % 2 == 0 else ("port", "reference")
                for side in order:
                    rec = dict(_lane_run(side, lane), pair=p)
                    runs.append(rec)
                    log.write(json.dumps(rec) + "\n")
                    log.flush()
                    rep = rec["report"] or {}
                    print(f"pair {p} {lane} {side}: rc {rec['rc']} "
                          f"{json.dumps(rec.get('readings'))} {rec['wall_s']} s, load "
                          f"{' '.join(rec['loadavg_before'])}, jax packages "
                          f"{sorted({m.split('.')[0] for m in rep.get('loaded', [])})}, {rep.get('full_collections')} full "
                          f"collections ({rep.get('full_collection_ms')} ms), cpu "
                          f"{rep.get('cpu_s')} s" + (f"; {rec['error'][-300:]}"
                                                     if "error" in rec else ""), flush=True)
    for lane, gates in LANE_GATES.items():
        for side in ("reference", "port"):
            got = [r for r in runs if r["lane"] == lane and r["side"] == side]
            for name, _read, ok in gates:
                vals = [r["readings"][name] for r in got if "readings" in r]
                print(f"{lane} {side} {name}: {sum(not ok(v) for v in vals)} of {len(vals)} "
                      f"miss ({len(got) - len(vals)} runs failed); readings "
                      f"{json.dumps(vals)}")


def main(argv: list[str]) -> None:
    if not argv or argv[0] not in ("host", "sweep", "readings", "ab", "measure", "lanes",
                                   "host-calls", "readings-in", "wire"):
        raise SystemExit(__doc__)
    if argv[0] == "measure":
        measure(argv[1], float(argv[2]))
        return
    if argv[0] == "host-calls":
        host_calls(argv[1])
        return
    if argv[0] == "readings-in":  # one TREE of ``readings REPEATS TREE ...``
        _use_tree(argv[1])
        argv = ["readings", argv[2]]
    if argv[0] == "lanes":
        from kcp_tpu_torch.bench import card_line

        print(card_line() or "no nvidia-smi")
        lanes(int(argv[1]) if len(argv) > 1 else 10, *argv[2:3])
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_probe: no CUDA card")
    card = _smoke().card_line()
    print(card)
    if argv[0] == "host":
        host_ab(argv[1:], card) if argv[1:] else host(card)
    elif argv[0] == "sweep":
        sweep(card)
    elif argv[0] == "wire":
        wire(card)
    elif argv[0] == "readings":
        repeats = int(argv[1]) if len(argv) > 1 else 5
        readings_ab(argv[2:], repeats) if argv[2:] else readings(card, repeats)
    else:
        ab(argv[1:], float(os.environ.get("KCP_PROBE_SECONDS", "8")), card)


if __name__ == "__main__":
    main(sys.argv[1:])
