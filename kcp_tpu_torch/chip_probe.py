"""Probes of the port on a CUDA card that ``chip_smoke.py`` does not run.

Run from the repo root on a card:

- ``python3 -m kcp_tpu_torch.chip_probe host`` — the host cost of one
  ``decide_and_match`` call at the serving shape, 3-output and fleet
  form, whole and piece by piece (check, tile plan, output allocation,
  device and stream lookup), before and after a torch.profiler session;
- ``python3 -m kcp_tpu_torch.chip_probe sweep`` — the fleet form's device
  time at the serving shape under other tile plans (blocks per SM, stage
  bytes, ring depth), each checked against the plain version;
- ``python3 -m kcp_tpu_torch.chip_probe ab TREE [TREE ...]`` — for each
  TREE (a checkout of this repo, say a parent commit unpacked with
  ``git archive`` into a git-ignored directory), in the order given and
  each in a process of its own: chip_smoke.py's phase-4 step, unsharded
  and over mesh ``"4"`` (CUDA events, upload included; the median of 5
  runs of 20 steps), the phase-5/5b closed loops and their tick-phase
  means (``KCP_PROBE_SECONDS`` each, 8 by default; 0 skips them), and
  last each step's device events and device time (profiler). Give the
  trees as parent, change, change, parent to compare two commits on one
  card.

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


def host(card: str) -> None:
    import numpy as np
    import torch

    from kcp_tpu_torch.ops import cuda_kernels as ck

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
        "_tile_plan": lambda: ck._tile_plan(b, SERVING_S, 1, 8, True, ptrs, True,
                                            cs.SEG_CAPACITY, sms),
        "torch.zeros([8])": lambda: torch.zeros(8, dtype=torch.int32, device=dev),
        "torch.empty([B])": lambda: torch.empty(b, dtype=torch.uint8, device=dev),
        "device + stream": stream,
        "_launch (fleet, counts given)": lambda: ck._launch(*case, counts, seg, seg_counts),
    }
    for when in ("before any profiler session", "after a profiler session"):
        if when.startswith("after"):
            cs.kernel_device_ms(lambda: ck.decide_and_match(*case, **forms["fleet"]), torch)
        for form, kw in forms.items():
            enq, drained = _host_us(lambda: ck.decide_and_match(*case, **kw), torch)
            ev = cs.time_ms(lambda: ck.decide_and_match(*case, **kw), torch, 50)
            print(f"host [{when}] decide_and_match {form}: {enq:.1f} us per call on the host, "
                  f"{drained:.1f} us with the device drained, {ev * 1e3:.1f} us per "
                  f"back-to-back call (events) [{card}]")
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
            ck._plan.cache_clear()
            got = ck.decide_and_match(*case, **kw)
            if any(not torch.equal(g, w) for g, w in zip(got, want)):
                raise SystemExit(f"sweep: plan {ck.last_plan} differs from the plain version")
            ms = cs.kernel_device_ms(lambda: ck.decide_and_match(*case, **kw), torch)
            shown = (f"{ms:.4f} ms ({bound_ms / ms * 100:.1f}% of the bound rate)" if ms
                     else "not measured (profiler saw no device time)")
            print(f"sweep [serving, fleet form]: {bps} block(s) per SM, "
                  f"{cs.plan_text(ck.last_plan)}: equal; kernel {shown} on the device"
                  f"{' (default plan)' if (bps, target, stages) == default else ''} [{card}]")
    finally:
        ck.BLOCKS_PER_SM, ck.STAGE_TARGET, ck.MAX_STAGES = default
        ck._plan.cache_clear()


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
    tree = os.path.abspath(tree)
    sys.path[:] = [tree] + [p for p in sys.path[1:]
                            if os.path.abspath(p or ".") not in (REPO, tree)]
    import numpy as np
    import torch

    import kcp_tpu_torch
    from kcp_tpu_torch.bench import closed_loop
    from kcp_tpu_torch.models import reconcile_model as tm
    from kcp_tpu_torch.parallel.mesh import FLAGS, ShardedTensor, shard_state
    from kcp_tpu_torch.syncer.core import FusedCore
    from kcp_tpu_torch.utils.trace import REGISTRY

    if not kcp_tpu_torch.__file__.startswith(tree + os.sep):
        raise SystemExit(f"measure: loaded {kcp_tpu_torch.__file__}, not the package in {tree}")
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


def main(argv: list[str]) -> None:
    if not argv or argv[0] not in ("host", "sweep", "ab", "measure"):
        raise SystemExit(__doc__)
    if argv[0] == "measure":
        measure(argv[1], float(argv[2]))
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_probe: no CUDA card")
    card = _smoke().card_line()
    print(card)
    if argv[0] == "host":
        host(card)
    elif argv[0] == "sweep":
        sweep(card)
    else:
        ab(argv[1:], float(os.environ.get("KCP_PROBE_SECONDS", "8")), card)


if __name__ == "__main__":
    main(sys.argv[1:])
