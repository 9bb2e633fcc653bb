#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``kcp_tpu_torch``) on one NVIDIA card.

Run from the repo root with no arguments: ``python3 chip_smoke.py``.
Phases, each fatal on failure:

1. device — a CUDA card must be present; prints its name and power limit;
2. build — compiles the port's CUDA kernel from ``kcp_tpu_torch/csrc``
   (ptxas registers, stack and spills);
3. kernel vs plain — ``decide_and_match`` against its plain PyTorch
   version on the card, exact equality, at the serving shape
   (B=131,072, S=64, per-row mask, L=1, C=8) in its 3-output form and in
   its fleet form (seeded segment ids, negative and out of range among
   them, seg_capacity 8), the model example shape (B=8,192, S=64,
   bucket-wide mask, L=8, C=64) and a ragged B=131,071; for each, the
   tile plan (the serving shape must take the bulk path), back-to-back
   call time, plain time and the bound;
3b. sharded kernel vs plain — ``decide_and_match_sharded`` over a
   4-shard mesh (``"4"``, fleet form) and a slot-sharded ``"2x2"`` mesh,
   both on repeated ``cuda:0`` shards, at the serving shape, plus a
   ragged B=131,071 over ``"4"`` (fleet form): exact equality with the
   unsharded plain version, back-to-back call time, plain time, bound
   and launches per call;
4. device step vs CPU step — ``reconcile_step_fleet`` on the card and on
   the CPU from one seeded state and wire at B=131,072, S=64 (acks with
   padding, mask and segment stamps, then an overflow tick): the wires
   must be byte-equal, and the card step may call no ``index_add_`` (the
   kernel's fleet form counts the segments);
4b. sharded step vs unsharded card step — the same two ticks through a
   4-shard state on the card: byte-equal wires, no ``index_add_``;
5. main path — a closed churn loop through the port's ``FusedCore``
   (fleet batch on, pipeline "double") at 131,072 rows x 64 slots:
   every churned row must converge, the kernel's launch count must cover
   every tick, and no step may fail or quarantine a row;
5b. main path, sharded — the same loop with ``FusedCore(mesh="4" over
   cuda:0)``: every row converges, the sharded kernel launches 4 times a
   tick, nothing is quarantined;
5c. after the main path, what needs the profiler (a profiler session
   can leave later launches slower on the host, so none runs before the
   host-clock readings of phases 5 and 5b): the device time of every phase-3 and 3b case and
   its share of the bound rate; the ``index_add_`` checks of 4 and 4b;
   then a short profiled loop (device busy share, top device events, and
   how many ``index_add_`` kernels ran: none is expected);
6. engine path — ``start_syncer`` over two ``LogicalStore``s on the card,
   without a mesh and on ``"4"``: 16,384 labelled ConfigMaps across 64
   namespaces, then an update, a delete and a downstream status write
   that must reach upstream; both runs must end with equal dumps.

The line before the last is the kernels' JSON record, every number in
it measured in this run (``bound_ms`` computed from this run's inputs);
the last line is ``{"ok": true, "device": {...}}``. Without a card the
script exits 2 before printing any result.
"""

from __future__ import annotations

import asyncio
import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
ALU_OPS_PER_S = 67e12  # H100 SXM non-tensor peak (float32 table rate)
SERVING = dict(b=131072, s=64, l=1, c=8, per_row=True)
SEG_CAPACITY = 8
# device ms of the kernel before its redesign at the serving shape, as
# recorded in PERF.md §6: printed for reference on a line of their own,
# never in the kernels record
RECORDED_EARLIER_MS = {"decide_and_match": 0.0661, "decide_and_match_sharded": 0.0787}
SMOKE_SHARDS = 4  # row shards of the smoke meshes, all on cuda:0
ENGINE_OBJECTS = 16384  # phase 6 (cut from 131,072 for the time limit)
ENGINE_NAMESPACES = 64


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def kernel_case(rng, b, s, l, c, per_row, torch, dev):
    """Seeded inputs with a few percent of dirty, created and deleted
    rows, and label hashes from a small alphabet so selectors hit."""
    up = rng.integers(1, 2**32, (b, s), dtype=np.uint32)
    down = up.copy()
    spec = rng.random(b) < 0.03
    down[spec, 0] ^= 1
    stat = rng.random(b) < 0.02
    down[stat, s - 1] ^= 1
    upe = rng.random(b) >= 0.02  # deleted upstream
    dne = rng.random(b) >= 0.02  # not yet created downstream
    if per_row:
        mask = np.zeros((b, s), bool)
        mask[:, -max(1, s // 8):] = True
        mask[rng.random(b) < 0.1] = False  # rows of another vocabulary
    else:
        mask = np.zeros(s, bool)
        mask[-max(1, s // 8):] = True
    pair = rng.integers(1, 16, (b, l), dtype=np.uint32)
    sel = rng.integers(1, 16, c, dtype=np.uint32)

    def t(a):
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(dev)

    return tuple(t(a) for a in (up, upe, down, dne, mask, pair, sel))


def segments(rng, b, torch, dev):
    """Seeded segment ids: in range, negative (from the end and beyond it),
    out of range and SEG_NONE."""
    seg = rng.integers(-2 * SEG_CAPACITY - 1, 2 * SEG_CAPACITY + 2, b).astype(np.int32)
    seg[rng.random(b) < 0.05] = 0xFFFF
    return torch.from_numpy(seg).to(dev)


def bound(case, outs, shards: int = 1) -> tuple[float, str, int]:
    """Least time for the call: bytes (each input read once, each output
    written once) over the HBM rate vs operations over the ALU rate.
    ``case`` may end with the fleet form's seg_ids, ``outs`` with its
    segment counts. A sharded call also reads the replicated selectors
    and writes its [C] (and [cap]) partial counts once per shard."""
    up, _upe, _down, _dne, _mask, pair, sel = case[:7]
    nbytes = sum(x.numel() * x.element_size() for x in (*case, *outs))
    partial = sum(x.numel() * x.element_size() for x in outs[2:])
    nbytes += (shards - 1) * (sel.numel() * sel.element_size() + partial)
    b, s = up.shape
    ops = 3 * b * s + 2 * b * pair.shape[1] * sel.shape[0] + 4 * b * (len(case) > 7)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            nbytes)


def time_ms(fn, torch, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, torch) -> tuple[float, dict]:
    """Run ``fn()`` under torch.profiler: (wall s, {device event name:
    (count, device us)}). Empty when the profiler sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.device_time_total > 0:
            events[e.key] = (e.count, e.device_time_total)
    return wall, events


def step_case(rng, b, s, d, torch):
    """A seeded fleet state + wire: per-row masks, deltas, acks with -1
    padding, mask stamps carrying segment ids."""
    from kcp_tpu_torch.models import reconcile_model as tm

    up = rng.integers(1, 2**32, (b, s), dtype=np.uint32)
    down = up.copy()
    down[rng.random(b) < 0.004, 0] ^= 1
    mask = np.zeros((b, s), bool)
    mask[:, -s // 8:] = True
    r, p = 64, 8
    state = tm.ReconcileState(
        up_vals=up, up_exists=rng.random(b) >= 0.01, down_vals=down,
        down_exists=rng.random(b) >= 0.01, status_mask=mask,
        replicas=rng.integers(0, 100, r).astype(np.int32),
        avail=rng.random((r, p)) < 0.9, current=np.zeros((r, p), np.int32),
        pair_hashes=np.zeros((b, 1), np.uint32), sel_hashes=np.zeros(8, np.uint32))
    seg = rng.integers(0, 8, b).astype(np.int32)
    seg[rng.random(b) < 0.05] = tm.SEG_NONE
    deltas = tm.example_deltas(b=b, s=s, d=d, seed=int(rng.integers(1 << 30)))
    stamps = np.zeros((32, s + 2), np.uint32)
    stamps[:, s - 8:] = 1
    stamps[:, s] = rng.choice(b, 32, replace=False)
    stamps[:, s + 1] = (4 | tm.MASK_STAMP_BIT
                        | (rng.integers(0, 8, 32).astype(np.uint32) << tm.SEG_SHIFT))
    packed = np.concatenate([tm.pack_deltas(deltas), stamps])
    touched = set(deltas.idx[deltas.valid & ~deltas.side].tolist())
    free = np.array([i for i in rng.choice(b, 2048, replace=False) if i not in touched])
    acks = np.full(8192, -1, np.int32)
    acks[:512] = free[:512]
    return state, seg, packed, acks


def smoke_mesh(spec: str, dev):
    """A smoke mesh: ``spec`` over ``dev`` repeated (every shard its own
    allocation on the one card)."""
    from kcp_tpu_torch.parallel.mesh import mesh_from_spec

    return mesh_from_spec(spec, devices=[dev] * SMOKE_SHARDS)


def kernel_device_ms(fn, torch, calls: int = 20) -> float | None:
    """The kernel's device time per call of ``fn`` (profiler; every launch
    of the call summed, so a sharded call counts all its shards), or None
    when the profiler sees no device time."""
    _wall, ev = device_profile(lambda: [fn() for _ in range(calls)], torch)
    dev_us = [us for k, (_n, us) in ev.items() if "decide_match_kernel" in k]
    return sum(dev_us) / calls / 1e3 if dev_us else None


def device_times(timed: list, card: str) -> None:
    """The kernels' device times, read with the profiler after the main
    path has run (a profiler session can leave later launches slower on
    the host, which would skew the main path's host-clock readings).
    ``timed`` holds (label, call, bound ms, back-to-back call ms, record
    or None) from phases 3 and 3b; each record's ``ms`` is set here, to
    the back-to-back call time where the profiler sees no device time."""
    import torch

    for label, fn, bound_ms, call_ms, record in timed:
        dev_ms = kernel_device_ms(fn, torch)
        ms = dev_ms if dev_ms is not None else call_ms
        if record is not None:
            record["ms"] = ms
        print(f"device time {label}: {ms:.4f} ms "
              f"({'profiler' if dev_ms is not None else 'events: profiler saw no device time'}), "
              f"{bound_ms / ms * 100:.1f}% of the bound rate [{card}]")


def plan_text(plan) -> str:
    return (f"plan T={plan.tile} stages={plan.stages} grid={plan.grid} "
            f"{'bulk' if plan.bulk else 'plain'} (plain-path rows {plan.tail_rows}, "
            f"{plan.smem} B shared per block)")


def kernel_phase(rng, torch, dev, card: str, timed: list) -> dict:
    """3. decide_and_match against the plain version at four cases;
    returns the record of the fleet form at the serving shape (the form
    the main path launches) and adds each case to ``timed``."""
    from kcp_tpu_torch.models import reconcile_model as tm
    from kcp_tpu_torch.ops import cuda_kernels
    from kcp_tpu_torch.ops.cuda_kernels import decide_and_match, decide_and_match_plain

    shapes = [
        ("serving", SERVING, False),
        ("serving", SERVING, True),
        ("example", dict(b=8192, s=64, l=8, c=64, per_row=False), False),
        ("ragged", dict(b=131071, s=64, l=1, c=8, per_row=True), True),
    ]
    record = None
    for name, sh, fleet in shapes:
        if name == "example":
            st = tm.example_state(b=sh["b"], s=sh["s"], l=sh["l"], c=sh["c"], seed=3,
                                  dirty_frac=0.03)
            upe = rng.random(sh["b"]) >= 0.02
            dne = rng.random(sh["b"]) >= 0.02
            pair = np.asarray(st.pair_hashes).copy()
            pair[rng.random(sh["b"]) < 0.3, 0] = st.sel_hashes[0]
            case = tuple(tm.to_device(a, dev) for a in (
                st.up_vals, upe, st.down_vals, dne, st.status_mask, pair, st.sel_hashes))
        else:
            case = kernel_case(rng, sh["b"], sh["s"], sh["l"], sh["c"], sh["per_row"],
                               torch, dev)
        kw = {}
        if fleet:
            kw = dict(seg_ids=segments(rng, sh["b"], torch, dev), seg_capacity=SEG_CAPACITY)
        got = decide_and_match(*case, **kw)
        torch.cuda.synchronize()
        plan = cuda_kernels.last_plan
        want = decide_and_match_plain(*case, **kw)
        torch.cuda.synchronize()
        err = 0
        for label, g, w in zip(("decision", "upsync", "counts", "seg_counts"), got, want):
            if g.dtype != w.dtype or g.shape != w.shape:
                fail(f"{name}: {label} is {g.dtype}{tuple(g.shape)}, plain "
                     f"{w.dtype}{tuple(w.shape)}")
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
        if err:
            fail(f"{name}: kernel differs from the plain version (max abs err {err})")
        if int(want[0].ne(0).sum()) == 0 or int(want[2].sum()) == 0 or (
                fleet and int(want[3].sum()) == 0):
            fail(f"{name}: vacuous case (no decisions, selector hits or segment counts)")
        if name == "serving" and not (plan.bulk and plan.tail_rows == 0):
            fail(f"serving shape did not take the bulk path: {plan}")
        call_ms = time_ms(lambda: decide_and_match(*case, **kw), torch, 50)
        plain_ms = time_ms(lambda: decide_and_match_plain(*case, **kw), torch, 10)
        inputs = (*case, kw["seg_ids"]) if fleet else case
        bound_ms, bound_by, nbytes = bound(inputs, got)
        label = (f"decide_and_match [{name}{', fleet form' if fleet else ''}: "
                 f"B={sh['b']} S={sh['s']} mask={'row' if sh['per_row'] else 'bucket'} "
                 f"L={sh['l']} C={sh['c']}{f' cap={SEG_CAPACITY}' if fleet else ''}]")
        # the back-to-back call time is the wrapper's host cost where that
        # is longer than the kernel; the kernel's own time comes later
        print(f"kernel {label}: equal (tolerance: exact); {plan_text(plan)}; "
              f"{call_ms:.4f} ms per back-to-back call (events), plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B); library call: "
              f"none (no single PyTorch call computes this function) [{card}]")
        if name == "serving" and fleet:
            record = dict(max_abs_err=err, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
        timed.append((label, lambda case=case, kw=kw: decide_and_match(*case, **kw),
                      bound_ms, call_ms, record if name == "serving" and fleet else None))
        torch.cuda.synchronize()
    return record


def sharded_kernel_phase(rng, torch, dev, card: str, timed: list) -> dict:
    """3b. decide_and_match_sharded against the unsharded plain version;
    returns the record of the serving shape over "4" and adds each case
    to ``timed``."""
    from kcp_tpu_torch.ops.cuda_kernels import (
        decide_and_match,
        decide_and_match_plain,
        decide_and_match_sharded,
    )
    from kcp_tpu_torch.parallel import mesh as pm

    record = None
    for label, spec, sh, fleet in (("serving", "4", SERVING, True),
                                   ("serving", "2x2", SERVING, False),
                                   ("ragged", "4", dict(SERVING, b=131071), True)):
        mesh = smoke_mesh(spec, dev)
        rf = pm.row_factor(mesh)
        case = kernel_case(rng, sh["b"], sh["s"], sh["l"], sh["c"], sh["per_row"], torch, dev)
        layouts = [pm.ROWS, pm.FLAGS, pm.ROWS, pm.FLAGS, pm.ROWS, pm.FLAGS, pm.REPLICATED]
        seg = dict(seg_capacity=SEG_CAPACITY) if fleet else {}
        if fleet:
            case = (*case, segments(rng, sh["b"], torch, dev))
            layouts.append(pm.FLAGS)
        args = [pm.ShardedTensor.put(x, mesh, lay) for x, lay in zip(case, layouts)]
        before = decide_and_match_sharded.launches
        got = decide_and_match_sharded(mesh, *args, **seg)
        torch.cuda.synchronize()
        per_call = decide_and_match_sharded.launches - before
        if dev.type == "cuda" and per_call != rf:
            fail(f"sharded {label} over {spec}: {per_call} launches for {rf} row shards")
        got = (got[0].full(), got[1].full(), *got[2:])
        want = decide_and_match_plain(*case, **seg)
        err = 0
        for name, g, w in zip(("decision", "upsync", "counts", "seg_counts"), got, want):
            if g.dtype != w.dtype or g.shape != w.shape:
                fail(f"sharded {label} over {spec}: {name} is {g.dtype}{tuple(g.shape)}, "
                     f"plain {w.dtype}{tuple(w.shape)}")
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
        if err:
            fail(f"sharded {label} over {spec}: differs from the plain version "
                 f"(max abs err {err})")
        if int(want[0].ne(0).sum()) == 0 or int(want[2].sum()) == 0:
            fail(f"sharded {label} over {spec}: vacuous case")
        call_ms = time_ms(lambda: decide_and_match_sharded(mesh, *args, **seg), torch, 30)
        one_ms = time_ms(lambda: decide_and_match(*case, **seg), torch, 30)
        plain_ms = time_ms(lambda: decide_and_match_plain(*case, **seg), torch, 10)
        bound_ms, bound_by, nbytes = bound(case, want, shards=rf)
        text = (f"decide_and_match_sharded [{label}: B={sh['b']} S={sh['s']} mask=row "
                f"L={sh['l']} C={sh['c']}{', fleet form' if fleet else ''}, mesh {spec} on "
                f"{rf} row shards x {pm.slot_factor(mesh)} slot shards of {dev}]")
        print(f"kernel {text}: equal (tolerance: exact); {per_call} launches per call; "
              f"{call_ms:.4f} ms per back-to-back call (events; unsharded kernel "
              f"{one_ms:.4f} ms in this run), plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms by {bound_by} ({nbytes} B); library call: none [{card}]")
        if label == "serving" and spec == "4":
            record = dict(max_abs_err=err, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
        timed.append((f"{text}, the {rf} launches summed",
                      lambda mesh=mesh, args=args, seg=seg:
                      decide_and_match_sharded(mesh, *args, **seg),
                      bound_ms, call_ms, record if label == "serving" and spec == "4" else None))
        torch.cuda.synchronize()
    return record


def assert_no_index_add(step, what: str) -> None:
    """Run ``step()`` once under the profiler's CPU activity: the fleet
    step must call no ``index_add_`` (its segment count is the kernel's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
        torch.cuda.synchronize()
    if any(e.key == "aten::index_add_" for e in prof.key_averages()):
        fail(f"{what}: the fleet step called index_add_")


def sharded_step_phase(torch, dev, card: str, b: int = 131072, s: int = 64):
    """4b. reconcile_step_fleet over a 4-shard state against the unsharded
    step on the same card: byte-equal wires, the phase-4 ticks. Returns
    the sharded step, for the ``index_add_`` check after the main path."""
    from kcp_tpu_torch.models import reconcile_model as tm
    from kcp_tpu_torch.parallel.mesh import FLAGS, ShardedTensor, shard_state

    mesh = smoke_mesh("4", dev)
    state, seg, packed, acks = step_case(np.random.default_rng(7), b, s, 1024, torch)
    one = [tm.state_from_numpy(state, dev), tm.to_device(seg, dev)]
    sh = [shard_state(state, mesh), ShardedTensor.put(tm.to_device(seg, dev), mesh, FLAGS)]
    for tick, cap in enumerate((8192, 256)):
        if tick:
            _st, _sg, packed, acks = step_case(np.random.default_rng(8), b, s, 1024, torch)
        outs = []
        for side, kw in ((one, {}), (sh, {"mesh": mesh})):
            side[0], side[1], wire = tm.reconcile_step_fleet(
                side[0], side[1], tm.to_device(packed, dev), tm.to_device(acks, dev),
                patch_capacity=cap, seg_capacity=8, **kw)
            outs.append(tm.wire_to_numpy(wire))
        torch.cuda.synchronize()
        if outs[0].tobytes() != outs[1].tobytes():
            diff = np.flatnonzero(outs[0] != outs[1])
            fail(f"sharded step tick {tick}: wire != unsharded wire at {diff[:10].tolist()}")
        if bool(outs[0][1]) != (cap == 256):
            fail(f"sharded step tick {tick}: overflow flag {bool(outs[0][1])} at "
                 f"capacity {cap}")

    def step(side, **kw):
        side[0], side[1], _w = tm.reconcile_step_fleet(
            side[0], side[1], tm.to_device(packed, dev), tm.to_device(acks, dev),
            patch_capacity=8192, seg_capacity=8, **kw)

    one_ms = time_ms(lambda: step(one), torch, 20)
    sh_ms = time_ms(lambda: step(sh, mesh=mesh), torch, 20)
    print(f"sharded step: reconcile_step_fleet over mesh 4 ({SMOKE_SHARDS} row shards of "
          f"{dev}) wire == unsharded card wire, 2 ticks at B={b} S={s} (acks, mask+segment "
          f"stamps, overflow tick); device step {sh_ms:.4f} ms sharded vs {one_ms:.4f} ms "
          f"unsharded, incl. upload [{card}]")
    return lambda: step(sh, mesh=mesh)


def main_path_phase(core, torch, counter, per_tick: int, card: str, label: str,
                    rows: int = 131072, seconds: float = 10.0) -> tuple[dict, int]:
    """5 / 5b. One closed churn loop through ``core``; the kernel's launch
    count (``counter.launches``, zeroed just before) must be ``per_tick``
    per fleet tick. Returns the loop's readings and the launches."""
    from kcp_tpu_torch.bench import closed_loop
    from kcp_tpu_torch.utils.trace import REGISTRY

    if not core.fleet_mode or core.pipeline != "double":
        fail(f"{label}: defaults changed: fleet={core.fleet_mode} pipeline={core.pipeline}")
    fail0 = REGISTRY.counter("fused_step_failures_total").value
    quar0 = REGISTRY.counter("quarantined_rows").value
    counter.launches = 0
    out = asyncio.run(closed_loop(core, rows, 64, churn=768, seconds=seconds,
                                  warmup_ticks=24))
    torch.cuda.synchronize()
    launches = counter.launches
    ticks_all = core._fleet.stats["ticks"]
    if not out["converged"]:
        fail(f"{label}: rows left unconverged after stop()")
    if REGISTRY.counter("fused_step_failures_total").value != fail0:
        fail(f"{label}: fused step failures")
    if REGISTRY.counter("quarantined_rows").value != quar0:
        fail(f"{label}: rows quarantined")
    if core.device.type == "cuda" and (launches != per_tick * ticks_all or launches == 0):
        fail(f"{label}: {launches} kernel launches for {ticks_all} ticks "
             f"(want {per_tick} per tick)")
    print(f"{label}: FusedCore fleet/double, rows={out['rows']} slots={out['slots']} "
          f"tenants~{out['rows'] // 13} churn/tick={out['churn_per_tick']}: "
          f"{out['ticks']} ticks in {out['seconds']:.2f} s ({out['ms_per_tick']:.3f} "
          f"ms/tick), reconciles/s {out['reconciles_per_s']:.0f}, convergence p50 "
          f"{out['convergence_p50_ms']:.3f} ms p99 {out['convergence_p99_ms']:.3f} ms, "
          f"patch rows/tick {out['patch_rows_per_tick']:.1f}, warmup "
          f"{out['warmup_ticks']} ticks in {out['warmup_s']:.2f} s; kernel launches "
          f"{launches} for {ticks_all} ticks; all rows converged; work queue "
          f"{type(core.controller.queue).__name__} [{card}]")
    return out, launches


def _cm(name: str, ns: str, data: dict) -> dict:
    from kcp_tpu_torch.syncer.engine import CLUSTER_LABEL

    return {"apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": name, "namespace": ns, "labels": {CLUSTER_LABEL: "c1"}},
            "data": data}


async def _eventually(pred, what: str, timeout: float) -> None:
    deadline = time.perf_counter() + timeout
    while True:
        try:
            if pred():
                return
        except Exception:  # noqa: BLE001 — not there yet
            pass
        if time.perf_counter() > deadline:
            fail(f"engine path: {what} not reached in {timeout:.0f} s")
        await asyncio.sleep(0.05)


async def engine_run(dev, mesh, n: int, n_ns: int) -> tuple[dict, dict, dict]:
    """6. One sync scenario through ``start_syncer`` over two stores
    (test_mesh_serving.drive_scenario at ``n`` objects): final
    downstream dump, upstream statuses, and timings."""
    from kcp_tpu_torch.client import Client
    from kcp_tpu_torch.store import LogicalStore
    from kcp_tpu_torch.syncer import start_syncer

    up, down = Client(LogicalStore(), "t"), Client(LogicalStore(), "p")
    t0 = time.perf_counter()
    syncer = await start_syncer(up, down, ["configmaps"], "c1", mesh=mesh, device=dev)
    for i in range(n):
        up.create("configmaps", _cm(f"cm-{i}", f"ns-{i % n_ns}", {"v": str(i)}))
    t_created = time.perf_counter()
    await _eventually(lambda: len(down.list("configmaps")[0]) == n, "initial sync", 600)
    t_synced = time.perf_counter()
    obj = up.get("configmaps", "cm-3", "ns-3")
    obj["data"] = {"v": "updated"}
    up.update("configmaps", obj)
    up.delete("configmaps", "cm-7", "ns-7")
    await _eventually(lambda: down.get("configmaps", "cm-3", "ns-3")["data"]
                      == {"v": "updated"}, "update downsync", 120)
    await _eventually(lambda: len(down.list("configmaps")[0]) == n - 1, "delete", 120)
    dobj = down.get("configmaps", "cm-5", "ns-5")
    dobj["status"] = {"ready": True}
    down.update_status("configmaps", dobj)
    await _eventually(lambda: up.get("configmaps", "cm-5", "ns-5").get("status")
                      == {"ready": True}, "status upsync", 120)
    t_done = time.perf_counter()
    eng = syncer.engines[0]
    state = eng.core._fleet._state
    sharded = type(state.up_vals).__name__
    dump = {f"{o['metadata']['namespace']}/{o['metadata']['name']}": (o["data"], o.get("status"))
            for o in down.list("configmaps")[0]}
    up_status = {f"{o['metadata']['namespace']}/{o['metadata']['name']}": o.get("status")
                 for o in up.list("configmaps")[0]}
    ticks = eng._section.bucket.stats["ticks"]
    await syncer.stop()
    return dump, up_status, dict(create_s=t_created - t0, sync_s=t_synced - t0,
                                 scenario_s=t_done - t_synced, ticks=ticks, state=sharded)


def engine_phase(torch, dev, card: str, n: int = ENGINE_OBJECTS,
                 n_ns: int = ENGINE_NAMESPACES) -> None:
    """6. start_syncer on the card, without a mesh and on "4": equal
    dumps, and each run went through its kernel."""
    from kcp_tpu_torch.ops.cuda_kernels import decide_and_match, decide_and_match_sharded

    runs = []
    for spec, counter, per in ((None, decide_and_match, 1),
                               ("4", decide_and_match_sharded, SMOKE_SHARDS)):
        mesh = None if spec is None else smoke_mesh(spec, dev)
        counter.launches = 0
        dump, up_status, t = asyncio.run(engine_run(dev, mesh, n, n_ns))
        torch.cuda.synchronize()
        launches = counter.launches
        if dev.type == "cuda" and (launches == 0 or launches % per):
            fail(f"engine path (mesh {spec}): {launches} kernel launches")
        if len(dump) != n - 1 or up_status.get("ns-5/cm-5") != {"ready": True}:
            fail(f"engine path (mesh {spec}): wrong final state")
        runs.append((dump, up_status))
        print(f"engine path: start_syncer mesh={spec or 'none'} on {dev}: {n} ConfigMaps in "
              f"{n_ns} namespaces created in {t['create_s']:.2f} s, all synced "
              f"{t['sync_s']:.2f} s after start; update + delete + status upsync converged "
              f"in {t['scenario_s']:.2f} s; {t['ticks']} ticks, resident state "
              f"{t['state']}, kernel launches {launches} [{card}]")
    if runs[0] != runs[1]:
        fail("engine path: the sharded run's dumps differ from the unsharded run's")
    print(f"engine path: final dumps equal with and without the mesh ({n - 1} objects)")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card: nothing to run", file=sys.stderr)
        sys.exit(2)
    from kcp_tpu_torch.bench import closed_loop
    from kcp_tpu_torch.models import reconcile_model as tm
    from kcp_tpu_torch.ops import cuda_kernels
    from kcp_tpu_torch.ops.cuda_kernels import decide_and_match, decide_and_match_sharded
    from kcp_tpu_torch.syncer.core import FusedCore
    from kcp_tpu_torch.utils.trace import REGISTRY

    t_all = time.perf_counter()
    dev = torch.device("cuda")
    # ---- 1. device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)  # name, power limit: as nvidia-smi prints them
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} devices {torch.cuda.device_count()}")

    # ---- 2. build
    t0 = time.perf_counter()
    lib = cuda_kernels.build()
    print(f"build: {lib} in {time.perf_counter() - t0:.2f} s")
    if cuda_kernels.build_info.get("log"):
        for line in cuda_kernels.build_info["log"].splitlines():
            if "registers" in line or "Compiling" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    # ---- 3. kernel vs plain, exact equality; the tile plans. No profiler
    #          runs before the main path (5, 5b): the kernels' device
    #          times and the index_add_ checks come after it.
    timed = []
    record = kernel_phase(np.random.default_rng(2024), torch, dev, card, timed)

    # ---- 3b. the sharded kernel against the plain version
    record_sharded = sharded_kernel_phase(np.random.default_rng(2025), torch, dev, card, timed)

    # ---- 4. device step vs CPU step, byte-equal wires
    b, s = 131072, 64
    state, seg, packed, acks = step_case(np.random.default_rng(7), b, s, 1024, torch)
    gpu = [tm.state_from_numpy(state, dev), tm.to_device(seg, dev)]
    cpu = [tm.state_from_numpy(state, "cpu"), tm.to_device(seg, "cpu")]
    for tick, cap in enumerate((8192, 256)):
        if tick:  # a second wire on the carried state; capacity forces overflow
            _st, _sg, packed, acks = step_case(np.random.default_rng(8), b, s, 1024, torch)
        outs = []
        for side, d in ((gpu, dev), (cpu, torch.device("cpu"))):
            side[0], side[1], wire = tm.reconcile_step_fleet(
                side[0], side[1], tm.to_device(packed, d), tm.to_device(acks, d),
                patch_capacity=cap, seg_capacity=8)
            outs.append(tm.wire_to_numpy(wire))
        torch.cuda.synchronize()
        if outs[0].tobytes() != outs[1].tobytes():
            diff = np.flatnonzero(outs[0] != outs[1])
            fail(f"step tick {tick}: card wire != CPU wire at {diff[:10].tolist()}")
        if bool(outs[0][1]) != (cap == 256):
            fail(f"step tick {tick}: overflow flag {bool(outs[0][1])} at capacity {cap}")

    def card_step():
        tm.reconcile_step_fleet(gpu[0], gpu[1], tm.to_device(packed, dev),
                                tm.to_device(acks, dev), patch_capacity=8192, seg_capacity=8)

    step_ms = time_ms(card_step, torch, 20)
    print(f"step: reconcile_step_fleet card wire == CPU wire, 2 ticks at B={b} S={s} "
          f"(acks, mask+segment stamps, overflow tick); device step {step_ms:.4f} ms "
          f"incl. upload [{card}]")
    del cpu

    # ---- 4b. sharded step vs unsharded card step, byte-equal wires
    sharded_step = sharded_step_phase(torch, dev, card, b, s)

    # ---- 5. main path: closed loop through FusedCore, fleet on, double
    core = FusedCore(batch_window=0.0005)
    _out, launches = main_path_phase(core, torch, decide_and_match, 1, card, "main path")
    snap = REGISTRY.snapshot()
    phases = " ".join(
        f"{k[6:-8]}={v['mean'] * 1e3:.3f}ms" for k, v in sorted(snap.items())
        if k.startswith("fused_") and k.endswith("_seconds") and isinstance(v, dict)
        and v["count"])
    print(f"tick phases (mean): {phases}")

    # ---- 5b. the main path, sharded: FusedCore over mesh "4" on the card
    sharded_core = FusedCore(mesh=smoke_mesh("4", dev), batch_window=0.0005)
    _out_s, launches_sharded = main_path_phase(
        sharded_core, torch, decide_and_match_sharded, SMOKE_SHARDS, card,
        "main path, sharded (mesh 4)")

    # ---- 3, 3b: the kernels' device times; 4, 4b: no index_add_ in either
    #          step (profiled, so after the main path's readings)
    device_times(timed, card)
    assert_no_index_add(card_step, "step")
    assert_no_index_add(sharded_step, "sharded step")
    print("step, sharded step: no index_add_ (profiler, CPU activity)")
    del gpu, sharded_step

    # ---- 5c. where the device time goes: a short profiled closed loop
    #          (after the counts above were read; not part of the record)
    prof_core = FusedCore(batch_window=0.0005)
    prof_out = {}
    wall, ev = device_profile(lambda: prof_out.update(asyncio.run(closed_loop(
        prof_core, 131072, 64, churn=768, seconds=3.0, warmup_ticks=4))), torch)
    busy_us = sum(us for _n, us in ev.values())
    if busy_us:
        top = sorted(ev.items(), key=lambda kv: -kv[1][1])[:6]
        index_add = sum(n for k, (n, _us) in ev.items() if "indexFuncLargeIndex" in k)
        print(f"profiled loop: {prof_out['ticks']} ticks, wall {wall:.2f} s, device busy "
              f"{busy_us / 1e6:.3f} s = {busy_us / 1e6 / wall * 100:.1f}% (sum of device "
              f"event time / wall), idle {100 - busy_us / 1e6 / wall * 100:.1f}%; "
              f"indexFuncLargeIndex events: {index_add}; top: "
              + "; ".join(f"{k[:60]} x{n} {us / 1e3:.1f} ms" for k, (n, us) in top)
              + f" [{card}]")
    else:
        print("profiled loop: the profiler saw no device time: busy share not measured")

    # ---- 6. the engine path: start_syncer over two LogicalStores
    engine_phase(torch, dev, card)
    print(f"total {time.perf_counter() - t_all:.1f} s")

    record.update(name="decide_and_match", route="cuda",
                  source="kcp_tpu_torch/csrc/decide_match.cu",
                  replaces="kcp_tpu/ops/pallas_kernels.py:129", launches=launches,
                  library_ms=None)
    record_sharded.update(name="decide_and_match_sharded", route="cuda",
                          source="kcp_tpu_torch/csrc/decide_match.cu",
                          replaces="kcp_tpu/ops/pallas_kernels.py:223",
                          launches=launches_sharded, library_ms=None)
    print("recorded before the redesign, not measured in this run (PERF.md §6): "
          + ", ".join(f"{r['name']} {RECORDED_EARLIER_MS[r['name']]} ms on the device "
                      f"against {r['ms']:.4f} ms now" for r in (record, record_sharded)))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in (record, record_sharded)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
