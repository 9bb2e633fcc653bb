#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``kcp_tpu_torch``) on one NVIDIA card,
and on every visible card where there are several (phases 19-20).

Run from the repo root with no arguments: ``python3 chip_smoke.py``.
Phases, each fatal on failure:

1. device — a CUDA card must be present; prints its name and power limit;
2. build — compiles the port's CUDA kernel from ``kcp_tpu_torch/csrc``
   (ptxas registers, stack and spills), then the port's native host
   library and extension from ``native/`` (path and seconds of each);
3. kernel vs plain — ``decide_and_match`` against its plain PyTorch
   version on the card, exact equality, at the serving shape
   (B=131,072, S=64, per-row mask, L=1, C=8) in its 3-output form and in
   its fleet form (seeded segment ids, negative and out of range among
   them, seg_capacity 8), the model example shape (B=8,192, S=64,
   bucket-wide mask, L=8, C=64) and a ragged B=131,071; for each, the
   tile plan (the serving shape must take the bulk path), back-to-back
   call time, plain time and the bound;
3b. sharded kernel vs plain — ``decide_and_match_sharded`` over a
   4-shard mesh (``"4"``, fleet form), a slot-sharded ``"2x2"`` mesh and
   an 8-shard mesh (``"8"``, fleet form), all on repeated ``cuda:0``
   shards, at the serving shape, plus a ragged B=131,071 over ``"4"``
   (fleet form), ``"4"`` with one shard's inputs offset by 4 bytes
   (that shard takes the plain-load path, the others the bulk path), and
   the bucket-wide [S] mask over ``"4"`` and, one shard offset, ``"8"``:
   exact equality with the unsharded plain version, one grouped launch
   per call (the card's shards in one launch), back-to-back call time,
   plain time, bound;
4. device step vs CPU step — ``reconcile_step_fleet`` on the card and on
   the CPU from one seeded state and wire at B=131,072, S=64 (acks with
   padding, mask and segment stamps, then an overflow tick): the wires
   must be byte-equal, and so must every lane ``wire_scatter`` writes (the
   mirrors, their flags, the status mask, the seg ids; each must change in
   each tick), the card step may call no ``index_add_`` (the kernel's
   fleet form counts the segments), and each card step launches
   ``wire_scatter`` twice (the wire's side lanes, then the deltas);
4c. ``wire_scatter``'s pair of launches against the torch path it
   replaces, on the card, at B=1,048,576 (a wire of 128 entries, 1,024
   acks): every lane it writes and the count of valid deltas equal,
   back-to-back pair time, torch path time, byte bound;
4b. sharded step vs unsharded card step — the same two ticks through a
   4-shard state on the card: byte-equal wires, one sharded kernel launch
   a tick, no ``index_add_``;
5. main path — a closed churn loop through the port's ``FusedCore``
   (fleet batch on, pipeline "double") at 131,072 rows x 64 slots:
   every churned row must converge, the kernel's launch count must cover
   every tick with ``wire_scatter``'s twice that, and no step may fail or
   quarantine a row;
5b. main path, sharded — the same loop with ``FusedCore(mesh="4" over
   cuda:0)``: every row converges, the sharded kernel launches once a
   tick (one grouped launch over the card's 4 row shards), nothing is
   quarantined;
5c. after the main path, what needs the profiler (a profiler session
   can leave later launches slower on the host, so none runs before the
   host-clock readings of phases 5 and 5b): the device time of every phase-3, 3b, 4c, 14 and 19 case,
   back to back and with the L2 flushed before every call by writing and
   by reading 256 MiB, each profiled call holding its expected device
   events (a short profile is taken again, three in all), and the colder
   flushed time's share of the bound rate; the ``index_add_`` checks of 4 and 4b;
   then a short profiled loop (device busy share, top device events, and
   how many ``index_add_`` kernels ran: none is expected);
6. engine path — ``start_syncer`` over two ``LogicalStore``s on the card,
   without a mesh and on ``"4"``: 16,384 labelled ConfigMaps across 64
   namespaces, then an update, a delete and a downstream status write
   that must reach upstream; both runs must end with equal dumps;
7. controller plane — ``kcp_tpu_torch.demo.controller_plane_load`` on
   the card: ``NegotiationController(auto_publish=True)``,
   ``CRDLifecycleController``, ``ClusterController(PUSH,
   ["deployments.apps"])`` and ``DeploymentSplitter``, all with
   ``device=None``, over 16 logical clusters that each register the same
   4 fake physical clusters (64 push syncers on one ``FusedCore``, a
   ``FakeClusterAgent`` per physical cluster) and 128 root Deployments
   per logical cluster, seeded replicas in 1..100: every import
   Compatible and Available, every cluster Ready, every one of the
   8,192 leaves downstream with the CPU ``split_replicas`` count, every
   root's readyReplicas aggregated, all 2,048 roots through the fused
   placement lanes, ``decide_and_match`` launched, nothing quarantined;
   then, for the window from the first root to the last aggregated, the
   fleet ticks, the core's seconds in each tick phase, and the process's
   CPU seconds against the window's wall time;
7b. the two demo scenarios through the port on the card, unsharded and
   with the controllers on mesh ``"4"`` over ``cuda:0``: both
   transcripts equal ``contrib/demo/demo.result`` line for line, and each
   run launched its kernel (``decide_and_match_sharded`` on the mesh);
8. the front door — phase 7's layout reached through ``kcp start``'s
   ``Server`` in a ``ServerThread`` (in memory, TLS off, controllers on
   the card, 0.2 s polls), driven over HTTP by a
   ``MultiClusterRestClient`` (``kcp_tpu_torch.demo.front_door_load``):
   the 64 registrations, 32 root Deployments per logical cluster (cut
   from phase 7's 256 for the time limit), every leaf equal to the CPU
   split, every root's readyReplicas read back over REST,
   ``decide_and_match`` launched once per fleet tick with synced rows,
   the quota ledger's device lane equal to each logical cluster's
   leaves and ``quota_usage_device`` on ``/metrics`` to all of them,
   ``/debug/trace`` written, nothing quarantined; then the window's
   readings (creates' latency on the client, ``admission_seconds``, tick
   phases, process CPU, ticks and launches);
8b. the binaries as child processes without ``--device``: ``kcp start``
   with its controllers serves a create, a get, a wildcard list and
   ``/readyz``; kcp + physical kcp + a ``--backend fused`` syncer
   downsync a labelled ConfigMap; each child exits 0 on SIGTERM and,
   through a wrapper that adds nothing to the binary, reports that it
   loaded no ``jax``/``jaxlib``/``kcp_tpu`` module; a ``kcp start`` child
   with ``KCP_FLEET=1`` serves with its fleet scheduler up the same way;
   two ``--role shard`` children (``--shard-name s<i> --ring-names
   s0,s1 --ring-epoch 1``, controllers on the card) behind a ``--role
   router`` child: a create through the router answers 201, a direct
   create stamped ``X-Kcp-Ring-Epoch: 1`` answers 201 on the owner and
   410 with the epoch header on the other shard, and a wildcard list
   through the router lists both objects;
9a. fleet placement, the solver — ``FleetSolver`` on the card at the
   placement benchmark's shape (BASELINE configs[2],
   ``kcp_tpu_torch.bench.placement_bench``: 10,000 workspaces x 8
   physical clusters, spread 2, padded to 16,384 x 8): the assignment
   byte-equal to ``solve_host`` on the same inputs, no row over its
   demand, no replica off a candidate, the 37-row incremental re-solve
   touching exactly 37 rows with no mismatch, ``solve_sharded`` over
   mesh ``"4"`` on ``cuda:0`` equal to the unsharded solve; the solve's
   host-clock ms (median of 7 after a warm-up) and the per-workspace
   host loop's (the card machine's CPU); its device ms and device events
   per solve come with the profiler, after 5c;
9b. fleet placement through ``kcp start`` — phase 8's layout with
   ``Config(fleet=True)`` (``kcp_tpu_torch.demo.fleet_front_door_load``):
   seeded capacities and region labels on the 64 registrations, 64 roots
   per logical cluster with seeded replicas and region labels over REST;
   every leaf equal to ``solve_host`` on what REST holds, a
   ``decide_and_match`` launch per fleet tick with rows; then one
   registration's allocatable changes over REST and only its logical
   cluster's rows re-solve, the leaves again equal to ``solve_host``;
10. the sharded front door — phase 8's layout over 4 durable shard
   servers (a WAL each; one loop, one ``FusedCore`` and controllers on
   the card each) behind a ``role="router"`` server
   (``kcp_tpu_torch.demo.sharded_front_door_load``): registrations
   routed through the router, a merged wildcard watch opened before the
   first root, 8 roots per logical cluster POSTed direct by a
   ``SmartRestClient`` (even logical clusters) or routed (odd ones);
   every leaf equal to the CPU split, each tenant's objects on its HRW
   shard only, every root aggregated through the router, the merged
   watch lossless and resumable from a mid-stream vector RV, the
   router's wildcard list byte-equal to the shards' own, a
   ``decide_and_match`` launch per fleet tick with rows on every
   shard's core; then the window's readings (direct and routed create
   latency, ``router_proxy_seconds``, each shard's tenants, ticks,
   launches and leaves, process CPU).

11. the scenario harness — ``kcp_tpu_torch.scenarios.run_scenario`` with
   ``device=None`` at seed 42, scale 1.0 (the catalog's full shape):
   ``capacity-skew-binpack`` (10,000 x 8 solved on the card, byte-equal
   to ``solve_host``, the 37-row re-solve), ``fleet-churn`` (200 flapping
   physical clusters against the monolith's fleet scheduler and
   controllers on the card; a ``decide_and_match`` launch per fleet tick
   with rows, read on the server's loop), ``crd-churn`` (controllers on
   the card) and ``crud-churn`` with ``KCP_TRACE=1`` and
   ``KCP_TRACE_SAMPLE=1`` (assembled traces on the scorecard): every SLO
   passes, every schedule hash equals ``SCENARIOS_r07.json``'s.

12. the fleet A/B — ``python -m kcp_tpu_torch.bench --fleet``'s lane at
   its full default shape (131,072 x 64, 16,384 x 32 and 2,048 x 16
   buckets, 24 straggler sections in an 8-slot bucket, 40 steps after 8
   warm-up): per-bucket dispatch (the kernel's 3-output form once per
   bucket and tick, S = 64, 32, 16 and 8), then ragged (the fleet form
   once per tick), then the poison-row quarantine drill; the per-owner
   patch streams equal, the drill green, rows per dispatch gained at
   least 2x, one ``decide_and_match`` launch per dispatch in each mode;
   rows/s, dispatches, rows per dispatch and tick p50/p99 per mode; then
   every shape the run gave the kernel (form, B, S, L, C, mask and
   segment capacity, in each mode and the drill) against the plain
   version, exact, on the run's own inputs and on seeded ones;
13. the gauntlet's controller config — ``kcp_tpu_torch.bench.gauntlet_bench``
   with ``KCP_GAUNTLET_CONFIGS=3`` (``gauntlet-crd-5k``) at scale 1/50,
   its controllers on the card: the row passes, the scorecard is not
   degraded, the row's device is the card; then the port's lint gate
   (``kcp_tpu_torch.analysis``) over ``kcp_tpu_torch/`` and
   ``chip_smoke.py``, which must be clean;
14. the suite — ``kcp_tpu_torch.bench.suite("cuda")`` (``python -m
   kcp_tpu_torch.bench --suite``) at its default shape: BASELINE
   configs[2..4] (``split_replicas`` over 10,000 x 8, 5,000 schemas
   tokenized on the host and hashed on the card, label fan-out over
   100,000 x 8 pair hashes x 64 selectors) and the decision+fanout A/B at
   B=131,072, S=64, L=8, C=64, bucket-wide mask: the plain version eager,
   compiled by ``torch.compile`` and the kernel (91 launches, the phase's
   count); the kernel at that shape equal to the plain version on the
   lane's inputs and on a seeded case with ~30% selector hits; the
   compiled plain version equal to the plain one there and at the serving
   fleet form; each shape's kernel, compiled and plain time and bound;
15. the sharded fleet's lanes at ``scripts/ci.sh``'s shapes, held to its
   gates: ``--sharded`` (1 and 2 ``kcp start`` shard processes; five
   runs, the capacity floor held by their median),
   ``--smartclient`` and ``--elastic`` (2 -> 4 shards live), each a
   ``python -m kcp_tpu_torch.bench`` child that must load no torch, JAX or
   JAX-package module; no server runs controllers, so these are host-path
   numbers on this machine's CPU; then a shard child and a
   ``--shard-loadgen`` child that load none either; the shard's seconds to
   serve and the phase's seconds (before phase 15, the compile worker that
   phase 14's ``torch.compile`` left is stopped);
16. the store, encode, admission, replication and write-path lanes at
   ``scripts/ci.sh``'s shapes, held to its gates: ``--store``,
   ``--encode``, ``--admission`` (five runs, its two timing limits held
   by their medians), ``--replica``, ``--consistent`` and
   ``--writes``, each a ``python -m kcp_tpu_torch.bench`` child that must
   load no torch, JAX or JAX-package module; host-path numbers on this
   machine's CPU, one line per lane with its seconds;
17. the ``--watchers`` lane at ``scripts/ci.sh``'s shape, held to its
   gates: 1,000 live watch streams over 10,000 objects in 20 clusters
   against a ``--watchers-serve`` child (every stream established, RSS per
   watcher and its soak growth, delivery p99), the coalesced against
   per-batch flush A/B at 48 watchers (streams byte-identical, a 4x
   reduction) and the evict drill; a child that must load no torch, then
   a ``--watchers-serve`` child that must load none either;
18. A7, the serving mesh across processes: two rank processes of one
   ``torch.distributed`` group, both serving on ``cuda:0`` (so gloo on any
   host: one card holds no two NCCL ranks), each holding its hosts block
   of a ``2x2x1`` mesh on the card, run three seeded fleet ticks at
   131,072 x 64 (an overflowing one among them), their row shards
   launching ``decide_and_match``: both ranks' wires must equal the
   one-process ``2x2x1`` run's byte for byte; each rank's backend, step
   ms and launches;
19. the fused loop over a card per row shard, only where two cards or
   more are visible (else one line, ``not run: needs ≥ 2 cards, 1
   visible``): 4b's ticks through ``mesh_from_spec(str(n))`` over the n
   cards, byte-equal to the unsharded step with one launch per card a
   tick; 5's closed loop through ``FusedCore`` on that mesh (one launch
   per card a tick) beside 5b's ms/tick and convergence; the sharded
   kernel over the n cards against its plain version, and after 5c its
   counted, cold device time with each card's share;
20. A7 over NCCL, only where two cards or more are visible (else one
   ``not run`` line): two rank processes that serve on cards of their own
   (``2x2x1``, two cards a rank, on four cards or more; ``2x1x1`` on two
   or three), each reporting ``nccl``, launching once a step on each of
   its cards, its wires byte-equal to the one-process run over the same
   spec (and to 18's); each rank's step ms beside 18's gloo ranks.

Before each lane of phases 15-17, the script's own load is read, and a line
per lane prints it: the CPU count and this process's affinity,
``/proc/loadavg``, this process's CPU seconds over the lane's window, its
threads and live children, its full collections in the window and, for a
lane run as a child, the child's own full collections and CPU seconds.

Every full (generation-2) garbage collection is timed, and phases 7-10,
11, each mode of 12, 13 and 15 print theirs. Phase 11 runs with the heap
the earlier phases left collected once and frozen (its time and size
printed), so that full collections during it scan only what it
allocates; the heap is unfrozen after it. Phases 7 to 20 run right
after 5b, before the profiler of 5c, so that their host-clock
readings, like those of 5 and 5b, follow no profiler session (phase
8's own ``/debug/trace`` calls come after its readings;
each is timed against the serving loop: the request's wall time, the
slowest ``/healthz`` round trip meanwhile, the loop watchdog's stalls
and the loop's CPU ops in the trace).

The line before the last is the kernels' JSON record, every number in
it measured in this run (``bound_ms`` computed from this run's inputs);
the last line is ``{"ok": true, "device": {...}}``. Without a card the
script exits 2 before printing any result.
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import signal
import subprocess
import sys
import threading
import time
from statistics import median

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
ALU_OPS_PER_S = 67e12  # H100 SXM non-tensor peak (float32 table rate)
SERVING = dict(b=131072, s=64, l=1, c=8, per_row=True)
SEG_CAPACITY = 8
# wire_scatter's timed case (phase 4c, chip_probe wire): fleet-1m's rows, a
# wire of 128 entries (96 deltas, 32 mask stamps) and 1,024 acks
WIRE_B, WIRE_DELTAS, WIRE_ACKS = 1_048_576, 96, 1024
# the resident lanes beside seg_ids that wire_scatter writes
WIRE_LANES = ("up_vals", "up_exists", "down_vals", "down_exists", "status_mask")
# device ms of each kernel before its redesign at the serving shape, as
# recorded in PERF.md §6 (decide_and_match before its persistent grid;
# decide_and_match_sharded's four per-shard launches, counted and cold,
# before one grouped launch per card): printed for reference on a line of
# their own, never in the kernels record
RECORDED_EARLIER_MS = {"decide_and_match": 0.0661, "decide_and_match_sharded": 0.0506}
SMOKE_SHARDS = 4  # row shards of the smoke meshes, all on cuda:0
ENGINE_OBJECTS = 16384  # phase 6 (cut from 131,072 for the time limit)
ENGINE_NAMESPACES = 64
# phase 7: logical clusters (cut from 10,000 for the time limit), fake
# physical clusters per logical cluster, root Deployments per logical cluster
# (cut from 256 to 128 for the time limit: with 256, phase 10 at 16 and
# 10 s loops in phases 5 and 5b, the script took 389-419 s on the H100
# machines and 614 s on one whose host ran about 1.5x slower)
PLANE_LOGICAL, PLANE_PHYSICAL, PLANE_ROOTS = 16, 4, 128
# phase 8: phase 7's layout, reached through kcp start's server over REST;
# root Deployments per logical cluster cut from 256 to 32 for the run's
# time limit (at 256 the POSTs alone took 103 s on the H100; 64 took 18 s,
# and phase 10 repeats this layout over four shards)
FRONT_ROOTS = 32
# phase 9a: the placement benchmark's shape (BASELINE configs[2],
# bench.py --placement): workspaces x physical clusters, spread, timed solves
PLACE_W, PLACE_P, PLACE_SPREAD, PLACE_ITERS = 10000, 8, 2, 7
# phase 9b: phase 8's layout with fleet placement on; roots per logical cluster
FLEET_ROOTS = 64
# phase 10: phase 8's layout over a sharded control plane: shards (the
# reference's widest fleet in every sharded lane: --sharded runs 1/2/4,
# --elastic 2 -> 4) and roots per logical cluster, cut from 64 for the
# run's time limit (at 64 its POSTs took 56.7-90.8 s on the H100 machine
# and the script 225.6-304.4 s), then from 16 to 8 (see phase 7's cut)
SHARDS, SHARDED_ROOTS = 4, 8
# phase 8b: the modules a child binary must not have loaded as it exits
FORBIDDEN = ("jax", "jaxlib", "kcp_tpu")
# phase 8b: runs a binary (a module, or a script given by its path) unchanged
# and, as it exits, prints the JAX and JAX-package modules it loaded, whether
# it loaded torch, the kernel's launch count, its full (generation-2) garbage
# collections (count, ms in all, the longest) and its own CPU seconds
WRAPPER = (
    "import atexit, gc, json, os, runpy, sys, time\n"
    "full, began = [], [0.0]\n"
    "def timed(phase, info):\n"
    "    if info['generation'] == 2:\n"
    "        if phase == 'start':\n"
    "            began[0] = time.perf_counter()\n"
    "        else:\n"
    "            full.append((time.perf_counter() - began[0]) * 1e3)\n"
    "gc.callbacks.append(timed)\n"
    "def report():\n"
    "    ck = sys.modules.get('kcp_tpu_torch.ops.cuda_kernels')\n"
    "    print('EXIT ' + json.dumps({'loaded': sorted(m for m in sys.modules\n"
    "          if m.split('.')[0] in %r), 'torch': 'torch' in sys.modules,\n"
    "          'launches': ck.decide_and_match.launches if ck else 0,\n"
    "          'full_collections': len(full), 'full_collection_ms': round(sum(full), 1),\n"
    "          'longest_ms': round(max(full, default=0.0), 1),\n"
    "          'cpu_s': round(sum(os.times()[:2]), 3)}), flush=True)\n"
    "atexit.register(report)\n"
    "sys.argv[0] = %r\n"
    "(runpy.run_path if %r.endswith('.py') else runpy.run_module)(%r, run_name='__main__')\n")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    from kcp_tpu_torch.bench import card_line as nvidia_smi

    line = nvidia_smi()
    if line is None:
        fail("nvidia-smi printed no card")
    return line


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


def segments(rng, b, torch, dev, cap: int = SEG_CAPACITY):
    """Seeded segment ids: in range, negative (from the end and beyond it),
    out of range and SEG_NONE."""
    seg = rng.integers(-2 * cap - 1, 2 * cap + 2, b).astype(np.int32)
    seg[rng.random(b) < 0.05] = 0xFFFF
    return torch.from_numpy(seg).to(dev)


def bound(case, outs, launches: int = 1) -> tuple[float, str, int]:
    """Least time for the call: bytes (each input read once, each output
    written once) over the HBM rate vs operations over the ALU rate.
    ``case`` may end with the fleet form's seg_ids, ``outs`` with its
    segment counts. A call of several launches also reads the replicated
    selectors and writes its [C] (and [cap]) partial counts once per
    launch; a grouped call over a card's shards is one."""
    up, _upe, _down, _dne, _mask, pair, sel = case[:7]
    nbytes = sum(x.numel() * x.element_size() for x in (*case, *outs))
    partial = sum(x.numel() * x.element_size() for x in outs[2:])
    nbytes += (launches - 1) * (sel.numel() * sel.element_size() + partial)
    b, s = up.shape
    ops = 3 * b * s + 2 * b * pair.shape[1] * sel.shape[0] + 4 * b * (len(case) > 7)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            nbytes)


def sync_cards(torch) -> None:
    """Wait for every visible card (``torch.cuda.synchronize()`` waits for
    the current one only, and a call over a card per row shard runs on
    them all)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def time_ms(fn, torch, iters: int) -> float:
    for _ in range(3):
        fn()
    sync_cards(torch)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync_cards(torch)
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
    """A seeded fleet state + wire: per-row masks, deltas (a tenth of them
    deletes), acks with -1 padding, mask stamps carrying segment ids."""
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
    deltas = deltas._replace(exists=rng.random(d) >= 0.1)  # deletes among them
    stamps = np.zeros((32, s + 2), np.uint32)
    # each stamp a mask row of its own, never the one the row holds
    # (its last s // 8 columns), so a lost stamp column shows
    stamps[:, :s] = rng.random((32, s)) < 0.25
    stamps[:, 0] = 1
    stamps[:, s] = rng.choice(b, 32, replace=False)
    stamps[:, s + 1] = (4 | tm.MASK_STAMP_BIT
                        | (rng.integers(0, 8, 32).astype(np.uint32) << tm.SEG_SHIFT))
    packed = np.concatenate([tm.pack_deltas(deltas), stamps])
    touched = set(deltas.idx[deltas.valid & ~deltas.side].tolist())
    free = np.array([i for i in rng.choice(b, 2048, replace=False) if i not in touched])
    acks = np.full(8192, -1, np.int32)
    acks[:512] = free[:512]
    return state, seg, packed, acks


def wire_lanes(state, seg_ids) -> dict:
    """The lanes that ``wire_scatter`` writes, by name."""
    return {**{n: getattr(state, n) for n in WIRE_LANES}, "seg_ids": seg_ids}


def check_wire_lanes(label: str, got: dict, want: dict, before: dict, torch) -> None:
    """Fails unless every lane of ``got`` (the card's) equals ``want``'s
    (the torch path's) in dtype, shape and every byte, or if a lane of
    ``want`` equals ``before``'s: a tick that leaves a lane as it was
    tests nothing there."""
    for name, w in want.items():
        g, w, b = got[name].cpu(), w.cpu(), before[name].cpu()
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"{label}: {name} is {g.dtype}{tuple(g.shape)}, the torch path's "
                 f"{w.dtype}{tuple(w.shape)}")
        if not torch.equal(g, w):
            rows = (g != w).reshape(g.shape[0], -1).any(1).nonzero().flatten()
            fail(f"{label}: {name} differs from the torch path's in {rows.numel()} rows, "
                 f"first {rows[:10].tolist()}")
        if torch.equal(w, b):
            fail(f"{label}: the case left {name} as it was, so nothing of it was compared")


def wire_bytes(packed, acks, b: int, per_row: bool) -> dict:
    """The bytes each ``wire_scatter`` stage needs (each read once, each
    write once): every entry's index and flags; the stamps' values, mask
    rows and segment ids; each real ack's up row read and down row written
    (and their flags); each valid delta's values read and row written."""
    from kcp_tpu_torch.models.reconcile_model import MASK_STAMP_BIT

    wire = np.asarray(packed).view(np.int32)
    d, s = wire.shape[0], wire.shape[1] - 2
    flags, idx = wire[:, s + 1], wire[:, s].astype(np.int64)
    row = np.where(idx < 0, idx + b, idx)
    ok = (row >= 0) & (row < b)
    stamp = ((flags & 4) != 0) & ((flags & MASK_STAMP_BIT) != 0) & ok
    delta = ((flags & 4) != 0) & ((flags & MASK_STAMP_BIT) == 0) & ok
    acks = np.asarray(acks)
    real = int(((acks >= 0) & (acks < b)).sum())
    head = 8 * d
    return {"stamps": head + 4 * acks.shape[0] + int(stamp.sum()) * (4 * s + (s if per_row else 0) + 4)
            + real * 2 * (4 * s + 1),
            "deltas": head + int(delta.sum()) * (8 * s + 1) + 4}


def wire_case(torch, dev):
    """``step_case`` cut to ``wire_scatter``'s timed case (``WIRE_*``):
    the numpy state, seg ids, wire and acks, and the wire and acks on
    ``dev``."""
    from kcp_tpu_torch.models import reconcile_model as tm

    state, seg, packed, acks = step_case(np.random.default_rng(21), WIRE_B, SERVING["s"],
                                         WIRE_DELTAS, torch)
    acks = acks[:WIRE_ACKS]
    return state, seg, packed, acks, tm.to_device(packed, dev), tm.to_device(acks, dev)


def wire_scatter_phase(torch, dev, card: str, timed: list) -> dict:
    """4c. ``wire_scatter``'s two launches of a packed step (the side
    lanes, then the deltas) at ``wire_case`` against the torch path they
    replace, on the card, each on its own copy of the state: every lane
    they write byte-equal, and the count of valid deltas (``stats[7]``)
    equal. Prints the pair's and the torch path's time a step (events) and
    the pair's byte bound; adds the pair to ``timed`` for its device time
    after the profiler starts. Returns the kernel's record."""
    from kcp_tpu_torch.models import reconcile_model as tm
    from kcp_tpu_torch.ops.cuda_kernels import wire_scatter
    from kcp_tpu_torch.ops.diff import apply_deltas

    state, seg, packed, acks, pk, ak = wire_case(torch, dev)
    deltas = tm.unpack_deltas(pk)

    def kernel_pair(st, sg):
        lanes = (st.up_vals, st.up_exists, st.down_vals, st.down_exists)
        wire_scatter("stamps", pk, *lanes, st.status_mask, sg, ak)
        return wire_scatter("deltas", pk, *lanes)

    def torch_path(st, sg):
        d = tm.unpack_deltas(pk)
        tm.apply_side_lanes_plain(st, pk, ak, sg)
        apply_deltas(st.up_vals, st.up_exists, d.idx, d.vals, d.exists, d.valid & ~d.side)
        apply_deltas(st.down_vals, st.down_exists, d.idx, d.vals, d.exists, d.valid & d.side)
        return d.valid.sum(dtype=torch.int32).reshape(1)

    before = wire_lanes(tm.state_from_numpy(state, "cpu"), tm.to_device(seg, "cpu"))
    got = (tm.state_from_numpy(state, dev), tm.to_device(seg, dev))
    want = (tm.state_from_numpy(state, dev), tm.to_device(seg, dev))
    applied, want_applied = kernel_pair(*got), torch_path(*want)
    torch.cuda.synchronize()
    label = (f"wire_scatter [a packed step's pair: B={WIRE_B} S={SERVING['s']} mask=row, "
             f"wire {packed.shape[0]} entries ({int(deltas.valid.sum())} valid deltas), "
             f"{int((acks >= 0).sum())} of {acks.shape[0]} acks real]")
    check_wire_lanes(f"kernel {label}", wire_lanes(*got), wire_lanes(*want), before, torch)
    if not torch.equal(applied, want_applied) or int(applied) == 0:
        fail(f"kernel {label}: {int(applied)} valid deltas counted, the torch path "
             f"{int(want_applied)}")
    call_ms = time_ms(lambda: kernel_pair(*got), torch, 50)
    plain_ms = time_ms(lambda: torch_path(*want), torch, 10)
    nbytes = sum(wire_bytes(packed, acks, WIRE_B, True).values())
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"kernel {label}: every lane it writes (mirrors, flags, status mask, seg ids) and "
          f"the valid-delta count equal to the torch path's (tolerance: exact); {call_ms:.4f} "
          f"ms per back-to-back pair (events), torch path {plain_ms:.4f} ms, bound "
          f"{bound_ms:.6f} ms by bytes ({nbytes} B); library call: none [{card}]")
    record = dict(max_abs_err=0, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes")
    timed.append((label, lambda: kernel_pair(*got), 2, bound_ms, record))
    return record


def smoke_mesh(spec: str, dev, shards: int = SMOKE_SHARDS):
    """A smoke mesh: ``spec`` over ``dev`` repeated ``shards`` times (every
    shard its own allocation on the one card)."""
    from kcp_tpu_torch.parallel.mesh import mesh_from_spec

    return mesh_from_spec(spec, devices=[dev] * shards)


def offset_view(t, nbytes: int = 4):
    """A copy of ``t`` that starts ``nbytes`` past a 16-byte boundary:
    contiguous, equal, and off the bulk path's alignment."""
    import torch

    flat = torch.empty(t.numel() * t.element_size() + nbytes, dtype=torch.uint8,
                       device=t.device)
    view = flat[nbytes:].view(t.dtype).view(t.shape)
    view.copy_(t)
    return view


#: bytes written (or read) between two calls of a cold-L2 device time:
#: over 5x the H100's 50 MiB L2, so no input of the call before stays
#: resident
L2_FLUSH_BYTES = 256 * 2**20
#: the profiler range around each measured call
CALL_RANGE = "chip_smoke.measured_call"
#: seconds of unmeasured calls at the start of a profile, by attempt: after
#: the earlier phases the profiler was seen to miss the first 9 launches of
#: every window (H100, torch 2.11)
PROFILE_WARMUP_S = (0.05, 0.25, 1.0)


def call_events(fn, torch, calls: int, kernel: str | None, flush=None,
                warmup_s: float = PROFILE_WARMUP_S[0], by_card: dict | None = None) -> tuple:
    """``fn()`` ``calls`` times under torch.profiler, each call in a
    ``CALL_RANGE`` range, after ``warmup_s`` of unmeasured calls in the
    same window; with ``flush``, ``flush()`` runs
    before every call, outside the range. Returns, per measured call, the
    device us of each device event it launched whose name holds ``kernel``
    (every one with ``kernel=None``), the unmeasured calls' count, and the
    count of such events anywhere in the profile; with ``by_card``, it also
    sums the measured calls' device us there by card index. A device event belongs
    to a call when the CUDA API call that launched it (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ``cudaMemsetAsync``, ...: the one with its
    correlation id) ran inside the call's range; a launch through ctypes
    has no op to hang on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    sync_cards(torch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        warm, t0 = 0, time.perf_counter()
        while not warm or time.perf_counter() - t0 < warmup_s:
            if flush is not None:
                flush()
            fn()
            warm += 1
        sync_cards(torch)
        for _ in range(calls):
            if flush is not None:
                flush()
            with record_function(CALL_RANGE):
                fn()
        sync_cards(torch)
    events = prof.events()
    device: dict = {}
    for e in events:
        if (e.device_type == DeviceType.CUDA and not e.is_user_annotation
                and (kernel is None or kernel in e.name)):
            device.setdefault(e.id, []).append(e)

    def launched(cpu_event) -> list:
        out = []
        for child in cpu_event.cpu_children:
            if child.name.startswith("cu"):  # a CUDA API call
                out += device.get(child.id, [])
            out += launched(child)
        return out

    calls_events = [launched(e) for e in events
                    if e.name == CALL_RANGE and e.device_type == DeviceType.CPU]
    if by_card is not None:
        for d in (d for c in calls_events for d in c):
            by_card[d.device_index] = by_card.get(d.device_index, 0.0) + d.device_time_total
    per_call = [[d.device_time_total for d in c] for c in calls_events]
    return per_call, warm, sum(map(len, device.values()))


def kernel_device_ms(fn, torch, launches: int | None, label: str, calls: int = 20,
                     kernel: str | None = "decide_match_kernel", flush=None,
                     by_card: dict | None = None) -> tuple:
    """(device ms per call, device events per call) of ``fn``: the events
    named ``kernel`` that each call launched, summed (every event with
    ``kernel=None``). Every one of
    the ``calls`` profiled calls must show ``launches`` such events (with
    ``kernel=None``: one count alike in every call, above 0); a profile
    short of that is taken again, three in all, and then the phase fails
    with the counts. No other clock stands in for the device's. ``by_card``
    gets the complete profile's device ms per call by card index."""
    counts = []
    for attempt, warmup_s in enumerate(PROFILE_WARMUP_S, 1):
        cards: dict = {}
        per_call, warm, seen = call_events(fn, torch, calls, kernel, flush, warmup_s, cards)
        counts = [len(c) for c in per_call]
        want = launches if kernel is not None else (counts[0] if counts else 0)
        if len(counts) == calls and want and all(n == want for n in counts):
            if by_card is not None:
                by_card.update({i: us / calls / 1e3 for i, us in sorted(cards.items())})
            return sum(map(sum, per_call)) / calls / 1e3, want
        print(f"device time {label}: profile {attempt} of 3 short: device events per call "
              f"{counts}, {want if kernel is not None else 'one count alike'} expected; "
              f"{seen} such events in the whole profile after {warm} unmeasured calls "
              f"({warmup_s} s)")
    fail(f"device time {label}: no complete device reading in 3 profiles (device events per "
         f"call {counts}; {launches if kernel is not None else 'one count alike'} expected)")


def device_times(timed: list, card: str, kernel: str | None = "decide_match_kernel",
                 cards: list | None = None) -> None:
    """The device times of ``timed``'s calls, read with the profiler after
    the main path has run (a profiler session can leave later launches
    slower on the host, which would skew the main path's host-clock
    readings). ``timed`` holds (label, call, device events per call or
    None, bound ms, record or None) from phases 3, 3b, 14 and 19;
    ``kernel`` names the events counted (None: all of them). Each call is
    read three times: back to back (the inputs of 64-77 MB partly stay in
    the 50 MiB L2, so this can beat the bound, which reads every input
    from memory), and with the L2 flushed before every call by writing and
    by reading ``L2_FLUSH_BYTES``, on every card of ``cards`` (default the
    current card; a call over several cards prints each card's share of
    the colder reading). Each record's ``ms`` is the colder flushed
    reading, the time the bound is for."""
    import torch

    bufs = [torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=d)
            for d in (cards or ["cuda"])]
    flushes = {"writing": lambda: [b.zero_() for b in bufs],
               "reading": lambda: [b.sum() for b in bufs]}
    seen = "profiler" if kernel else "profiler, every device event of the call"
    for label, fn, launches, bound_ms, record in timed:
        warm_ms, n = kernel_device_ms(fn, torch, launches, label, kernel=kernel)
        cold, shares = {}, {}
        for how, f in flushes.items():
            shares[how] = {}
            cold[how] = kernel_device_ms(fn, torch, launches, label, kernel=kernel, flush=f,
                                         by_card=shares[how])[0]
        how = max(cold, key=cold.get)
        ms = cold[how]
        if record is not None:
            record["ms"] = ms
        per_card = ("" if len(shares[how]) < 2 else "; per card " + ", ".join(
            f"cuda:{i} {v:.4f} ms" for i, v in shares[how].items()))
        print(f"device time {label}: cold L2 {ms:.4f} ms ({seen}; flushed by writing "
              f"{cold['writing']:.4f} ms, by reading {cold['reading']:.4f} ms{per_card}), "
              f"{bound_ms / ms * 100:.1f}% of the bound rate; back to back {warm_ms:.4f} ms "
              f"({bound_ms / warm_ms * 100:.1f}%, reads served from L2 in part); {n} device "
              f"events a call in every profiled call [{card}]")
    del bufs


def plan_text(plan) -> str:
    return (f"plan T={plan.tile} stages={plan.stages} grid={plan.grid} "
            f"{'bulk' if plan.bulk else 'plain'} (plain-path rows {plan.tail_rows}, "
            f"{plan.smem} B shared per block)")


def exact(name: str, got, want, torch) -> int:
    """Fails unless the kernel's outputs equal the plain version's in
    dtype, shape and every value; returns the max abs error (0)."""
    err = 0
    for label, g, w in zip(("decision", "upsync", "counts", "seg_counts"), got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"{name}: {label} is {g.dtype}{tuple(g.shape)}, plain "
                 f"{w.dtype}{tuple(w.shape)}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    if err:
        fail(f"{name}: kernel differs from the plain version (max abs err {err})")
    return err


def check_case(name: str, case, kw: dict, torch, vacuous_fails: bool = True):
    """``decide_and_match`` against its plain version on one case, exact;
    fails if they differ or, with ``vacuous_fails``, if the case has no
    decision, no selector hit or (fleet form) no segment count. Returns
    the kernel's outputs, the max abs error and the launch's tile plan."""
    from kcp_tpu_torch.ops import cuda_kernels

    got = cuda_kernels.decide_and_match(*case, **kw)
    torch.cuda.synchronize()
    plan = cuda_kernels.last_plan
    want = cuda_kernels.decide_and_match_plain(*case, **kw)
    torch.cuda.synchronize()
    err = exact(name, got, want, torch)
    if vacuous_fails and (int(want[0].ne(0).sum()) == 0 or int(want[2].sum()) == 0 or (
            len(want) > 3 and int(want[3].sum()) == 0)):
        fail(f"{name}: vacuous case (no decisions, selector hits or segment counts)")
    return got, err, plan


def kernel_phase(rng, torch, dev, card: str, timed: list) -> dict:
    """3. decide_and_match against the plain version at four cases;
    returns the record of the fleet form at the serving shape (the form
    the main path launches) and adds each case to ``timed``."""
    from kcp_tpu_torch.models import reconcile_model as tm
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
        got, err, plan = check_case(name, case, kw, torch)
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
        timed.append((label, lambda case=case, kw=kw: decide_and_match(*case, **kw), 1,
                      bound_ms, record if name == "serving" and fleet else None))
        torch.cuda.synchronize()
    return record


def sharded_kernel_phase(rng, torch, dev, card: str, timed: list) -> dict:
    """3b. decide_and_match_sharded against the unsharded plain version,
    one grouped launch per call (every shard lies on the one card);
    returns the record of the serving shape over "4" and adds each case
    but the misaligned ones (their plain-load shard is not the main path's)
    to ``timed``."""
    from kcp_tpu_torch.ops import cuda_kernels
    from kcp_tpu_torch.ops.cuda_kernels import (
        decide_and_match,
        decide_and_match_plain,
        decide_and_match_sharded,
    )
    from kcp_tpu_torch.parallel import mesh as pm

    record = None
    bucket = dict(SERVING, per_row=False)
    # (label, spec, shape, fleet form, the shard whose inputs start 4 bytes off)
    for label, spec, sh, fleet, off in (("serving", "4", SERVING, True, None),
                                        ("serving", "2x2", SERVING, False, None),
                                        ("serving", "8", SERVING, True, None),
                                        ("ragged", "4", dict(SERVING, b=131071), True, None),
                                        ("misaligned", "4", SERVING, True, 1),
                                        ("bucket mask", "4", bucket, True, None),
                                        ("misaligned bucket mask", "8", bucket, True, 1)):
        mesh = smoke_mesh(spec, dev, 8 if spec == "8" else SMOKE_SHARDS)
        rf = pm.row_factor(mesh)
        case = kernel_case(rng, sh["b"], sh["s"], sh["l"], sh["c"], sh["per_row"], torch, dev)
        layouts = [pm.ROWS, pm.FLAGS, pm.ROWS, pm.FLAGS,
                   pm.ROWS if sh["per_row"] else pm.SLOT_MASK, pm.FLAGS, pm.REPLICATED]
        seg = dict(seg_capacity=SEG_CAPACITY) if fleet else {}
        if fleet:
            case = (*case, segments(rng, sh["b"], torch, dev))
            layouts.append(pm.FLAGS)
        args = [pm.ShardedTensor.put(x, mesh, lay) for x, lay in zip(case, layouts)]
        if off is not None:  # the shard's row blocks start 4 bytes off
            for a in args:
                if a.layout.rows:
                    a.blocks[off] = [offset_view(a.blocks[off][0])]
        before = decide_and_match_sharded.launches
        got = decide_and_match_sharded(mesh, *args, **seg)
        torch.cuda.synchronize()
        per_call = decide_and_match_sharded.launches - before
        plan = cuda_kernels.last_plan
        if dev.type == "cuda" and per_call != 1:
            fail(f"sharded {label} over {spec}: {per_call} launches for {rf} row shards on "
                 f"one card (want 1)")
        shard_bulk = [t.bulk_tiles > 0 for t in plan.shards] if plan else []
        want_bulk = [i != off for i in range(rf)]
        if dev.type == "cuda" and shard_bulk != want_bulk:
            fail(f"sharded {label} over {spec}: plan {plan} (bulk shards {shard_bulk}, "
                 f"want {want_bulk})")
        got = (got[0].full(), got[1].full(), *got[2:])
        want = decide_and_match_plain(*case, **seg)
        err = exact(f"sharded {label} over {spec}", got, want, torch)
        if int(want[0].ne(0).sum()) == 0 or int(want[2].sum()) == 0:
            fail(f"sharded {label} over {spec}: vacuous case")
        call_ms = time_ms(lambda: decide_and_match_sharded(mesh, *args, **seg), torch, 30)
        one_ms = time_ms(lambda: decide_and_match(*case, **seg), torch, 30)
        plain_ms = time_ms(lambda: decide_and_match_plain(*case, **seg), torch, 10)
        bound_ms, bound_by, nbytes = bound(case, want)
        text = (f"decide_and_match_sharded [{label}: B={sh['b']} S={sh['s']} "
                f"mask={'row' if sh['per_row'] else 'bucket'} "
                f"L={sh['l']} C={sh['c']}{', fleet form' if fleet else ''}, mesh {spec} on "
                f"{rf} row shards x {pm.slot_factor(mesh)} slot shards of {dev}]")
        print(f"kernel {text}: equal (tolerance: exact); {per_call} launch per call over "
              f"{rf} row shards; {plan_text(plan) if plan else 'no plan'}, bulk tiles per "
              f"shard {[t.bulk_tiles for t in plan.shards] if plan else []}; {call_ms:.4f} ms "
              f"per back-to-back "
              f"call (events; unsharded kernel {one_ms:.4f} ms in this run), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B); "
              f"library call: none [{card}]")
        if label == "serving" and spec == "4":
            record = dict(max_abs_err=err, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
        if off is None:
            timed.append((f"{text}, one grouped launch",
                          lambda mesh=mesh, args=args, seg=seg:
                          decide_and_match_sharded(mesh, *args, **seg),
                          1, bound_ms, record if label == "serving" and spec == "4" else None))
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


def sharded_step_phase(torch, dev, card: str, b: int = 131072, s: int = 64, mesh=None):
    """4b. reconcile_step_fleet over a 4-shard state on ``dev`` (or over
    ``mesh``) against the unsharded step on ``dev``: byte-equal wires, the
    phase-4 ticks, one launch of the sharded kernel per card a tick.
    Returns the sharded step, for the ``index_add_`` check after the main
    path."""
    from kcp_tpu_torch.models import reconcile_model as tm
    from kcp_tpu_torch.ops.cuda_kernels import decide_and_match_sharded
    from kcp_tpu_torch.parallel.mesh import FLAGS, ShardedTensor, row_factor, shard_state

    mesh = smoke_mesh("4", dev) if mesh is None else mesh
    cards = len(mesh.local_devices)
    where = (f"mesh {mesh.shape['tenants']} ({SMOKE_SHARDS} row shards of {dev})" if cards == 1
             else f"mesh {row_factor(mesh)} (a row shard on each of "
                  f"{[str(d) for d in mesh.local_devices]})")
    state, seg, packed, acks = step_case(np.random.default_rng(7), b, s, 1024, torch)
    one = [tm.state_from_numpy(state, dev), tm.to_device(seg, dev)]
    sh = [shard_state(state, mesh), ShardedTensor.put(tm.to_device(seg, dev), mesh, FLAGS)]
    for tick, cap in enumerate((8192, 256)):
        if tick:
            _st, _sg, packed, acks = step_case(np.random.default_rng(8), b, s, 1024, torch)
        outs = []
        for side, kw in ((one, {}), (sh, {"mesh": mesh})):
            before = decide_and_match_sharded.launches
            side[0], side[1], wire = tm.reconcile_step_fleet(
                side[0], side[1], tm.to_device(packed, dev), tm.to_device(acks, dev),
                patch_capacity=cap, seg_capacity=8, **kw)
            outs.append(tm.wire_to_numpy(wire))
            launched = decide_and_match_sharded.launches - before
        sync_cards(torch)
        if dev.type == "cuda" and launched != cards:
            fail(f"sharded step over {where} tick {tick}: {launched} launches, want one per "
                 f"card ({cards})")
        if outs[0].tobytes() != outs[1].tobytes():
            diff = np.flatnonzero(outs[0] != outs[1])
            fail(f"sharded step over {where} tick {tick}: wire != unsharded wire at "
                 f"{diff[:10].tolist()}")
        if bool(outs[0][1]) != (cap == 256):
            fail(f"sharded step tick {tick}: overflow flag {bool(outs[0][1])} at "
                 f"capacity {cap}")

    def step(side, **kw):
        side[0], side[1], _w = tm.reconcile_step_fleet(
            side[0], side[1], tm.to_device(packed, dev), tm.to_device(acks, dev),
            patch_capacity=8192, seg_capacity=8, **kw)

    one_ms = time_ms(lambda: step(one), torch, 20)
    sh_ms = time_ms(lambda: step(sh, mesh=mesh), torch, 20)
    print(f"sharded step: reconcile_step_fleet over {where} wire == unsharded card wire, "
          f"2 ticks at B={b} S={s} (acks, mask+segment stamps, overflow tick), "
          f"{cards} sharded kernel launch{'es' if cards > 1 else ''} a tick; device step "
          f"{sh_ms:.4f} ms sharded vs {one_ms:.4f} ms unsharded, incl. upload [{card}]")
    return lambda: step(sh, mesh=mesh)


def main_path_phase(core, torch, counter, per_tick: int, card: str, label: str,
                    rows: int = 131072, seconds: float = 6.0) -> tuple[dict, int]:
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
    dumps, and each run went through its kernel (on "4", one grouped
    launch a tick over the card's 4 row shards)."""
    from kcp_tpu_torch.ops.cuda_kernels import decide_and_match, decide_and_match_sharded

    runs = []
    for spec, counter, per in ((None, decide_and_match, 1),
                               ("4", decide_and_match_sharded, 1)):
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


def controller_plane_phase(torch, dev, card: str) -> None:
    """7. The controller plane at a platform team's size on the card;
    ``kcp_tpu_torch.demo.controller_plane_load`` checks the result and
    raises on the first check that fails."""
    from kcp_tpu_torch import demo
    from kcp_tpu_torch.ops.cuda_kernels import decide_and_match

    decide_and_match.launches = 0
    try:
        out = asyncio.run(demo.controller_plane_load(
            None, None, PLANE_LOGICAL, PLANE_PHYSICAL, PLANE_ROOTS, seed=7))
    except RuntimeError as err:
        fail(f"controller plane: {err}")
    torch.cuda.synchronize()
    launches = decide_and_match.launches
    if launches == 0:
        fail("controller plane: decide_and_match never launched")
    window = out["aggregated_s"]
    in_ticks = sum(out["tick_phases_s"].values())
    print(f"controller plane: {out['physical']} physical clusters, each registered by all "
          f"{out['logical']} logical clusters ({out['syncers']} push syncers on one "
          f"FusedCore), {out['roots']} roots -> {out['leaves']} leaves; every import "
          f"Compatible+Available, every cluster Ready {out['ready_s']:.2f} s after "
          f"registration; first root created -> last leaf downstream {out['leaves_s']:.2f} s, "
          f"-> last root aggregated {window:.2f} s; fused placements "
          f"{out['fused_placements']}, host placements 0, aggregations {out['aggregations']}; "
          f"leaves equal the CPU split; decide_and_match launches {launches}; nothing "
          f"quarantined [{card}]")
    print(f"controller plane window: {out['ticks']} fleet ticks, "
          f"{window * 1e3 / max(out['ticks'], 1):.1f} ms of window per tick; tick phases "
          f"{in_ticks:.3f} s in all ("
          + " ".join(f"{k}={v:.3f}s" for k, v in sorted(out["tick_phases_s"].items()))
          + f"), outside the ticks {window - in_ticks:.3f} s; process CPU {out['cpu_s']:.3f} s "
          f"= {out['cpu_s'] / window * 100:.1f}% of the window [{card}]")


def demo_phase(torch, dev, card: str) -> None:
    """7b. The two demo scenarios through the port on the card, without a
    mesh and on mesh "4" over the card: each transcript equals
    contrib/demo/demo.result, and each run launched its kernel."""
    from kcp_tpu_torch import demo
    from kcp_tpu_torch.ops.cuda_kernels import decide_and_match, decide_and_match_sharded

    want = demo.golden()
    for spec, counter in ((None, decide_and_match), ("4", decide_and_match_sharded)):
        mesh = None if spec is None else smoke_mesh(spec, dev)
        counter.launches = 0
        t0 = time.perf_counter()
        try:
            got = asyncio.run(demo.run("all", None, mesh))
        except RuntimeError as err:
            fail(f"demo (mesh {spec}): {err}")
        torch.cuda.synchronize()
        launches = counter.launches
        bad = demo.diff(want, got)
        if bad:
            fail(f"demo (mesh {spec}): transcript differs from demo.result:\n"
                 + "\n".join(bad))
        if launches == 0:
            fail(f"demo (mesh {spec}): {counter.__name__} never launched")
        print(f"demo: apiNegotiation + kubecon, mesh={spec or 'none'}: {len(got)} lines "
              f"equal contrib/demo/demo.result in {time.perf_counter() - t0:.2f} s; "
              f"{counter.__name__} launches {launches} [{card}]")


def front_door_phase(torch, card: str) -> int:
    """8. Phase 7's controller plane reached through kcp start's server:
    ``kcp_tpu_torch.demo.front_door_load`` on the card checks every leaf,
    every aggregated root (over REST), one launch per fleet tick, the
    ledger's device lane, /debug/trace and quarantine, and raises on the
    first check that fails. Returns the phase's kernel launches."""
    import tempfile

    from kcp_tpu_torch import demo
    from kcp_tpu_torch.ops.cuda_kernels import decide_and_match

    trace_dir = tempfile.mkdtemp(prefix="kcp-chip-smoke-trace-")
    decide_and_match.launches = 0
    try:
        out = demo.front_door_load(None, PLANE_LOGICAL, PLANE_PHYSICAL, FRONT_ROOTS,
                                   seed=8, trace_dir=trace_dir)
    except RuntimeError as err:
        fail(f"front door: {err}")
    torch.cuda.synchronize()
    launches = decide_and_match.launches
    window = out["aggregated_s"]
    in_ticks = sum(out["tick_phases_s"].values())
    lane = sorted(set(out["device_lane"].values()))
    print(f"front door: kcp start's Server (in memory, TLS off, 0.2 s polls, controllers "
          f"on the card) over {out['physical']} fake physical clusters, each registered over "
          f"REST by all {out['logical']} logical clusters ({out['syncers']} push syncers); "
          f"every import Compatible+Available, every cluster Ready {out['ready_s']:.2f} s "
          f"after the first registration; {out['roots']} roots POSTed in "
          f"{out['posted_s']:.2f} s -> {out['leaves']} leaves; first root POST -> last leaf "
          f"downstream {out['leaves_s']:.2f} s, -> last root aggregated (read over REST) "
          f"{window:.2f} s; leaves equal the CPU split; nothing quarantined [{card}]")
    print(f"front door: creates p50 {out['create_p50_ms']:.3f} ms p99 "
          f"{out['create_p99_ms']:.3f} ms (client side); admission_seconds "
          f"{out['admission_s']:.4f} s over {out['admissions']} admissions; "
          f"{out['ticks']} fleet ticks ({out['empty_ticks']} of them without synced rows), "
          f"decide_and_match launches {out['launches']} in the window ({launches} in the "
          f"phase); tick phases {in_ticks:.3f} s in all ("
          + " ".join(f"{k}={v:.3f}s" for k, v in sorted(out["tick_phases_s"].items()))
          + f"), outside the ticks {window - in_ticks:.3f} s; process CPU "
          f"{out['cpu_s']:.3f} s = {out['cpu_s'] / window * 100:.1f}% of the window [{card}]")
    print(f"front door: quota ledger device lane {lane} Deployments per logical cluster "
          f"(the leaves of its {out['physical']} push syncers), quota_usage_device "
          f"{out['usage_device']:.0f} on /metrics, {out['ledger_updates']:.0f} count batches "
          f"forwarded; /debug/trace started, wrote {out['trace']['trace']} "
          f"({os.path.getsize(out['trace']['trace'])} bytes) [{card}]")
    for i, call in enumerate(out["trace_calls"]):
        stalls = ", ".join(f"{x:.3f} s" for x in call["stalls_s"]) or "none"
        steps = " ".join(f"{k[:-2]}={v:.3f}s" for k, v in call["timings_s"].items())
        print(f"front door: /debug/trace call {i + 1} (seconds={call['seconds']}): "
              f"answered in {call['wall_s']:.3f} s ({steps}; warm-up and export off the "
              f"loop); /healthz meanwhile {call['healthz']} "
              f"round trips, slowest {call['healthz_max_ms']:.1f} ms; loop watchdog stalls "
              f"(> 1 s): {stalls}; trace holds {call['loop_cpu_ops']} CPU ops on the "
              f"loop's thread and {call['device_kernels']} device kernels [{card}]")
        if call["loop_cpu_ops"] == 0:
            fail(f"front door: /debug/trace call {i + 1} holds no CPU op of the loop")
    return launches


def _child(module: str, *args: str, env_extra: dict | None = None, stdin=None,
           inherit_kcp: bool = True):
    """A binary of the port as a child process, through ``WRAPPER``; with
    ``inherit_kcp`` false it sees none of this process's ``KCP_*``
    settings, only ``env_extra``'s."""
    env = {k: v for k, v in os.environ.items() if inherit_kcp or not k.startswith("KCP_")}
    env.update(env_extra or {}, PYTHONPATH=os.pathsep.join(
        p for p in (os.getcwd(), os.environ.get("PYTHONPATH", "")) if p))
    env.pop("KCP_DEVICE", None)  # no --device: each uses the card
    code = WRAPPER % (FORBIDDEN, module.rsplit(".", 1)[-1], module, module)
    return subprocess.Popen([sys.executable, "-c", code, *args], env=env, stdin=stdin,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _exit_report(proc, timeout: float = 60.0):
    """Wait for a ``WRAPPER`` child: (exit code, its EXIT report or None,
    its stdout, its stderr). Both pipes are read through their file objects, in
    threads while the child runs down: a ``readline()`` may already have
    read the EXIT line ahead into the object's buffer, where
    ``communicate()``, which reads the pipe itself, would not see it."""
    import threading

    got: dict[str, str] = {}
    readers = [threading.Thread(target=lambda k=k, f=f: got.__setitem__(k, f.read()),
                                daemon=True)
               for k, f in (("out", proc.stdout), ("err", proc.stderr))]
    for t in readers:
        t.start()
    if proc.stdin is not None:
        proc.stdin.close()
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    for t in readers:
        t.join(timeout)
    line = [x for x in got.get("out", "").splitlines() if x.startswith("EXIT ")]
    return (proc.returncode, json.loads(line[-1][5:]) if line else None, got.get("out", ""),
            got.get("err", ""))


def _check_exits(reports: dict, torch_ok: bool) -> None:
    """Fail unless every ``WRAPPER`` child in ``reports`` (name ->
    :func:`_exit_report`) exited 0 with its EXIT report, no JAX or
    JAX-package module loaded and, unless ``torch_ok``, no torch."""
    for name, (rc, report, _out, err) in reports.items():
        if rc != 0 or report is None or report["loaded"] or (report["torch"] and not torch_ok):
            fail(f"{name}: exit {rc}, report {report}; stderr: {err[-2000:]}")


def _first_line(proc, what: str, timeout: float = 120.0) -> str:
    """The URL of a child's 'serving at' line."""
    import select

    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    line = proc.stdout.readline() if ready else ""
    if "serving at" not in line:
        fail(f"{what}: no 'serving at' line (got {line!r}); stderr: "
             f"{proc.stderr.read()[-2000:] if proc.poll() is not None else '(running)'}")
    return line.strip().rsplit(" ", 1)[-1]


def _request(method: str, url: str, body: dict | None = None,
             headers: dict | None = None):
    """One HTTP round trip: (status, headers with lower-case names, the
    body parsed as JSON when it is an object, else its text)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, method=method, headers=headers or {},
                                 data=json.dumps(body).encode() if body else None)
    try:
        resp = urllib.request.urlopen(req, timeout=30)
    except urllib.error.HTTPError as err:
        resp = err
    with resp:
        raw = resp.read()
        return (resp.status, {k.lower(): v for k, v in resp.headers.items()},
                json.loads(raw) if raw[:1] == b"{" else raw.decode())


def _http(method: str, url: str, body: dict | None = None):
    """(status, body) of a round trip that must succeed."""
    import urllib.error

    status, _headers, doc = _request(method, url, body)
    if status >= 400:
        raise urllib.error.HTTPError(url, status, str(doc), None, None)
    return status, doc


def binaries_phase(card: str) -> None:
    """8b. The binaries in child processes on the card, without --device:
    ``kcp start`` with its controllers serves a create, a get, a wildcard
    list and /readyz and exits 0 on SIGTERM; kcp + physical kcp + a
    ``--backend fused`` syncer downsync a labelled object; two ring-named
    shards with controllers behind a router child serve routed and
    ring-verified direct creates and a merged wildcard list. No child
    loads JAX or the JAX package (each reports its modules as it
    exits)."""
    from kcp_tpu_torch.sharding.ring import owner_name

    t0 = time.perf_counter()
    procs = {}
    try:
        procs["kcp start"] = _child(
            "kcp_tpu_torch.cli.kcp", "start", "--in-memory", "--no-tls", "--listen-port",
            "0", "--poll-interval", "0.2")
        procs["kcp start (KCP_FLEET=1)"] = _child(
            "kcp_tpu_torch.cli.kcp", "start", "--in-memory", "--no-tls", "--listen-port",
            "0", "--poll-interval", "0.2", env_extra={"KCP_FLEET": "1"})
        for name in ("kcp", "physical kcp"):
            procs[name] = _child("kcp_tpu_torch.cli.kcp", "start", "--in-memory", "--no-tls",
                                 "--no-install-controllers", "--listen-port", "0")
        for i in range(2):
            procs[f"shard s{i}"] = _child(
                "kcp_tpu_torch.cli.kcp", "start", "--in-memory", "--no-tls", "--listen-port",
                "0", "--poll-interval", "0.2", "--role", "shard", "--shard-name", f"s{i}",
                "--ring-names", "s0,s1", "--ring-epoch", "1")
        kcp_url = _first_line(procs["kcp"], "kcp")
        phys_url = _first_line(procs["physical kcp"], "physical kcp")
        procs["syncer"] = _child(
            "kcp_tpu_torch.cli.syncer", "--from-server", kcp_url, "--from-cluster", "tenant",
            "--to-server", phys_url, "--to-cluster", "default", "--cluster", "east",
            "--backend", "fused", "configmaps")
        base = _first_line(procs["kcp start"], "kcp start")
        served_s = time.perf_counter() - t0
        path = "/api/v1/namespaces/default/configmaps"
        status, _ = _http("POST", f"{base}/clusters/t{path}",
                          {"metadata": {"name": "front"}, "data": {"a": "1"}})
        got = _http("GET", f"{base}/clusters/t{path}/front")[1]
        items = _http("GET", f"{base}/clusters/*{path}")[1]["items"]
        ready = _http("GET", f"{base}/readyz")[1]
        if status != 201 or got["data"] != {"a": "1"} or [
                o["metadata"]["name"] for o in items] != ["front"] or ready != "ok":
            fail(f"kcp start: create {status}, get {got}, list {items}, readyz {ready}")
        fleet_base = _first_line(procs["kcp start (KCP_FLEET=1)"], "kcp start (KCP_FLEET=1)")
        status, _ = _http("POST", f"{fleet_base}/clusters/t{path}",
                          {"metadata": {"name": "fleet"}, "data": {"a": "1"}})
        ready = _http("GET", f"{fleet_base}/readyz")[1]
        up = [line for line in _http("GET", f"{fleet_base}/metrics")[1].splitlines()
              if line.startswith("fleet_scheduler_up ")]
        if status != 201 or ready != "ok" or up != ["fleet_scheduler_up 1"]:
            fail(f"kcp start (KCP_FLEET=1): create {status}, readyz {ready}, {up}")
        shard_urls = [_first_line(procs[f"shard s{i}"], f"shard s{i}") for i in range(2)]
        procs["router"] = _child(
            "kcp_tpu_torch.cli.kcp", "start", "--in-memory", "--no-tls", "--listen-port", "0",
            "--role", "router", "--shards", f"s0={shard_urls[0]},s1={shard_urls[1]}")
        router_url = _first_line(procs["router"], "router")
        owner = int(owner_name(["s0", "s1"], "t")[1:])
        routed = _request("POST", f"{router_url}/clusters/t{path}",
                          {"metadata": {"name": "routed"}, "data": {"a": "1"}})[0]
        stamp = {"X-Kcp-Ring-Epoch": "1", "Content-Type": "application/json"}
        direct = _request("POST", f"{shard_urls[owner]}/clusters/t{path}",
                          {"metadata": {"name": "direct"}, "data": {"a": "2"}}, stamp)[0]
        stale, stale_headers, stale_doc = _request(
            "POST", f"{shard_urls[1 - owner]}/clusters/t{path}",
            {"metadata": {"name": "stale"}, "data": {"a": "3"}}, stamp)
        merged = sorted(o["metadata"]["name"]
                        for o in _http("GET", f"{router_url}/clusters/*{path}")[1]["items"])
        if (routed, direct, stale, stale_headers.get("x-kcp-ring-epoch"), merged) != (
                201, 201, 410, "1", ["direct", "routed"]):
            fail(f"router + shards: routed create {routed}, direct create on the owner "
                 f"{direct}, on the other shard {stale} {stale_headers} {stale_doc}, "
                 f"wildcard list {merged}")
        _http("POST", f"{kcp_url}/clusters/tenant{path}",
              {"metadata": {"name": "synced-cm", "labels": {"kcp.dev/cluster": "east"}},
               "data": {"from": "kcp"}})
        deadline, down = time.monotonic() + 120, None
        while time.monotonic() < deadline and down is None:
            if procs["syncer"].poll() is not None:
                fail(f"syncer died: {procs['syncer'].stderr.read()[-2000:]}")
            try:
                down = _http("GET", f"{phys_url}/clusters/default{path}/synced-cm")[1]
            except OSError:
                time.sleep(0.2)
        if down is None or down["data"] != {"from": "kcp"}:
            fail(f"three-process pipeline: the object never downsynced ({down})")
        synced_s = time.perf_counter() - t0
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        exits = {name: _exit_report(p) for name, p in procs.items()}
    _check_exits(exits, torch_ok=True)
    if exits["syncer"][1]["launches"] == 0:
        fail("syncer --backend fused: decide_and_match never launched in the child")
    print(f"binaries: kcp start with controllers served create/get/wildcard list/readyz "
          f"{served_s:.2f} s after launch; kcp + physical kcp + syncer --backend fused "
          f"downsynced the object {synced_s:.2f} s after launch (the syncer's child "
          f"launched decide_and_match {exits['syncer'][1]['launches']} times); kcp start "
          f"with KCP_FLEET=1 served a create and /readyz with fleet_scheduler_up 1; a "
          f"router child over two ring-named shard children with controllers: routed "
          f"create 201, ring-stamped direct create 201 on the owner s{owner} and 410 with "
          f"X-Kcp-Ring-Epoch 1 on s{1 - owner}, wildcard list through the router "
          f"{merged}; all {len(exits)} children exited 0 on SIGTERM with no "
          f"jax/jaxlib/kcp_tpu module loaded; torch loaded by "
          f"{sorted(n for n, (_rc, r, _o, _e) in exits.items() if r['torch'])} [{card}]")


def solver_phase(torch, dev, card: str):
    """9a. ``FleetSolver`` on the card at the placement benchmark's shape
    (``kcp_tpu_torch.bench.placement_bench``): checks its assignment, the
    incremental re-solve and the sharded solve, prints the host-clock
    readings, and returns one solve on the card for the profiler."""
    from kcp_tpu_torch.bench import placement_bench, placement_inputs
    from kcp_tpu_torch.fleet.solver import FleetSolver, solve_host, solve_sharded
    from kcp_tpu_torch.ops.encode import pad_pow2

    out = placement_bench(dev, W=PLACE_W, P=PLACE_P, spread=PLACE_SPREAD, iters=PLACE_ITERS)
    pb, inc = out["placement_bench"], out["placement_bench"]["incremental"]
    if not (pb["assignment_equal_host"] and pb["assignment_equal_per_workspace"]):
        fail(f"solver: the card's assignment differs from solve_host: {pb}")
    if pb["overcommit_rows"] or pb["noncandidate_replicas"]:
        fail(f"solver: {pb['overcommit_rows']} rows over demand, "
             f"{pb['noncandidate_replicas']} replicas off a candidate")
    if inc["rows_solved"] != inc["dirty_rows"] or inc["mismatches"]:
        fail(f"solver: incremental re-solve {inc}")
    x = placement_inputs(PLACE_W, PLACE_P)
    args = [x[k] for k in ("demand", "cand", "alloc", "region", "home")]
    host = solve_host(*args, PLACE_SPREAD)
    sharded = solve_sharded(smoke_mesh("4", dev), *args, PLACE_SPREAD)
    if not np.array_equal(sharded, host):
        fail("solver: solve_sharded over mesh 4 differs from the unsharded solve")
    print(f"solver: FleetSolver on {out['device']} at {PLACE_W} workspaces x {PLACE_P} "
          f"physical clusters (padded to {pad_pow2(PLACE_W)} x {pad_pow2(PLACE_P)}), spread "
          f"{PLACE_SPREAD}: assignment byte-equal to solve_host ({pb['total_replicas']} "
          f"replicas), 0 rows over demand, 0 replicas off a candidate; incremental re-solve "
          f"of {inc['dirty_rows']} dirty rows solved {inc['rows_solved']} rows, "
          f"{inc['mismatches']} mismatches; solve_sharded over mesh 4 (cuda:0 x4) equal "
          f"[{card}]")
    print(f"solver: one solve {pb['batched_ms_median']:.3f} ms median, {pb['batched_ms']:.3f} "
          f"ms mean of {PLACE_ITERS} after a warm-up (host clock, the copy back is its sync) "
          f"[{card}]; the per-workspace host loop (solve_host per row, the card machine's "
          f"CPU) {pb['per_workspace_ms']:.3f} ms for {PLACE_W} rows")
    solver = FleetSolver(spread=PLACE_SPREAD, device=dev)
    return lambda: solver.solve(*args)


def solver_device_phase(solve, torch, card: str, calls: int = 5) -> None:
    """9a, the profiler's half: device ms and device events per solve."""
    solve()
    _wall, ev = device_profile(lambda: [solve() for _ in range(calls)], torch)
    if not ev:
        print("solver: the profiler saw no device time: device ms not measured")
        return
    n = sum(c for c, _us in ev.values()) / calls
    us = sum(u for _c, u in ev.values()) / calls
    top = sorted(ev.items(), key=lambda kv: -kv[1][1])[:4]
    print(f"solver: per solve {us / 1e3:.4f} ms of device time in {n:.1f} device events "
          f"(torch.profiler, {calls} solves); top: "
          + "; ".join(f"{k[:50]} x{c / calls:.0f} {u / calls:.1f} us" for k, (c, u) in top)
          + f" [{card}]")


def fleet_phase(torch, card: str) -> int:
    """9b. Fleet placement through kcp start's server on the card:
    ``kcp_tpu_torch.demo.fleet_front_door_load`` checks every leaf against
    ``solve_host``, a launch per fleet tick with rows, and the capacity
    change's row set, and raises on the first check that fails. Returns
    the phase's kernel launches."""
    from kcp_tpu_torch import demo
    from kcp_tpu_torch.ops.cuda_kernels import decide_and_match

    decide_and_match.launches = 0
    try:
        out = demo.fleet_front_door_load(None, PLANE_LOGICAL, PLANE_PHYSICAL, FLEET_ROOTS,
                                         seed=9)
    except RuntimeError as err:
        fail(f"fleet placement: {err}")
    torch.cuda.synchronize()
    launches = decide_and_match.launches
    if launches == 0:
        fail("fleet placement: decide_and_match never launched")
    cc = out["capacity_change"]
    print(f"fleet placement: kcp start (Config(fleet=True), spread {out['spread']}) over "
          f"{out['physical']} fake physical clusters registered by {out['logical']} logical "
          f"clusters with seeded capacities and regions; {out['roots']} roots POSTed in "
          f"{out['posted_s']:.2f} s -> {out['leaves']} leaves; first root POST -> every leaf "
          f"equal to solve_host (read over REST) {out['placed_s']:.2f} s, -> every leaf "
          f"downstream {out['downstream_s']:.2f} s; {out['ticks']} fleet ticks "
          f"({out['empty_ticks']} without rows), decide_and_match launches "
          f"{out['launches']} in the window ({launches} in the phase) [{card}]")
    print(f"fleet placement: fleet_solve_seconds {out['fleet_solve_s']:.4f} s over "
          f"{out['fleet_solves']} solves in the window ("
          f"{out['fleet_solve_s'] / max(out['fleet_solves'], 1) * 1e3:.3f} ms each); "
          f"scheduler {out['scheduler']}; solver {out['solver']} [{card}]")
    print(f"fleet placement: {cc['registration']} allocatable -> {cc['allocatable']} over "
          f"REST: leaves equal solve_host again {cc['replaced_s']:.2f} s later, "
          f"{cc['leaves_changed']} logical cluster's leaves moved; {cc['solves']} solves "
          f"after it, the first of {cc['first_solve_rows']} rows (that logical cluster's "
          f"roots), every one within it; rows_solved rose {cc['rows_solved']} [{card}]")
    return launches


def sharded_phase(torch, card: str) -> int:
    """10. Phase 8's layout over a sharded control plane:
    ``kcp_tpu_torch.demo.sharded_front_door_load`` on the card checks the
    leaves, each tenant's shard, the aggregated roots, the merged watch
    and its resume, the router's wildcard list and every shard core's
    launches, and raises on the first check that fails. Returns the
    phase's kernel launches."""
    from kcp_tpu_torch import demo
    from kcp_tpu_torch.ops.cuda_kernels import decide_and_match

    decide_and_match.launches = 0
    try:
        out = demo.sharded_front_door_load(None, PLANE_LOGICAL, PLANE_PHYSICAL, SHARDED_ROOTS,
                                           SHARDS, seed=10)
    except RuntimeError as err:
        fail(f"sharded front door: {err}")
    torch.cuda.synchronize()
    launches = decide_and_match.launches
    window = out["aggregated_s"]
    lat = out["create_ms"]
    proxy_n, proxy_p50, proxy_p99 = out["router_proxy"]
    print(f"sharded front door: {out['shards']} durable shards (a WAL, a loop, a FusedCore "
          f"and controllers on the card each) behind a router; {out['physical']} fake "
          f"physical clusters registered through the router by {out['logical']} logical "
          f"clusters, every import Compatible+Available and cluster Ready "
          f"{out['ready_s']:.2f} s after the first registration; {out['roots']} roots "
          f"POSTed in {out['posted_s']:.2f} s -> {out['leaves']} leaves; first root POST "
          f"-> last leaf downstream {out['leaves_s']:.2f} s, -> last root aggregated "
          f"(through the router) {window:.2f} s; leaves equal the CPU split, each tenant's "
          f"objects on its HRW shard only [{card}]")
    print(f"sharded front door: creates direct (SmartRestClient) p50 "
          f"{lat['direct'][1]:.3f} ms p99 {lat['direct'][2]:.3f} ms over {lat['direct'][0]}, "
          f"routed p50 {lat['routed'][1]:.3f} ms p99 {lat['routed'][2]:.3f} ms over "
          f"{lat['routed'][0]} (client side); smart_client_direct_total +"
          f"{out['smart_direct']:.0f}, fallbacks {out['smart_fallback']:.0f}; "
          f"router_proxy_seconds over the POSTs: {proxy_n} relays, p50 <= {proxy_p50} s, "
          f"p99 <= {proxy_p99} s (bucket edges); router_scatter_fanout over the phase "
          f"{out['router_fanout'][0]} scatters, p50 <= {out['router_fanout'][1]} shards; "
          f"process CPU {out['cpu_s']:.3f} s = {out['cpu_s'] / window * 100:.1f}% of the "
          f"window [{card}]")
    for sh in out["per_shard"]:
        print(f"sharded front door: shard {sh['shard']}: {len(sh['logical'])} logical "
              f"clusters ({', '.join(sh['logical'])}), {sh['ticks']} fleet ticks "
              f"({sh['empty_ticks']} without rows), decide_and_match launches "
              f"{sh['launches']}, {sh['leaves']} leaves [{card}]")
    print(f"sharded front door: merged watch saw {out['watch_events']} events, each root's "
          f"ADDED once; the watch resumed from the vector RV of the event seen halfway "
          f"yielded the {out['resumed_events']} after it, shard by shard; the router's "
          f"wildcard list equals the shards' own byte for byte; decide_and_match launches "
          f"{launches} in the phase [{card}]")
    return launches


class FullCollections:
    """Times every full (generation-2) garbage collection of the process
    through ``gc.callbacks``: the ms each one stalled every thread."""

    def __init__(self) -> None:
        self.pauses_ms: list[float] = []
        self._began = 0.0
        gc.callbacks.append(self._observe)

    def _observe(self, phase: str, info: dict) -> None:
        if info["generation"] != 2:
            return
        if phase == "start":
            self._began = time.perf_counter()
        else:
            self.pauses_ms.append((time.perf_counter() - self._began) * 1e3)

    def since(self, mark: int) -> str:
        p = self.pauses_ms[mark:]
        return (f"{len(p)} full collections, longest {max(p, default=0.0):.1f} ms, "
                f"{sum(p):.1f} ms in all")


def freeze_heap() -> None:
    """Collect the process's heap once and freeze what survives, so that
    full collections during phase 11 scan only what it allocates; prints
    the collection's time and the objects it left. ``gc.unfreeze()``
    after phase 11 gives the heap back to the collector."""
    t0 = time.perf_counter()
    gc.collect()
    took = time.perf_counter() - t0
    gc.freeze()
    print(f"heap: a full collection took {took * 1e3:.1f} ms; {gc.get_freeze_count()} "
          f"objects frozen for phase 11")


def _scenario_core_reading() -> tuple[int, int, int]:
    """On a scenario server's loop: the fleet batch's ticks and ticks
    without rows of the loop's ``FusedCore`` (the one its controllers
    share), and the kernel launches made from the loop's thread."""
    import asyncio
    import threading

    from kcp_tpu_torch.ops.cuda_kernels import decide_and_match
    from kcp_tpu_torch.syncer.core import FusedCore

    core = FusedCore._instances.get(id(asyncio.get_running_loop()))
    fleet = core._fleet if core is not None else None
    stats = fleet.stats if fleet is not None else {}
    return (stats.get("ticks", 0), stats.get("empty_ticks", 0),
            decide_and_match.by_thread.get(threading.get_ident(), 0))


def scenario_phase(torch, card: str) -> int:
    """11. The scenario harness on the card, through
    ``kcp_tpu_torch.scenarios.run_scenario(..., device=None)`` at seed 42
    and scale 1.0 (the catalog's full shape): ``capacity-skew-binpack``
    (the engine-side solver on the card), ``fleet-churn`` (controllers and
    the fleet scheduler on the monolith's ``FusedCore``; a kernel launch
    per fleet tick with rows), ``crd-churn`` (controllers on the card) and
    ``crud-churn`` with tracing on (``KCP_TRACE=1``, ``KCP_TRACE_SAMPLE=1``:
    the scorecard carries the slowest assembled traces of each phase, with
    ``conv.write``, ``server.request`` and ``store.commit``; ``store.fanout``
    rides only the trace whose event led its fan-out batch, so it is
    looked for among every trace of the run's span buffer, assembled with
    ``obs.assemble.summarize_trace``). Each must pass every SLO with the
    schedule hash of ``SCENARIOS_r07.json``. Each monolith's core is
    read on its loop as the topology stops (the harness's ``make_topology``
    wrapped to observe, nothing else changed). Returns the phase's kernel
    launches."""
    import tempfile

    from kcp_tpu_torch import obs
    from kcp_tpu_torch.obs import assemble
    from kcp_tpu_torch.ops.cuda_kernels import decide_and_match
    from kcp_tpu_torch.scenarios import SCENARIOS, engine, run_scenario

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "SCENARIOS_r07.json")) as f:
        reference = {r["name"]: r for r in json.load(f)["scenarios"]}
    readings: dict = {}
    buffered: list = []
    make_topology = engine.make_topology

    def observed_topology(spec, root_dir, device=None):
        topology = make_topology(spec, root_dir, device)
        stop = topology.stop

        def stop_after_reading():
            server = getattr(topology, "server", None)
            if server is not None and server.server._controllers:
                readings[spec.name] = server.call(_scenario_core_reading)
            stop()

        topology.stop = stop_after_reading
        return topology

    def run(name: str, traced: bool = False) -> tuple[dict, int]:
        keys = ("KCP_TRACE", "KCP_TRACE_SAMPLE")
        if traced:
            os.environ.update(KCP_TRACE="1", KCP_TRACE_SAMPLE="1")
            obs.TRACER.reconfigure()
        decide_and_match.launches = 0
        decide_and_match.by_thread.clear()
        try:
            with tempfile.TemporaryDirectory(prefix="kcp-chip-smoke-scenario-") as wd:
                r = run_scenario(SCENARIOS[name], seed=42, scale=1.0, workdir=wd, device=None)
            if traced:  # the run's span buffer (the servers run in this process)
                by_trace: dict = {}
                for span in obs.TRACER.spans():
                    by_trace.setdefault(span["trace"], []).append(span)
                buffered.extend(assemble.summarize_trace(v, k) for k, v in by_trace.items())
        finally:
            if traced:
                for k in keys:
                    os.environ.pop(k, None)
                obs.TRACER.reconfigure()
        torch.cuda.synchronize()
        launches = decide_and_match.launches
        missed = [f"{row['name']} ({row['metric']} {row['op']} {row['target']}, observed "
                  f"{row['observed']})" for row in r["slos"] if not row["passed"]]
        if not r["passed"] or missed:
            fail(f"scenario {name}: {r.get('aborted') or '; '.join(missed)}")
        want = reference[name]["schedule"]["hash"]
        if r["schedule"]["hash"] != want:
            fail(f"scenario {name}: schedule hash {r['schedule']['hash']} != {want} "
                 f"(SCENARIOS_r07.json)")
        m = r["measurements"]
        print(f"scenario {name}: passed {len(r['slos'])} of {len(r['slos'])} SLOs in "
              f"{m['duration_s']} s, schedule {r['schedule']['hash']} (= SCENARIOS_r07.json), "
              f"{r['schedule']['ops']} ops, decide_and_match launches {launches} [{card}]")
        return r, launches

    engine.make_topology = observed_topology
    try:
        r, launches_place = run("capacity-skew-binpack")
        m = r["measurements"]
        print(f"scenario capacity-skew-binpack: {m['placement_rows']} x "
              f"{m['placement_pclusters']} solve on the card placement_batched_ms "
              f"{m['placement_batched_ms']} (host clock), placement_host_ms "
              f"{m['placement_host_ms']}; mismatches {m['placement_mismatches']}, overcommit "
              f"rows {m['placement_overcommit_rows']}, non-candidate replicas "
              f"{m['placement_noncandidate_replicas']}, incremental extra rows "
              f"{m['placement_incremental_extra_rows']} [{card}]")

        r, launches_fleet = run("fleet-churn")
        m = r["measurements"]
        ticks, empty, on_loop = readings.get("fleet-churn", (0, 0, 0))
        if launches_fleet == 0 or on_loop < ticks - empty:
            fail(f"scenario fleet-churn: decide_and_match launches {launches_fleet} "
                 f"({on_loop} on the server loop) for {ticks} fleet ticks, {empty} of "
                 f"them without rows")
        print(f"scenario fleet-churn: fleet_flaps {m['fleet_flaps']}, fleet_storm_churn "
              f"{m['fleet_storm_churn']}, assignment_mismatches "
              f"{m['assignment_mismatches']}, placement_resolves {m['placement_resolves']}; "
              f"{ticks} fleet ticks ({empty} without rows), decide_and_match launches "
              f"{on_loop} on the server loop ({launches_fleet} in the scenario) [{card}]")

        r, launches_crd = run("crd-churn")
        ticks, empty, on_loop = readings.get("crd-churn", (0, 0, 0))
        print(f"scenario crd-churn: crd_servable_p99_ms "
              f"{r['measurements']['crd_servable_p99_ms']}, crd_teardown_p99_ms "
              f"{r['measurements']['crd_teardown_p99_ms']}; {ticks} fleet ticks ({empty} "
              f"without rows) [{card}]")

        r, launches_crud = run("crud-churn", traced=True)
    finally:
        engine.make_topology = make_topology
    traces = [t for phase in (r.get("traces") or {}).values() for t in phase]
    names = {n for t in traces for n in t.get("names", [])}
    need = {"conv.write", "server.request", "store.commit"}
    print("scenario crud-churn (traced): the scorecard's traces, per phase: " + "; ".join(
        f"{phase}: " + ", ".join(f"{t['dur_ms']} ms {t['spans']} spans slowest "
                                 f"{t['slowest_span']['name']} {t['slowest_span']['dur_ms']} ms"
                                 for t in ts)
        for phase, ts in (r.get("traces") or {}).items()))
    if not traces or not need <= names:
        fail(f"scenario crud-churn (traced): {len(traces)} assembled traces, span names "
             f"{sorted(names)} lack {sorted(need - names)}")
    fanned = [t for t in buffered if need | {"store.fanout"} <= set(t["names"])]
    if not fanned:
        fail(f"scenario crud-churn (traced): none of the {len(buffered)} assembled traces "
             f"of the span buffer holds conv.write, server.request, store.commit and "
             f"store.fanout")
    print(f"scenario crud-churn (KCP_TRACE=1, KCP_TRACE_SAMPLE=1): p99_convergence_ms "
          f"{r['measurements']['p99_convergence_ms']}; the scorecard's {len(traces)} "
          f"assembled traces over {len(r['traces'])} phases (slowest "
          f"{max(t['dur_ms'] for t in traces)} ms) hold {sorted(names)}, "
          f"{sum('store.fanout' in t['names'] for t in traces)} of them store.fanout; "
          f"{len(fanned)} of the {len(buffered)} traces in the span buffer hold all four "
          f"[{card}]")
    return launches_place + launches_fleet + launches_crd + launches_crud


def fleet_ab_phase(torch, dev, card: str, gcs: FullCollections) -> int:
    """12. The ``--fleet`` lane on the card at its full default shape,
    through ``kcp_tpu_torch.bench.measure_fleet("cuda")`` (131,072 x 64,
    16,384 x 32 and 2,048 x 16 buckets plus 24 straggler sections of 1-4
    rows in an 8-slot bucket, 40 steps after 8 warm-up, a tenth of each
    bucket's first 4,096 rows churned a step, seed 7): per-bucket dispatch
    (the kernel's 3-output form once per bucket and tick, at S = 64, 32,
    16 and 8) then ragged (its fleet form once per tick), then the
    poison-row quarantine drill. Fails unless the per-owner patch streams
    are equal, the drill is green, rows per dispatch gain at least 2x (the
    reference CI's floor) and each mode launched the kernel once per
    dispatch, warm-up included. Every shape the run gives the wrapper
    (form, B, S, L, C, mask, segment capacity; the step's name for it is
    wrapped to observe) is then held against the plain version, exact, on
    the inputs of its first launch (copied as it launched) and on seeded
    inputs of that shape, which fail if vacuous. Returns the phase's
    kernel launches."""
    from kcp_tpu_torch import bench
    from kcp_tpu_torch.models import reconcile_model as tm
    from kcp_tpu_torch.ops.cuda_kernels import decide_and_match

    warmup = int(os.environ.get("KCP_BENCH_FLEET_WARMUP", "8"))  # the lane's knob
    mode = ["per_bucket"]
    mark = [len(gcs.pauses_ms)]
    seen: dict = {}  # (mode, B, S, L, C, per-row mask, cap) -> the first launch's inputs
    launches: dict = {}

    def observed(*args):
        up, _upe, _down, _dne, mask, pair, sel, _seg, cap = args
        key = (mode[0], *up.shape, pair.shape[1], sel.shape[0], mask.ndim == 2, cap)
        if key not in seen:
            seen[key] = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
        return decide_and_match(*args)

    def on_mode(name: str, r: dict) -> None:
        torch.cuda.synchronize()
        launches[name] = decide_and_match.launches
        decide_and_match.launches = 0
        ticks = r["dispatches"] + warmup * (1 if name == "ragged" else r["buckets"])
        print(f"fleet A/B {name}: {r['rows']} rows in {r['buckets']} buckets, "
              f"{r['sections']} sections; {r['rows_per_sec']:.1f} rows/s, "
              f"{r['dispatches']} dispatches, {r['rows_per_dispatch']:.1f} rows per "
              f"dispatch, tick p50 {r['tick_ms_p50']:.3f} ms p99 {r['tick_ms_p99']:.3f} ms "
              f"(host clock; {gcs.since(mark[0])} in the mode), {r['patch_rows']} patch "
              f"rows; decide_and_match launches {launches[name]} for {ticks} dispatches "
              f"with warm-up [{card}]")
        if launches[name] != ticks:
            fail(f"fleet A/B {name}: {launches[name]} decide_and_match launches for "
                 f"{ticks} dispatches")
        mode[0] = "ragged" if name == "per_bucket" else "drill"
        mark[0] = len(gcs.pauses_ms)

    decide_and_match.launches = 0
    tm.decide_and_match = observed
    try:
        head = asyncio.run(bench.measure_fleet("cuda", on_mode=on_mode))
    finally:
        tm.decide_and_match = decide_and_match
    torch.cuda.synchronize()
    drill_launches = decide_and_match.launches
    fb = head["fleet_bench"]
    drill = fb["quarantine_drill"]
    if not fb["streams_equal"]:
        fail("fleet A/B: ragged and per-bucket patch streams differ")
    if not drill["ok"]:
        fail(f"fleet A/B: quarantine drill failed: {drill}")
    if head["value"] < 2.0:
        fail(f"fleet A/B: rows per dispatch gain {head['value']}x < 2.0x")
    print(f"fleet A/B: rows per dispatch gain {head['value']}x (floor 2.0), combined "
          f"speed-up {fb['combined_speedup']}x (printed, not held), streams equal over "
          f"{fb['sections']} owners; quarantine drill {drill} with {drill_launches} "
          f"launches [{card}]")
    # the phase's shapes against the plain version (after the counts were read)
    rng = np.random.default_rng(2026)
    for (name, b, s, l, c, per_row, cap), args in seen.items():
        fleet = args[7] is not None
        kw = dict(seg_ids=args[7], seg_capacity=cap) if fleet else {}
        label = (f"decide_and_match [phase 12 {name}{', fleet form' if fleet else ''}: "
                 f"B={b} S={s} mask={'row' if per_row else 'bucket'} L={l} C={c}"
                 f"{f' cap={cap}' if fleet else ''}]")
        got, _err, _plan = check_case(label, args[:7], kw, torch, vacuous_fails=False)
        run_rows = int(got[0].ne(0).sum())
        case = kernel_case(rng, b, s, l, c, per_row, torch, dev)
        seeded = dict(seg_ids=segments(rng, b, torch, dev, cap), seg_capacity=cap) if fleet \
            else {}
        _got, _err, plan = check_case(f"{label} seeded", case, seeded, torch)
        print(f"kernel {label}: equal (tolerance: exact) on the run's inputs ({run_rows} "
              f"rows decided) and on seeded inputs; {plan_text(plan)} [{card}]")
    del seen
    return sum(launches.values()) + drill_launches


def gauntlet_phase(torch, card: str) -> None:
    """13. The gauntlet's controller config on the card:
    ``kcp_tpu_torch.bench.gauntlet_bench(device=None)`` with
    ``KCP_GAUNTLET_CONFIGS=3`` (``gauntlet-crd-5k``: a monolith whose
    controllers hash schemas on the card) at scale 1/50 (100 tenants),
    its relist A/B at the reference CI's 2,000 objects in pages of 250
    (the knobs are set in this process's environment; nothing later reads
    them). Fails on a row that did not pass, a degraded scorecard, or a
    row whose device is not the card. Then the port's lint gate over its
    default targets (``kcp_tpu_torch/``, ``chip_smoke.py``), which must
    be clean."""
    from kcp_tpu_torch import bench
    from kcp_tpu_torch.analysis import run_lint

    os.environ.update(KCP_GAUNTLET_CONFIGS="3", KCP_GAUNTLET_SCALE="50",
                      KCP_BENCH_PAG_OBJECTS="2000", KCP_BENCH_PAG_PAGE="250")
    for k in ("KCP_GAUNTLET_SOAK", "KCP_GAUNTLET_OPS"):
        os.environ.pop(k, None)
    t0 = time.perf_counter()
    card_row = bench.gauntlet_bench(None)
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    rows = card_row["rows"]
    if card_row.get("degraded") or len(rows) != 1 or not rows[0].get("passed"):
        fail(f"gauntlet config 3: {json.dumps(card_row)[:2000]}")
    row = rows[0]
    if not str(row.get("device")).startswith("cuda"):
        fail(f"gauntlet config 3: controllers on {row.get('device')}, not the card")
    print(f"gauntlet [3] {row['name']} at {row['scale']}: passed {len(row['slos'])} of "
          f"{len(row['slos'])} SLOs, {row['tenants']} tenants, reconciles/s "
          f"{row['reconciles_per_sec']}, convergence p99 {row['convergence_p99_ms']} ms, "
          f"lost acked writes {row['lost_acked_writes']}, memory growth "
          f"{row['memory_growth_ratio']}, {row['duration_s']} s; controllers on "
          f"{row['device']}; relist A/B {card_row['relist']['pages']} pages, bytes equal "
          f"{card_row['relist']['bytes_equal']}; {took:.1f} s [{card}]")
    report = run_lint(os.path.dirname(os.path.abspath(__file__)))
    if not report.ok or report.unused_waivers:
        fail("lint gate:\n" + report.render())
    print(f"lint gate: {len(report.findings)} findings, {len(report.waived)} waived, "
          f"{report.files_checked} files (kcp_tpu_torch/, chip_smoke.py)")


def suite_seeded(ab, rng):
    """The suite A/B's inputs (numpy, the lane's) with ~3% spec-dirty, ~2%
    status-dirty, ~2% deleted and ~2% not-yet-created rows, and ~30% of
    rows carrying a selector among their pair hashes."""
    up, upe, down, dne, mask, pair, sels = (np.array(a) for a in ab)
    b = up.shape[0]
    down[rng.random(b) < 0.03, 0] ^= 1
    down[rng.random(b) < 0.02, -1] ^= 1
    upe[rng.random(b) < 0.02] = False
    dne[rng.random(b) < 0.02] = False
    hit = rng.random(b) < 0.3
    pair[hit, rng.integers(0, pair.shape[1], int(hit.sum()))] = rng.choice(sels, int(hit.sum()))
    return up, upe, down, dne, mask, pair, sels


def suite_phase(torch, dev, card: str, timed: list, compiled_timed: list) -> int:
    """14. ``python -m kcp_tpu_torch.bench --suite``'s lane on the card at
    its default shape (``kcp_tpu_torch.bench.suite("cuda")``): BASELINE
    configs[2..4] and the decision+fanout A/B at B = 131,072, S = 64, L = 8,
    C = 64, bucket-wide mask; eager, ``torch.compile``-d (the compile in a
    warm-up call of its own) and the kernel, whose 91 launches (a warm-up
    and 3 x 30) are the phase's count. Then the kernel at that shape
    against ``decide_and_match_plain``, exact, on the lane's inputs and on
    a seeded case of them (about 30% selector hits; fails if vacuous), and
    ``torch.compile(decide_and_match_plain)`` against the plain version,
    exact, at that shape and at the serving fleet form (phase 3's
    ``SERVING``, seg_ids, cap 8); each shape's kernel, compiled and plain
    times (CUDA events) and its bound. The suite shape's kernel joins
    ``timed`` and both shapes' compiled compositions ``compiled_timed``, so
    that their device times are read with the profiler after the main
    path. Returns the lane's kernel launches."""
    from kcp_tpu_torch import bench
    from kcp_tpu_torch.models import reconcile_model as tm
    from kcp_tpu_torch.ops.cuda_kernels import decide_and_match, decide_and_match_plain

    os.environ.pop("KCP_BENCH_ROWS", None)  # the lane's default rows
    # inductor compiles in this process: no pool of compile workers outlives it
    os.environ["TORCHINDUCTOR_COMPILE_THREADS"] = "1"
    decide_and_match.launches = 0
    t0 = time.perf_counter()
    out = bench.suite("cuda")
    torch.cuda.synchronize()
    launches = decide_and_match.launches
    took = time.perf_counter() - t0
    if launches != 91:
        fail(f"suite: decide_and_match launched {launches} times for 1 + 3 x 30 calls")
    names = [r["lane"] for r in out["suite"]]
    if names != ["splitter bin-packing", "schema hash bucketing", "label fan-out",
                 "decision+fanout eager", "decision+fanout torch.compile",
                 "decision+fanout CUDA"] or out["device"] != "cuda":
        fail(f"suite: rows {names} on {out['device']}")
    for r in out["suite"]:
        print(f"suite {r['lane']} ({r['scale']}): {r['rate']}; "
              f"{out['seconds'][r['lane']] * 1e3:.4f} ms per call (host clock, the median "
              f"of 3 averages over 30 calls) [{card}]")
    print(f"suite: torch.compile's warm-up call {out['compile_s']:.2f} s (outside every "
          f"rate); decide_and_match launches {launches}; the lane {took:.1f} s [{card}]")

    x = bench.suite_inputs(131072)
    lane = tuple(tm.to_device(a, dev) for a in x["ab"])
    got, _err, _plan = check_case("suite A/B, the lane's inputs", lane, {}, torch,
                                  vacuous_fails=False)
    lane_rows, lane_hits = int(got[0].ne(0).sum()), int(got[2].sum())
    seeded = tuple(tm.to_device(a, dev) for a in suite_seeded(x["ab"],
                                                              np.random.default_rng(2027)))
    _got, err, plan = check_case("suite A/B, seeded", seeded, {}, torch)
    print(f"kernel decide_and_match [suite: B=131072 S=64 mask=bucket L=8 C=64]: equal "
          f"(tolerance: exact) on the lane's inputs ({lane_rows} rows decided, {lane_hits} "
          f"selector hits: the lane's downstream mirror is its upstream's copy) and on "
          f"seeded inputs (max abs err {err}); {plan_text(plan)} [{card}]")
    del lane
    rng = np.random.default_rng(2028)
    serving = kernel_case(rng, **SERVING, torch=torch, dev=dev)
    serving_kw = dict(seg_ids=segments(rng, SERVING["b"], torch, dev), seg_capacity=SEG_CAPACITY)
    compiled = torch.compile(decide_and_match_plain, dynamic=False)
    for name, case, kw in (("suite: B=131072 S=64 mask=bucket L=8 C=64", seeded, {}),
                           (f"serving, fleet form: B={SERVING['b']} S={SERVING['s']} "
                            f"mask=row L={SERVING['l']} C={SERVING['c']} cap={SEG_CAPACITY}",
                            serving, serving_kw)):
        t0 = time.perf_counter()
        got_c = compiled(*case, **kw)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        want = decide_and_match_plain(*case, **kw)
        for label, g, w in zip(("decision", "upsync", "counts", "seg_counts"), got_c, want):
            if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
                fail(f"torch.compile [{name}]: {label} differs from the plain version")
        kernel_ms = time_ms(lambda case=case, kw=kw: decide_and_match(*case, **kw), torch, 50)
        compiled_ms = time_ms(lambda case=case, kw=kw: compiled(*case, **kw), torch, 50)
        plain_ms = time_ms(lambda case=case, kw=kw: decide_and_match_plain(*case, **kw),
                           torch, 10)
        inputs = (*case, kw["seg_ids"]) if kw else case
        bound_ms, bound_by, nbytes = bound(inputs, want)
        print(f"[{name}] kernel {kernel_ms:.4f} ms, torch.compile {compiled_ms:.4f} ms "
              f"(compiled equal to the plain version, exact; its first call {compile_s:.2f} s), "
              f"plain {plain_ms:.4f} ms per back-to-back call (events), bound "
              f"{bound_ms:.4f} ms by {bound_by} ({nbytes} B); kernel/compiled "
              f"{compiled_ms / kernel_ms:.2f}x [{card}]")
        label = f"decide_and_match [phase 14 {name}]"
        if not kw:  # the serving shape's kernel is timed from phase 3
            timed.append((label, lambda case=case: decide_and_match(*case), 1, bound_ms,
                          None))
        compiled_timed.append((f"torch.compile(decide_and_match_plain) [phase 14 {name}]",
                               lambda case=case, kw=kw: compiled(*case, **kw), None, bound_ms,
                               None))
    torch.cuda.synchronize()
    return launches


#: runs of each lane whose gate reads a host timing (--sharded's capacity
#: speedup, --admission's overhead and quiet p99 ratio): one run of either
#: lane at scripts/ci.sh's shape misses its floor in about one of five on the
#: card machine, the reference's lanes as often as the port's (ROADMAP C3,
#: C5, C6), so the floor holds the median of these runs; every run's other
#: gates hold on that run
TIMED_LANE_RUNS = 5

# phase 15: the reference CI's shapes of the three lanes (scripts/ci.sh)
HOST_LANES_CI = {
    "sharded": {"KCP_BENCH_SHARD_FLEETS": "1,2", "KCP_BENCH_SHARD_SECONDS": "1.5",
                "KCP_BENCH_SHARD_CLUSTERS": "16", "KCP_BENCH_SHARD_EVENTS": "12"},
    "smartclient": {"KCP_BENCH_SMART_SECONDS": "1.5", "KCP_BENCH_SMART_CLUSTERS": "8"},
    "elastic": {"KCP_BENCH_ELASTIC_SECONDS": "0.8", "KCP_BENCH_ELASTIC_CLUSTERS": "16"},
}


def host_lanes_phase(card: str, gcs: "FullCollections") -> None:
    """15. The sharded fleet's bench lanes at ``scripts/ci.sh``'s shapes,
    each held to that script's gates: ``--sharded`` (2-shard capacity
    >= 1.6x one in the median of ``TIMED_LANE_RUNS`` runs; in every run a
    terminal 410 on the merged watch, fail-fast under 1,000 ms, 0 lost
    after catch-up), ``--smartclient`` (direct /
    routed capacity >= 1.5x, bytes equal, direct requests made, the
    scatter wire identical with spans written, the drill 0 lost, 0 errors
    surfaced, at least one fallback, ring epoch >= 2) and ``--elastic``
    (>= 1.2x, 0 lost, 0 errors, clusters and records migrated, no shard
    idle after). Each lane is a ``python -m kcp_tpu_torch.bench`` child, as
    in phase 16 (in this process, the lanes shared the CPU with what the
    earlier phases left running), and loads no torch. No server runs
    controllers: these are the host path's numbers on this machine's CPU.
    Then a ``kcp start`` shard child as the lanes start it and a
    ``--shard-loadgen`` child against it, each reporting as it exits that
    it loaded no JAX or JAX-package module."""
    caps = []
    for run in range(1, TIMED_LANE_RUNS + 1):
        r, sec = _lane_child("sharded", gcs, card)
        sb = r["sharded_bench"]
        kill = sb["kill"]
        cap = sb["capacity_speedup"]["2"]
        caps.append(cap)
        if not (kill["watch_terminal_410"] and kill["failfast_ms"] < 1000
                and kill["lost_after_catchup"] == 0):
            fail(f"--sharded gates (run {run}): {json.dumps(r)}")
        print(f"--sharded run {run} of {TIMED_LANE_RUNS}: capacity {cap}x at 2 shards "
              f"(concurrent {sb['concurrent_speedup']['2']}x on {sb['host_cpus']} CPUs; fleets "
              f"{json.dumps(sb['fleets'])}); router relay {sb['router']['relay_per_s']}/s, "
              f"merged list p50 {sb['router']['list_p50_ms']} ms, watch latency p50 "
              f"{sb['router']['watch_lat_p50_ms']} p99 {sb['router']['watch_lat_p99_ms']} ms; "
              f"kill: 410 in {kill['watch_410_ms']} ms, fail-fast {kill['failfast_ms']} ms "
              f"(limit 1000), {kill['acked_writes']} acked / {kill['lost_after_catchup']} "
              f"lost; {sec:.1f} s (host path) [{card}]")
    cap = median(caps)
    if not cap >= 1.6:
        fail(f"--sharded gates: median capacity {cap}x at 2 shards < 1.6x over "
             f"{TIMED_LANE_RUNS} runs {caps}")
    print(f"--sharded: median capacity {cap}x at 2 shards (floor 1.6) over "
          f"{TIMED_LANE_RUNS} runs {caps} [{card}]")
    r, sec = _lane_child("smartclient", gcs, card)
    sb = r["smartclient_bench"]
    ab, wire, drill = sb["ab"], sb["wire"], sb["ring_change_drill"]
    if not (r["value"] >= 1.5 and ab["bytes_equal"] and ab["direct_requests"] > 0
            and wire["identical"] and wire["spans_written"] > 0
            and drill["lost_after_move"] == 0 and drill["errors_surfaced"] == 0
            and drill["fallbacks"] >= 1 and drill["ring_epoch_after"] >= 2):
        fail(f"--smartclient gates: {json.dumps(r)}")
    print(f"--smartclient: direct/routed capacity {r['value']}x (floor 1.5; concurrent "
          f"{ab['concurrent_speedup']}x; routed {ab['routed_per_s']}/s p50 "
          f"{ab['routed_p50_ms']} p99 {ab['routed_p99_ms']} ms, direct {ab['direct_per_s']}/s "
          f"p50 {ab['direct_p50_ms']} p99 {ab['direct_p99_ms']} ms, per shard "
          f"{json.dumps(ab['per_shard'])}); bytes equal; wire identical, {wire['spans_written']} "
          f"spans, scatter {wire['scatter_ms']} ms / join {wire['join_ms']} ms; drill "
          f"{drill['acked_writes']} acked / {drill['lost_after_move']} lost, "
          f"{drill['errors_surfaced']} errors, {drill['fallbacks']} fallbacks, epoch "
          f"{drill['ring_epoch_after']}; {sec:.1f} s (host path) [{card}]")
    r, sec = _lane_child("elastic", gcs, card)
    eb = r["elastic_bench"]
    mv = eb["during_move"]
    if not (r["value"] >= 1.2 and mv["lost_after_move"] == 0 and mv["errors_surfaced"] == 0
            and mv["migrated_clusters"] >= 1 and mv["migration_records"] >= 1
            and len(eb["per_shard_after"]) == eb["shards_after"]):
        fail(f"--elastic gates: {json.dumps(r)}")
    print(f"--elastic: capacity {r['value']}x {eb['shards_before']} -> {eb['shards_after']} "
          f"shards (floor 1.2; {eb['capacity_before_per_s']} -> {eb['capacity_after_per_s']}/s); "
          f"move {mv['move_seconds']} s, {mv['acked_writes']} acked / {mv['lost_after_move']} "
          f"lost, {mv['errors_surfaced']} errors, {mv['migrated_clusters']} clusters / "
          f"{mv['migration_records']} records migrated, {mv['fenced_write_503s']} fence 503s, "
          f"writes p50 {mv['write_p50_ms']} p99 {mv['write_p99_ms']} ms, epoch "
          f"{mv['ring_epoch_after']}; {sec:.1f} s (host path) [{card}]")

    t0 = time.perf_counter()
    shard = _child("kcp_tpu_torch.cli.kcp", "start", "--no-install-controllers", "--no-tls",
                   "--syncer-mode", "none", "--in-memory", "--listen-port", "0")
    procs = {"kcp start shard": shard}
    try:
        url = _first_line(shard, "kcp start shard")
        serving_s = time.perf_counter() - t0
        procs["--shard-loadgen"] = loadgen = _child(
            "kcp_tpu_torch.bench", "--shard-loadgen", stdin=subprocess.PIPE, env_extra={
                "KCP_LG_SPEC": f"s0={url}", "KCP_LG_CLUSTERS": "t0,t1",
                "KCP_LG_SECONDS": "0.5", "KCP_LG_PREFIX": "iso"})
        if loadgen.stdout.readline().strip() != "ready":
            fail(f"--shard-loadgen: no ready line; stderr: {loadgen.stderr.read()[-2000:]}")
        loadgen.stdin.write("go\n")
        loadgen.stdin.flush()
        writes = json.loads(loadgen.stdout.readline())["writes"]
    finally:
        shard.send_signal(signal.SIGTERM)
        reports = {name: _exit_report(p) for name, p in procs.items()}
    _check_exits(reports, torch_ok=False)
    print(f"--sharded's children: a kcp start shard (serving {serving_s:.2f} s after its "
          f"spawn) and a --shard-loadgen writer ({writes} writes) exited 0 with no torch, "
          f"jax, jaxlib or kcp_tpu module loaded [{card}]")


# phase 16: the reference CI's shapes of the store, encode, admission,
# replication and write-path lanes (scripts/ci.sh)
STORE_LANES_CI = {
    "store": {"KCP_BENCH_STORE_OBJECTS": "10000", "KCP_BENCH_STORE_MUTS": "1500"},
    "encode": {"KCP_BENCH_ENCODE_OBJECTS": "10000", "KCP_BENCH_ENCODE_MUTS": "300"},
    "admission": {"KCP_BENCH_ADM_WRITES": "3000", "KCP_BENCH_ADM_TENANTS": "40",
                  "KCP_BENCH_ADM_STORM_S": "2"},
    "replica": {"KCP_BENCH_REPL_OBJECTS": "500", "KCP_BENCH_REPL_SECONDS": "0.8",
                "KCP_BENCH_REPL_LAG_WRITES": "60", "KCP_BENCH_REPL_DRILL_WRITES": "40"},
    "consistent": {"KCP_BENCH_CONS_OBJECTS": "500", "KCP_BENCH_CONS_SECONDS": "0.8",
                   "KCP_BENCH_CONS_LAG_WRITES": "60", "KCP_BENCH_CONS_RYWR_STEPS": "60"},
    "writes": {"KCP_BENCH_WRITES_SECONDS": "0.6", "KCP_BENCH_WRITES_CONC": "1,64",
               "KCP_BENCH_WRITES_EQ_OPS": "150", "KCP_BENCH_WRITES_STORE_OPS": "120"},
}


# phase 17: the reference CI's shape of the --watchers lane (scripts/ci.sh)
WATCHERS_CI = {"KCP_BENCH_WATCHERS": "1000", "KCP_BENCH_WATCH_OBJECTS": "10000",
               "KCP_BENCH_WATCH_CLUSTERS": "20", "KCP_BENCH_WATCH_MUTS": "400",
               "KCP_BENCH_WATCH_AB": "48", "KCP_BENCH_WATCH_AB_MUTS": "300"}
#: every lane that runs as a child, with its knobs
LANES_CI = {**HOST_LANES_CI, **STORE_LANES_CI, "watchers": WATCHERS_CI}


def _lane_child(lane: str, gcs: "FullCollections", card: str) -> tuple[dict, float]:
    """``python -m kcp_tpu_torch.bench --<lane>`` as a child process (as
    ``scripts/ci.sh`` runs the reference's), through ``WRAPPER``, with the
    lane's knobs (``LANES_CI``) and none of the earlier phases' ``KCP_*``
    settings: the lane's JSON line and its seconds. The child must exit 0
    with no torch, JAX or JAX-package module loaded. Prints the script's
    own load over the lane's window (:func:`print_script_load`)."""
    before = script_load(gcs)
    t0 = time.perf_counter()
    proc = _child("kcp_tpu_torch.bench", f"--{lane}", env_extra=LANES_CI[lane],
                  inherit_kcp=False)
    reports = {f"--{lane}": _exit_report(proc, timeout=600)}
    seconds = time.perf_counter() - t0
    _check_exits(reports, torch_ok=False)
    print_script_load(f"--{lane}", before, gcs, reports[f"--{lane}"][1], card)
    out = reports[f"--{lane}"][2]
    lines = [x for x in out.splitlines() if x.startswith("{")]
    if not lines:
        fail(f"--{lane}: no JSON line; stdout {out[-2000:]}")
    return json.loads(lines[-1]), seconds


def _live_children() -> dict:
    """This process's live child processes: pid -> (its command line, cut
    to 160 characters; its CPU seconds so far)."""
    me, tick, out = str(os.getpid()), os.sysconf("SC_CLK_TCK"), {}
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat", encoding="ascii", errors="replace") as f:
                rest = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:
            continue
        if rest[1] == me:  # ppid; utime and stime follow at 11 and 12
            out[pid] = (cmd[:160], (int(rest[11]) + int(rest[12])) / tick)
    return out


def script_load(gcs: "FullCollections") -> dict:
    """The script's own load as a lane starts: ``/proc/loadavg``, this
    process's CPU seconds so far, its threads and live children, and its
    full collections so far."""
    with open("/proc/loadavg", encoding="ascii") as f:
        load = " ".join(f.read().split()[:3])
    return {"load": load, "cpu_s": sum(os.times()[:2]), "threads": threading.active_count(),
            "children": _live_children(), "gc": len(gcs.pauses_ms)}


def print_script_load(lane: str, before: dict, gcs: "FullCollections",
                      child: dict | None, card: str) -> None:
    """One line per lane: what else this machine and this script did
    while the lane measured (the noise question of ROADMAP C3, C5, C6)."""
    cpu = sum(os.times()[:2]) - before["cpu_s"]
    now = _live_children()
    kids = "; ".join(f"{pid} {cmd!r}: {now[pid][1] - cpu_s:.2f} CPU s in the window"
                     if pid in now else f"{pid} {cmd!r}: gone"
                     for pid, (cmd, cpu_s) in before["children"].items()) or "none"
    child_gc = ("" if child is None else
                f"; the lane child: {child['full_collections']} full collections "
                f"({child['full_collection_ms']} ms, longest {child['longest_ms']} ms), "
                f"{child['cpu_s']} CPU s")
    print(f"load {lane}: {os.cpu_count()} CPUs, {len(os.sched_getaffinity(0))} in this "
          f"process's affinity; loadavg before {before['load']}; this process "
          f"{cpu:.2f} CPU s over the lane's window, {before['threads']} threads; its "
          f"children alive before the lane: {kids}; its full collections in the "
          f"window: {gcs.since(before['gc'])}{child_gc} [{card}]")


def store_lanes_phase(card: str, gcs: "FullCollections") -> None:
    """16. The store, encode, admission, replication and write-path lanes
    at ``scripts/ci.sh``'s shapes, each a ``python -m kcp_tpu_torch.bench``
    child held to that script's gates: ``--store`` (watch events equal,
    >= 4x), ``--encode`` (bytes and events equal, >= 3x), ``--admission``
    (overhead < 5% and quiet p99 ratio <= 2 in the median of
    ``TIMED_LANE_RUNS`` runs; in every run no quiet tenant rejected, the
    flood sees a 429 with Retry-After and fewer than half its writes
    pass), ``--replica`` (bytes equal, >= 1.5x at 2 replicas,
    0 lost across the promotion, the standby primary with epoch >= 1),
    ``--consistent`` (bytes equal, 0 stale, replica-local share >= 0.8,
    >= 1.5x) and ``--writes`` (>= 2x at 64 writers, state and RV sequences
    equal, the kill-mid-window drill with 0 lost and commit windows and
    batched acks counted). No lane runs controllers, and no child loads
    torch: these are host-path numbers on this machine's CPU."""
    r, sec = _lane_child("store", gcs, card)
    sb = r["store_bench"]
    if not (sb["events_equal"] and r["value"] >= 4.0):
        fail(f"--store gates: {json.dumps(r)}")
    print(f"--store: {r['value']}x combined (floor 4; list {sb['list_speedup']}x, fan-out "
          f"{sb['fanout_speedup']}x) at {sb['objects']} objects x {sb['watches']} watches, "
          f"{sb['indexed']['events']} events equal; {sec:.1f} s (host path) [{card}]")
    r, sec = _lane_child("encode", gcs, card)
    eb = r["encode_bench"]
    if not (eb["bytes_equal"] and eb["events_equal"] and r["value"] >= 3.0):
        fail(f"--encode gates: {json.dumps(r)}")
    print(f"--encode: {r['value']}x combined (floor 3; list {eb['list_speedup']}x, churned "
          f"list {eb['churn_list_speedup']}x, fan-out {eb['fanout_speedup']}x, fan-out "
          f"encode {eb['fanout_encode_speedup']}x) at {eb['objects']} objects x "
          f"{eb['watchers']} watchers; bytes equal (sha256 {eb['cached']['sha256'][:16]}), "
          f"{eb['cached']['events']} events equal; {sec:.1f} s (host path) [{card}]")
    overheads, ratios = [], []
    for run in range(1, TIMED_LANE_RUNS + 1):
        r, sec = _lane_child("admission", gcs, card)
        happy, st = r["admission_bench"]["happy"], r["admission_bench"]["storm"]
        overheads.append(r["value"])
        ratios.append(st["quiet_p99_ratio"])
        if not (st["quiet_rejected"] == 0 and st["flood_429"] > 0
                and st["flood_retry_after_seen"] and st["flood_ok"] < st["flood_sent"] // 2):
            fail(f"--admission gates (run {run}): {json.dumps(r)}")
        print(f"--admission run {run} of {TIMED_LANE_RUNS}: overhead {r['value']}% over HTTP "
              f"(median {happy['http_med_off_us']} -> {happy['http_med_on_us']} us, direct "
              f"{happy['direct_overhead_pct']}%); storm of {st['tenants']} tenants: quiet p99 "
              f"{st['baseline_quiet_p99_ms']} -> {st['storm_quiet_p99_ms']} ms, ratio "
              f"{st['quiet_p99_ratio']}, {st['quiet_ok']} quiet writes / "
              f"{st['quiet_rejected']} rejected, flood {st['flood_429']} of "
              f"{st['flood_sent']} answered 429 with Retry-After, {st['flood_ok']} passed; "
              f"{sec:.1f} s (host path) [{card}]")
    overhead, ratio = median(overheads), median(ratios)
    if not (overhead < 5.0 and ratio <= 2.0):
        fail(f"--admission gates: median overhead {overhead}% (limit 5) over "
             f"{TIMED_LANE_RUNS} runs {overheads}; median quiet p99 ratio {ratio} (limit 2) "
             f"over {ratios}")
    print(f"--admission: median overhead {overhead}% over HTTP (limit 5) over "
          f"{TIMED_LANE_RUNS} runs {overheads}; median quiet p99 ratio {ratio} (limit 2) over "
          f"{ratios} [{card}]")
    r, sec = _lane_child("replica", gcs, card)
    rb = r["replica_bench"]
    kill = rb["kill"]
    if not (rb["bytes_equal"] and r["value"] >= 1.5 and kill["lost_after_promotion"] == 0
            and kill["promoted_role"] == "primary" and kill["epoch"] >= 1):
        fail(f"--replica gates: {json.dumps(r)}")
    print(f"--replica: read capacity {r['value']}x at 2 replicas (floor 1.5; "
          f"{json.dumps(rb['read_capacity_rps'])} reads/s), bytes equal, lag p50 "
          f"{rb['lag']['p50_ms']} p99 {rb['lag']['p99_ms']} ms; kill: {kill['acked_writes']} "
          f"acked / {kill['lost_after_promotion']} lost, promoted to {kill['promoted_role']} "
          f"in {kill['promote_ms']} ms, epoch {kill['epoch']}; {sec:.1f} s (host path) "
          f"[{card}]")
    r, sec = _lane_child("consistent", gcs, card)
    cb = r["consistent_bench"]
    rw, wf = cb["read_your_writes"], cb["wait_for_frontier"]
    if not (cb["bytes_equal"] and rw["stale"] == 0 and rw["replica_local_share"] >= 0.8
            and r["value"] >= 1.5):
        fail(f"--consistent gates: {json.dumps(r)}")
    print(f"--consistent: consistent-read capacity {r['value']}x at {cb['replicas']} "
          f"replicas (floor 1.5; {json.dumps(cb['capacity_rps'])}), bytes equal; "
          f"read-your-writes {rw['reads'] - rw['stale']}/{rw['reads']} fresh, replica-local "
          f"{rw['replica_local_share']} (floor 0.8), {rw['fallbacks']} fallbacks; frontier "
          f"wait p50 {wf['p50_ms']} p99 {wf['p99_ms']} ms under repl.ship 5 ms; {sec:.1f} s "
          f"(host path) [{card}]")
    r, sec = _lane_child("writes", gcs, card)
    wb = r["writes_bench"]
    drill = wb["kill_drill"]
    if not (r["value"] >= 2.0 and wb["state_equal"] and wb["rv_sequence_equal"]
            and drill["ok"] and drill["lost_after_kill"] == 0
            and drill["commit_windows"] > 0 and drill["acks_batched"] > 0):
        fail(f"--writes gates: {json.dumps(r)}")
    wp = wb["write_path"]
    print(f"--writes: grouped/serial write path {r['value']}x at 64 writers (floor 2; "
          f"{wp['serial']['64']['rps']} -> {wp['grouped']['64']['rps']} writes/s, "
          f"{wb['wal_sync']}), HTTP end to end {wb['end_to_end_http']['speedup_at_top']}x; "
          f"p99 at 1 writer {wb['p99_1_writer_ms']['serial']} -> "
          f"{wb['p99_1_writer_ms']['grouped']} ms; state and RV sequences equal; drill: "
          f"{drill['acked_writes']} acked / {drill['lost_after_kill']} lost, "
          f"{drill['commit_windows']:.0f} commit windows, {drill['acks_batched']:.0f} batched "
          f"acks; {sec:.1f} s (host path) [{card}]")


def watchers_phase(card: str, gcs: "FullCollections") -> None:
    """17. The ``--watchers`` lane at ``scripts/ci.sh``'s shape, a child held
    to that script's gates, unchanged: every stream established, under 100
    KB RSS per watcher, soak growth under 1.15, delivery p99 under 3,000
    ms, the flush A/B's streams equal byte for byte and line for line, a
    flush reduction of 4x or more, the evict drill green. Host path: the
    server child runs no controller. Then a ``--watchers-serve`` child as
    the lane starts it, reporting as it exits that it loaded no torch, JAX
    or JAX-package module."""
    r, sec = _lane_child("watchers", gcs, card)
    wb = r["watchers_bench"]
    sc, ab, drill = wb["scale"], wb["ab"], wb["evict_drill"]
    if not (sc["streams_established"] == sc["watchers"] and sc["rss_per_watcher_kb"] < 100
            and sc["rss_soak_growth"] < 1.15 and sc["delivery_p99_ms"] is not None
            and sc["delivery_p99_ms"] < 3000 and ab["bytes_equal"] and ab["lines_equal"]
            and r["value"] >= 4.0 and drill["ok"]):
        fail(f"--watchers gates: {json.dumps(r)}")
    print(f"--watchers: {sc['streams_established']} of {sc['watchers']} streams at "
          f"{sc['objects']} objects; delivery p50 {sc['delivery_p50_ms']} p99 "
          f"{sc['delivery_p99_ms']} ms (limit 3000) over {sc['latency_samples']} samples; "
          f"{sc['rss_per_watcher_kb']} KB RSS per watcher (limit 100), soak growth "
          f"{sc['rss_soak_growth']} (limit 1.15), RSS {json.dumps(sc['rss_kb'])} KB; flush "
          f"A/B {r['value']}x (floor 4; {ab['flushes_per_batch']:.0f} -> "
          f"{ab['flushes_coalesced']:.0f} flushes at {ab['watchers']} watchers), streams "
          f"byte-identical; evict drill: {drill['evicted_total']:.0f} evicted, terminal 410, "
          f"{drill['healthy_lines']}/{drill['healthy_expected']} healthy lines; {sec:.1f} s "
          f"(host path) [{card}]")
    serve = _child("kcp_tpu_torch.bench", "--watchers-serve", inherit_kcp=False,
                   env_extra={"KCP_WB_OBJECTS": "1000", "KCP_WB_CLUSTERS": "4"})
    try:
        line = serve.stdout.readline()
        objects = json.loads(line)["objects"] if line.startswith("{") else None
    finally:
        serve.send_signal(signal.SIGTERM)
        reports = {"--watchers-serve": _exit_report(serve)}
    _check_exits(reports, torch_ok=False)
    if objects != 1000:
        fail(f"--watchers-serve: announced {line!r}")
    print(f"--watchers' server child: served {objects} objects and exited 0 with no torch, "
          f"jax, jaxlib or kcp_tpu module loaded [{card}]")


#: phase 18's row shards: a 2x2x1 mesh whose hosts are two processes
A7_SPEC = "2x2x1"
#: phase 18: one rank of the two-process serving mesh (``python -c``; env
#: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK): the group formed and the
#: mesh built for its serving device (``kcp start --distributed --mesh SPEC
#: [--device DEV]`` does the same two calls), the seeded ticks of
#: :func:`mesh_ticks` over its hosts block, its wires to a file, a JSON
#: report on its last line
RANK_CODE = (
    "import json, sys\n"
    "sys.path.insert(0, %r)\n"
    "import numpy as np, torch\n"
    "import torch.distributed as dist\n"
    "import chip_smoke as cs\n"
    "from kcp_tpu_torch.ops.cuda_kernels import decide_and_match_sharded as kernel\n"
    "from kcp_tpu_torch.parallel.distributed import init_distributed\n"
    "from kcp_tpu_torch.parallel.mesh import mesh_on\n"
    "device, spec = %r, %r\n"
    "init_distributed(device=device)\n"
    "mesh = mesh_on(spec, device)\n"
    "kernel.launches = 0\n"
    "wires, ms = cs.mesh_ticks(mesh, torch, mesh.lead)\n"
    "launches = kernel.launches\n"
    "np.savez(%r %% dist.get_rank(), *wires)\n"
    "print(json.dumps({'rank': dist.get_rank(), 'world': dist.get_world_size(),\n"
    "      'backend': dist.get_backend(), 'process': mesh.process,\n"
    "      'local_rows': mesh.local_rows, 'cards': [str(d) for d in mesh.local_devices],\n"
    "      'current': torch.cuda.current_device(), 'step_ms': ms, 'launches': launches}))\n"
    "dist.destroy_process_group()\n")


#: phase 18: seeded ticks, then timed steps, of each rank (one grouped
#: launch of the kernel a step on each of the rank's cards)
A7_TICKS, A7_TIMED = 3, 10


def mesh_ticks(mesh, torch, dev, timed: int = A7_TIMED, b: int = 131072, s: int = 64):
    """Phase 4's seeded fleet ticks and a third (seeds 7, 8, 9; capacities
    8192, 256 to overflow, 8192) through ``reconcile_step_fleet`` on
    ``mesh``, then ``timed`` steps of the last wire on the host clock, each
    with its upload and its wire fetched to the host (on a multi-process
    mesh, every collective and every staging copy between card and host
    inside it). Returns (the ticks' wires as numpy arrays, ms per step)."""
    from kcp_tpu_torch.models import reconcile_model as tm
    from kcp_tpu_torch.parallel.mesh import FLAGS, ShardedTensor, shard_state

    state, seg, packed, acks = step_case(np.random.default_rng(7), b, s, 1024, torch)
    sh = [shard_state(state, mesh), ShardedTensor.put(tm.to_device(seg, dev), mesh, FLAGS)]

    def step(cap: int) -> np.ndarray:
        sh[0], sh[1], wire = tm.reconcile_step_fleet(
            sh[0], sh[1], tm.to_device(packed, dev), tm.to_device(acks, dev),
            patch_capacity=cap, seg_capacity=8, mesh=mesh)
        return tm.wire_to_numpy(wire)

    wires = []
    for tick, cap in enumerate((8192, 256, 8192)):
        if tick:
            _st, _sg, packed, acks = step_case(np.random.default_rng(7 + tick), b, s, 1024,
                                               torch)
        wires.append(step(cap))
    sync_cards(torch)
    t0 = time.perf_counter()
    for _ in range(timed):
        step(8192)
    return wires, (time.perf_counter() - t0) / timed * 1e3


def run_ranks(spec: str, device, want: list, label: str) -> list[dict]:
    """Two rank processes of one ``torch.distributed`` group
    (``init_distributed`` from the environment, 127.0.0.1), each serving
    its hosts block of ``spec`` on ``device`` (None: the cards that
    ``rank_plan`` gives it) through :data:`RANK_CODE`. Every wire of each
    rank must equal ``want``'s byte for byte, and each rank must launch the
    kernel once a step on each of its cards. Returns the ranks' reports."""
    import socket
    import tempfile

    tmp = tempfile.mkdtemp(prefix="kcp_a7_")
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KCP_") and k not in ("LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
               GLOO_SOCKET_IFNAME="lo", NCCL_SOCKET_IFNAME="lo", NCCL_DEBUG="WARN")
    code = RANK_CODE % (os.path.dirname(os.path.abspath(__file__)), device, spec,
                        os.path.join(tmp, "rank%d.npz"))
    procs = [subprocess.Popen([sys.executable, "-c", code], env={**env, "RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    except subprocess.TimeoutExpired:
        outs = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if outs is None:
        fail(f"{label}: a rank outlived 300 s")
    reports = []
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"{label} rank {rank}: exit {p.returncode}; stderr {err[-2000:]}")
        rep = json.loads(out.strip().splitlines()[-1])
        got = np.load(os.path.join(tmp, f"rank{rank}.npz"))
        for tick, w in enumerate(want):
            if got[f"arr_{tick}"].tobytes() != w.tobytes():
                fail(f"{label} rank {rank} tick {tick}: wire != the one-process {spec} wire")
        if rep["world"] != 2 or rep["process"] != rank:
            fail(f"{label} rank {rank}: {rep}")
        steps = A7_TICKS + A7_TIMED
        if rep["launches"] != steps * len(rep["cards"]):
            fail(f"{label} rank {rank}: {rep['launches']} kernel launches in {steps} steps on "
                 f"{rep['cards']} (want one grouped launch a step on each card)")
        reports.append(rep)
    return reports


def distributed_phase(torch, dev, card: str) -> tuple[int, list, list]:
    """18. A7 on the card: two rank processes of one ``torch.distributed``
    group, each holding its hosts block of a ``2x2x1`` mesh on cuda:0 (two
    row shards), run :func:`mesh_ticks` at the serving shape (131,072 x
    64); each rank's two row shards take one grouped launch on the card.
    Both ranks serve on the one card they name, so the group is gloo on
    any host (``rank_plan``: NCCL refuses two ranks on one card) and what
    crosses processes is staged through host memory. Both ranks' wires
    must equal the one-process ``2x2x1`` run's byte for byte (that run is
    held against the unsharded step in 4b's way: every wire here carries
    the overflow tick). Each rank launches the kernel once a step, over
    both its row shards. Prints each rank's backend, step ms and launches.
    Returns the ranks' launches, their reports and the one-process
    wires."""
    one = smoke_mesh(A7_SPEC, dev)
    want, one_ms = mesh_ticks(one, torch, dev)
    if not bool(want[1][1]):
        fail("A7: the overflow tick did not overflow")
    reports = run_ranks(A7_SPEC, "cuda:0", want, "A7")
    for rank, rep in enumerate(reports):
        if rep["backend"] != "gloo" or rep["cards"] != ["cuda:0"]:
            fail(f"A7 rank {rank}: {rep['backend']} on {rep['cards']}, want gloo on cuda:0")
        print(f"A7 rank {rank}/2 ({rep['backend']}, row shards {rep['local_rows']} of "
              f"{A7_SPEC} on {rep['cards'][0]}): 3 ticks at B=131072 S=64 wire == the "
              f"one-process {A7_SPEC} wire byte for byte (overflow tick included); step "
              f"{rep['step_ms']:.3f} ms incl. upload, collectives, staging through host "
              f"memory and the wire's fetch; {rep['launches']} decide_and_match launches "
              f"[{card}]")
    print(f"A7: the one-process {A7_SPEC} step {one_ms:.3f} ms on the same card [{card}]")
    return sum(r["launches"] for r in reports), reports, want


def visible_cards(torch, label: str) -> list | None:
    """The visible cards when there are two or more; else prints the
    phase's one line and returns None."""
    n = torch.cuda.device_count()
    if n < 2:
        print(f"{label}: not run: needs \u2265 2 cards, {n} visible")
        return None
    return [torch.device("cuda", i) for i in range(n)]


def multicard_loop_phase(torch, card: str, loop_5b: dict, timed: list) -> int:
    """19. The fused loop over a card per row shard, where two cards or
    more are visible (``mesh_from_spec(str(n))`` over the n visible
    cards, the default of ``kcp start --mesh N``): phase 4b's seeded ticks
    against the unsharded step on cuda:0, byte-equal, one launch per card
    a tick; then phase 5's closed loop through ``FusedCore(mesh=...)``,
    one launch per card a tick, beside phase 5b's one-card mesh ``4``;
    then the sharded kernel at the serving shape against its plain
    version, one launch per card a call, added to ``timed`` for its
    counted, cold device time after the profiler starts (the n launches of
    a call on their n cards). Returns the loop's launches (0 when not
    run)."""
    from kcp_tpu_torch.ops.cuda_kernels import decide_and_match_plain, decide_and_match_sharded
    from kcp_tpu_torch.parallel import mesh as pm
    from kcp_tpu_torch.syncer.core import FusedCore

    label = "phase 19, the fused loop over a card per row shard"
    cards = visible_cards(torch, label)
    if cards is None:
        return 0
    n, dev = len(cards), cards[0]
    mesh = pm.mesh_from_spec(str(n))
    if list(mesh.local_devices) != cards:
        fail(f"{label}: mesh {n} lies on {mesh.local_devices}, want one row shard a card")
    sharded_step_phase(torch, dev, card, mesh=mesh)
    core = FusedCore(mesh=mesh, batch_window=0.0005)
    out, launches = main_path_phase(
        core, torch, decide_and_match_sharded, n, card,
        f"main path, a card per row shard (mesh {n} over {n} cards: one launch per card a "
        f"tick)")
    print(f"main path over {n} cards against phase 5b's mesh 4 on one card: "
          f"{out['ms_per_tick']:.3f} vs {loop_5b['ms_per_tick']:.3f} ms/tick, convergence "
          f"p50 {out['convergence_p50_ms']:.3f} vs {loop_5b['convergence_p50_ms']:.3f} ms, "
          f"p99 {out['convergence_p99_ms']:.3f} vs {loop_5b['convergence_p99_ms']:.3f} ms "
          f"(host clock, one loop each) [{card}]")
    rng = np.random.default_rng(2026)
    sh = SERVING
    case = (*kernel_case(rng, sh["b"], sh["s"], sh["l"], sh["c"], sh["per_row"], torch, dev),
            segments(rng, sh["b"], torch, dev))
    layouts = [pm.ROWS, pm.FLAGS, pm.ROWS, pm.FLAGS, pm.ROWS, pm.FLAGS, pm.REPLICATED,
               pm.FLAGS]
    args = [pm.ShardedTensor.put(x, mesh, lay) for x, lay in zip(case, layouts)]
    seg = dict(seg_capacity=SEG_CAPACITY)
    before = decide_and_match_sharded.launches
    got = decide_and_match_sharded(mesh, *args, **seg)
    sync_cards(torch)
    per_call = decide_and_match_sharded.launches - before
    if per_call != n:
        fail(f"{label}: {per_call} launches a call over {n} cards (want one per card)")
    if {blk[0].device for blk in got[0].blocks} != set(cards):
        fail(f"{label}: decisions on {[blk[0].device for blk in got[0].blocks]}")
    want = decide_and_match_plain(*case, **seg)
    exact(f"{label}: the sharded kernel over {n} cards", (got[0].full(), got[1].full(),
                                                           *got[2:]), want, torch)
    call_ms = time_ms(lambda: decide_and_match_sharded(mesh, *args, **seg), torch, 30)
    plain_ms = time_ms(lambda: decide_and_match_plain(*case, **seg), torch, 10)
    bound_ms, bound_by, nbytes = bound(case, want, launches=n)
    text = (f"decide_and_match_sharded [serving: B={sh['b']} S={sh['s']} mask=row L={sh['l']} "
            f"C={sh['c']}, fleet form, mesh {n}, a row shard on each of {n} cards]")
    print(f"kernel {text}: equal (tolerance: exact); {per_call} launches per call, one per "
          f"card; {call_ms:.4f} ms per back-to-back call (events), plain {plain_ms:.4f} ms "
          f"on {dev}, bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B over {n} cards' "
          f"memory read as one card's); library call: none [{card}]")
    timed.append((f"{text}, a launch per card", lambda: decide_and_match_sharded(
        mesh, *args, **seg), n, bound_ms, None))
    return launches


def nccl_phase(torch, card: str, gloo: list, want_18: list) -> int:
    """20. A7 over NCCL, where two cards or more are visible: two rank
    processes, each with ``init_distributed()`` and ``mesh_on(spec, None)``
    (``kcp start --distributed --mesh SPEC`` without ``--device``), so each
    serves on cards of its own (``rank_plan``): ``2x2x1`` with two cards a
    rank on four cards or more, else ``2x1x1`` with one each. Each rank
    must report backend ``nccl`` and its own cards (the current card its
    block's lead), launch the kernel once a step on each of its cards, and
    give wires byte-equal to the one-process run over the same spec on the
    visible cards (which must equal phase 18's). Prints each rank's step
    ms beside phase 18's gloo ranks on cuda:0. Returns the ranks'
    launches (0 when not run)."""
    from kcp_tpu_torch.parallel.mesh import mesh_from_spec

    label = "phase 20, A7 over NCCL"
    cards = visible_cards(torch, label)
    if cards is None:
        return 0
    spec = "2x2x1" if len(cards) >= 4 else "2x1x1"
    one = mesh_from_spec(spec)
    want, one_ms = mesh_ticks(one, torch, one.lead)
    if any(a.tobytes() != b.tobytes() for a, b in zip(want, want_18)):
        fail(f"{label}: the one-process {spec} wires over {list(one.local_devices)} != "
             f"phase 18's {A7_SPEC} wires on one card")
    reports = run_ranks(spec, None, want, label)
    held = [c for rep in reports for c in rep["cards"]]
    if len(set(held)) != len(held):
        fail(f"{label}: two ranks share a card: {[rep['cards'] for rep in reports]}")
    for rank, (rep, g) in enumerate(zip(reports, gloo)):
        if rep["backend"] != "nccl" or f"cuda:{rep['current']}" != rep["cards"][0]:
            fail(f"{label} rank {rank}: backend {rep['backend']}, current card "
                 f"cuda:{rep['current']}, cards {rep['cards']}: want nccl led by its own")
        print(f"A7 over NCCL rank {rank}/2 (row shards {rep['local_rows']} of {spec} on "
              f"{rep['cards']}): 3 ticks at B=131072 S=64 wire == the one-process {spec} "
              f"wire byte for byte (overflow tick included); step {rep['step_ms']:.3f} ms "
              f"(nccl) vs {g['step_ms']:.3f} ms (phase 18, gloo on cuda:0); "
              f"{rep['launches']} decide_and_match launches, one a step on each card "
              f"[{card}]")
    print(f"A7 over NCCL: the one-process {spec} step {one_ms:.3f} ms over "
          f"{[str(d) for d in one.local_devices]} [{card}]")
    return sum(r["launches"] for r in reports)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card: nothing to run", file=sys.stderr)
        sys.exit(2)
    from kcp_tpu_torch import native
    from kcp_tpu_torch.bench import closed_loop
    from kcp_tpu_torch.models import reconcile_model as tm
    from kcp_tpu_torch.ops import cuda_kernels
    from kcp_tpu_torch.ops.cuda_kernels import decide_and_match, decide_and_match_sharded
    from kcp_tpu_torch.syncer.core import FusedCore
    from kcp_tpu_torch.utils.trace import REGISTRY

    t_all = time.perf_counter()
    gcs = FullCollections()
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
    # the port's host library and extension (g++, into build/kcp_tpu_torch/)
    native.load()
    native.load_tokenizer()
    for name, info in native.build_info.items():
        print(f"build: native {name}: {info['path']} in {info['seconds']:.2f} s" if "path" in info
              else f"build: native {name} did not build or load ({info['error']}): its "
                   f"callers take their Python path")

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
    from kcp_tpu_torch.ops.cuda_kernels import wire_scatter

    for tick, cap in enumerate((8192, 256)):
        if tick:  # a second wire on the carried state; capacity forces overflow
            _st, _sg, packed, acks = step_case(np.random.default_rng(8), b, s, 1024, torch)
        outs = []
        lanes_before = {k: v.clone() for k, v in wire_lanes(*cpu).items()}
        before = wire_scatter.launches
        for side, d in ((gpu, dev), (cpu, torch.device("cpu"))):
            side[0], side[1], wire = tm.reconcile_step_fleet(
                side[0], side[1], tm.to_device(packed, d), tm.to_device(acks, d),
                patch_capacity=cap, seg_capacity=8)
            outs.append(tm.wire_to_numpy(wire))
        torch.cuda.synchronize()
        if wire_scatter.launches - before != 2:
            fail(f"step tick {tick}: {wire_scatter.launches - before} wire_scatter launches, "
                 f"2 expected (the card step's side lanes and deltas)")
        if outs[0].tobytes() != outs[1].tobytes():
            diff = np.flatnonzero(outs[0] != outs[1])
            fail(f"step tick {tick}: card wire != CPU wire at {diff[:10].tolist()}")
        check_wire_lanes(f"step tick {tick}", wire_lanes(*gpu), wire_lanes(*cpu),
                         lanes_before, torch)
        if bool(outs[0][1]) != (cap == 256):
            fail(f"step tick {tick}: overflow flag {bool(outs[0][1])} at capacity {cap}")

    def card_step():
        tm.reconcile_step_fleet(gpu[0], gpu[1], tm.to_device(packed, dev),
                                tm.to_device(acks, dev), patch_capacity=8192, seg_capacity=8)

    step_ms = time_ms(card_step, torch, 20)
    print(f"step: reconcile_step_fleet card wire == CPU wire, and the mirrors, their "
          f"flags, the status mask and the seg ids too, 2 ticks at B={b} S={s} (acks, "
          f"mask+segment stamps, overflow tick), 2 wire_scatter launches a card step; "
          f"device step {step_ms:.4f} ms incl. upload [{card}]")
    del cpu

    # ---- 4c. wire_scatter's pair against the torch path, at fleet-1m's rows
    wire_timed = []
    record_wire = wire_scatter_phase(torch, dev, card, wire_timed)

    # ---- 4b. sharded step vs unsharded card step, byte-equal wires
    sharded_step = sharded_step_phase(torch, dev, card, b, s)

    # ---- 5. main path: closed loop through FusedCore, fleet on, double
    core = FusedCore(batch_window=0.0005)
    wire0 = wire_scatter.launches
    _out, launches = main_path_phase(core, torch, decide_and_match, 1, card, "main path")
    wire_launches = wire_scatter.launches - wire0
    if wire_launches != 2 * launches:
        fail(f"main path: {wire_launches} wire_scatter launches for {launches} steps (want 2 "
             f"a step)")
    snap = REGISTRY.snapshot()
    phases = " ".join(
        f"{k[6:-8]}={v['mean'] * 1e3:.3f}ms" for k, v in sorted(snap.items())
        if k.startswith("fused_") and k.endswith("_seconds") and isinstance(v, dict)
        and v["count"])
    print(f"tick phases (mean): {phases}")

    # ---- 5b. the main path, sharded: FusedCore over mesh "4" on the card
    sharded_core = FusedCore(mesh=smoke_mesh("4", dev), batch_window=0.0005)
    _out_s, launches_sharded = main_path_phase(
        sharded_core, torch, decide_and_match_sharded, 1, card,
        "main path, sharded (mesh 4: one grouped launch a tick)")

    # ---- 7. the controller plane at a platform team's size; 7b. the two
    #          demo scenarios, unsharded and on mesh "4" (before any
    #          profiler session, like 5 and 5b)
    mark = len(gcs.pauses_ms)
    controller_plane_phase(torch, dev, card)
    demo_phase(torch, dev, card)

    # ---- 8. kcp start's server on the card, driven over REST; 8b. the
    #          binaries in child processes (before the profiler, too)
    front_launches = front_door_phase(torch, card)
    binaries_phase(card)

    # ---- 9a. the fleet solver at the placement benchmark's shape; 9b.
    #          fleet placement through kcp start (host clock, before the
    #          profiler too)
    solve = solver_phase(torch, dev, card)
    fleet_launches = fleet_phase(torch, card)

    # ---- 10. the sharded front door: four shards' controllers on the card
    #           behind the router (host clock, before the profiler too)
    sharded_launches = sharded_phase(torch, card)
    print(f"heap: phases 7-10 had {gcs.since(mark)}")

    # ---- 11. the scenario harness: the catalog's controller scenarios on
    #           the card, and a traced crud-churn (before the profiler too),
    #           with the heap the earlier phases left frozen: full
    #           collections over it stall every thread mid-request, and
    #           once made every one of the traced run's slowest traces a
    #           read. The heap is given back to the collector after it, so
    #           that phases 12-13 read the program as it runs
    freeze_heap()
    mark = len(gcs.pauses_ms)
    scenario_launches = scenario_phase(torch, card)
    gc.unfreeze()
    print(f"heap: phase 11 had {gcs.since(mark)} (heap frozen); unfrozen")

    # ---- 12. the --fleet lane at its full default shape: per-bucket then
    #           ragged dispatch, the quarantine drill (host clock, before
    #           the profiler too); then its shapes against the plain version
    fleet_ab_launches = fleet_ab_phase(torch, dev, card, gcs)

    # ---- 13. the gauntlet's controller config on the card; the lint gate
    mark = len(gcs.pauses_ms)
    gauntlet_phase(torch, card)
    print(f"heap: phase 13 had {gcs.since(mark)}")

    # ---- 14. the --suite lane on the card: BASELINE configs 2-4, the kernel
    #           against torch.compile of its plain version (host clock and
    #           events, before the profiler too; device times after it)
    compiled_timed = []
    suite_launches = suite_phase(torch, dev, card, timed, compiled_timed)
    # torch.compile leaves a compile-worker process behind, which once
    # burned CPU while phase 15's first lane measured: stop it
    from torch._inductor.async_compile import shutdown_compile_workers

    shutdown_compile_workers()

    # ---- 15. the sharded fleet's lanes at the reference CI's shapes and
    #           gates (the host path: no server runs controllers)
    mark = len(gcs.pauses_ms)
    t0 = time.perf_counter()
    host_lanes_phase(card, gcs)
    print(f"phase 15: {time.perf_counter() - t0:.1f} s; heap: phase 15 had {gcs.since(mark)}")

    # ---- 16. the store, encode, admission, replication and write-path lanes
    #           at the reference CI's shapes and gates, each in a child
    #           process (the host path: no server runs controllers)
    t0 = time.perf_counter()
    store_lanes_phase(card, gcs)
    print(f"phase 16: {time.perf_counter() - t0:.1f} s")

    # ---- 17. the --watchers lane at the reference CI's shape and gates, in a
    #           child process (the host path: its server runs no controller)
    t0 = time.perf_counter()
    watchers_phase(card, gcs)
    print(f"phase 17: {time.perf_counter() - t0:.1f} s")

    # ---- 18. A7: two rank processes of one process group, each with its
    #           hosts block of a 2x2x1 mesh on the card, against the
    #           one-process 2x2x1 run (host clock, before the profiler too)
    t0 = time.perf_counter()
    a7_launches, a7_reports, a7_wires = distributed_phase(torch, dev, card)
    print(f"phase 18: {time.perf_counter() - t0:.1f} s")

    # ---- 19. the fused loop over a card per row shard; 20. A7 over NCCL,
    #           each rank on cards of its own: both only where two cards or
    #           more are visible, else one "not run" line each (host clock,
    #           before the profiler too; 19's kernel device time after it)
    t0 = time.perf_counter()
    multicard_timed = []
    multicard_launches = multicard_loop_phase(torch, card, _out_s, multicard_timed)
    nccl_launches = nccl_phase(torch, card, a7_reports, a7_wires)
    if multicard_timed:
        print(f"phases 19-20: {time.perf_counter() - t0:.1f} s")

    # ---- 3, 3b, 4c, 14: the kernels' device times and 14's compiled
    #          compositions'; 4, 4b: no index_add_ in either step (profiled,
    #          so after the main path's readings)
    device_times(timed, card)
    device_times(wire_timed, card, kernel="wire_scatter_kernel")
    device_times(compiled_timed, card, kernel=None)
    if multicard_timed:
        device_times(multicard_timed, card,
                     cards=[torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    assert_no_index_add(card_step, "step")
    assert_no_index_add(sharded_step, "sharded step")
    print("step, sharded step: no index_add_ (profiler, CPU activity)")
    del gpu, sharded_step
    solver_device_phase(solve, torch, card)

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
                  replaces="kcp_tpu/ops/pallas_kernels.py:129",
                  launches=(launches + front_launches + fleet_launches + sharded_launches
                            + scenario_launches + fleet_ab_launches + suite_launches),
                  library_ms=None)
    record_sharded.update(name="decide_and_match_sharded", route="cuda",
                          source="kcp_tpu_torch/csrc/decide_match.cu",
                          replaces="kcp_tpu/ops/pallas_kernels.py:223",
                          launches=(launches_sharded + a7_launches + multicard_launches
                                    + nccl_launches), library_ms=None)
    record_wire.update(name="wire_scatter", route="cuda",
                       source="kcp_tpu_torch/csrc/wire_scatter.cu",
                       replaces="none: XLA scatters in kcp_tpu/models/reconcile_model.py and "
                                "kcp_tpu/ops/diff.py", launches=wire_launches, library_ms=None)
    print("recorded before the redesign, not measured in this run (PERF.md §6): "
          + ", ".join(f"{r['name']} {RECORDED_EARLIER_MS[r['name']]} ms on the device "
                      f"against {r['ms']:.4f} ms now" for r in (record, record_sharded)))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in (record, record_sharded, record_wire)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
