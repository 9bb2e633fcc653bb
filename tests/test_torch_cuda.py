"""The port on the card: the CUDA kernel against its plain version (both
forms, every path of its tile plan), the step on the card against the
step on the CPU, a short FusedCore loop, the schema hash on the card
against the CPU, the controller plane on the card (the kubecon demo
scenario and a small fleet), and ``kcp start``'s server on the card with
the quota ledger fed by the kernel's per-segment counts, and the fleet
solver on the card against its numpy twin, alone and through ``kcp
start`` with fleet placement on, and the scenario harness's
``capacity-skew-binpack`` and ``fleet-churn`` with their device work on
the card. Where two cards or more are visible: the kernel and the step
over a row shard on each card, and two NCCL ranks on cards of their own
(run those on a four-card machine).

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one. The file imports neither JAX nor the JAX package, so on a machine
without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

All outputs are integers: every comparison is exact equality.
"""

import asyncio
import threading

import numpy as np
import pytest
import torch

from kcp_tpu_torch.models import reconcile_model as tm
from kcp_tpu_torch.ops import cuda_kernels
from kcp_tpu_torch.ops.cuda_kernels import decide_and_match, decide_and_match_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(rng, b, s, l, c, per_row, device):
    up = rng.integers(1, 2**32, (b, s), dtype=np.uint32)
    down = up.copy()
    dirty = rng.random(b) < 0.1
    down[dirty, rng.integers(0, s)] ^= 3
    upe = rng.random(b) < 0.95
    dne = rng.random(b) < 0.95
    mask = rng.random((b, s) if per_row else s) < 0.2
    pair = rng.integers(1, 32, (b, l), dtype=np.uint32)
    sel = rng.integers(1, 32, c, dtype=np.uint32)
    return tuple(tm.to_device(a, device) for a in (up, upe, down, dne, mask, pair, sel))


@pytest.mark.parametrize("per_row", [False, True], ids=["bucket_mask", "row_mask"])
@pytest.mark.parametrize("b,s,l,c", [(131072, 64, 1, 8), (8192, 64, 8, 64),
                                     (131071, 64, 1, 8), (1000, 16, 2, 300),
                                     (77, 5, 1, 1), (64, 33, 0, 4)])
def test_kernel_equals_plain_version(cuda_device, per_row, b, s, l, c):
    case = _case(np.random.default_rng(b + s), b, s, l, c, per_row, cuda_device)
    before = decide_and_match.launches
    mine = decide_and_match.by_thread.get(threading.get_ident(), 0)
    got = decide_and_match(*case)
    torch.cuda.synchronize()
    assert decide_and_match.launches == before + 1
    assert decide_and_match.by_thread[threading.get_ident()] == mine + 1
    want = decide_and_match_plain(*case)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def _segments(rng, b, cap, device):
    """Segment ids in range, negative, out of range and SEG_NONE."""
    seg = rng.integers(-2 * cap - 1, 2 * cap + 2, b).astype(np.int32)
    seg[rng.random(b) < 0.1] = tm.SEG_NONE
    return tm.to_device(seg, device)


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("fleet", [False, True], ids=["three", "fleet"])
@pytest.mark.parametrize("per_row", [False, True], ids=["bucket_mask", "row_mask"])
@pytest.mark.parametrize("b,s,l,c,path", [
    (15, 128, 1, 8, "plain"), (16, 128, 1, 8, "bulk"), (17, 128, 1, 8, "bulk"),
    (4099, 1, 1, 8, "bulk"), (64, 8192, 1, 8, "plain"), (3000, 64, 2, 300, "bulk")])
def test_kernel_equals_plain_at_plan_edges(cuda_device, fleet, per_row, b, s, l, c, path):
    """Edges of the tile plan (S=128 gives 16-row tiles): no full tile,
    one full tile, a partial tail; S=1 (large tiles), an S too large for
    two stages, C=300."""
    rng = np.random.default_rng(b * s + c)
    case = _case(rng, b, s, l, c, per_row, cuda_device)
    seg = dict(seg_ids=_segments(rng, b, 8, cuda_device), seg_capacity=8) if fleet else {}
    got = decide_and_match(*case, **seg)
    torch.cuda.synchronize()
    assert cuda_kernels.last_plan.bulk == (path == "bulk")
    _assert_equal(got, decide_and_match_plain(*case, **seg))


@pytest.mark.parametrize("which", [0, 1, 2, 3, 4, 5, 7])
def test_misaligned_view_takes_the_plain_path(cuda_device, which):
    """A row-offset view (contiguous, off a 16-byte boundary) of one input
    sends the whole call through the plain-load path, with equal results."""
    rng = np.random.default_rng(which)
    b, s = 4096, 5
    case = list(_case(rng, b + 1, s, 1, 8, True, cuda_device))
    seg = _segments(rng, b + 1, 8, cuda_device)
    tensors = case + [seg]
    tensors = [t[1:] if i == which else t[:b] for i, t in enumerate(tensors)]
    tensors = [t if t.is_contiguous() else t.contiguous() for t in tensors]
    tensors[6] = case[6]  # the selectors are not per row
    got = decide_and_match(*tensors[:7], seg_ids=tensors[7], seg_capacity=8)
    torch.cuda.synchronize()
    assert not cuda_kernels.last_plan.bulk
    _assert_equal(got, decide_and_match_plain(*tensors[:7], seg_ids=tensors[7],
                                              seg_capacity=8))


def test_serving_shape_runs_the_bulk_path(cuda_device):
    rng = np.random.default_rng(5)
    b = 131072
    case = _case(rng, b, 64, 1, 8, True, cuda_device)
    seg = dict(seg_ids=_segments(rng, b, 8, cuda_device), seg_capacity=8)
    got = decide_and_match(*case, **seg)
    torch.cuda.synchronize()
    plan = cuda_kernels.last_plan
    assert plan.bulk and plan.tail_rows == 0 and plan.stages >= 2
    _assert_equal(got, decide_and_match_plain(*case, **seg))


@pytest.mark.parametrize("spec,b", [("4", 131072), ("4", 1027), ("2x2", 8200)])
def test_sharded_fleet_form_equals_plain_version(cuda_device, spec, b):
    from kcp_tpu_torch.ops.cuda_kernels import decide_and_match_sharded
    from kcp_tpu_torch.parallel.mesh import mesh_from_spec

    mesh = mesh_from_spec(spec, devices=[cuda_device] * 4)
    rng = np.random.default_rng(b)
    case = _case(rng, b, 32, 1, 8, True, cuda_device)
    seg = _segments(rng, b, 8, cuda_device)
    before = decide_and_match_sharded.launches
    dec, ups, counts, seg_counts = decide_and_match_sharded(
        mesh, *case, seg_ids=seg, seg_capacity=8)
    torch.cuda.synchronize()
    assert decide_and_match_sharded.launches == before + 1  # one per device
    _assert_equal((dec.full(), ups.full(), counts, seg_counts),
                  decide_and_match_plain(*case, seg_ids=seg, seg_capacity=8))


def test_fleet_steps_on_card_run_no_index_add(cuda_device):
    """The per-segment count comes from the kernel: neither fleet step
    calls index_add_ on the card."""
    from torch.profiler import ProfilerActivity, profile

    from kcp_tpu_torch.parallel.mesh import FLAGS, ShardedTensor, mesh_from_spec, shard_state

    rng = np.random.default_rng(13)
    b, s = 4096, 16
    state = tm.example_state(b=b, s=s, r=8, p=4, l=1, c=8, dirty_frac=0.2)
    seg = rng.integers(0, 8, b).astype(np.int32)
    packed = tm.to_device(tm.pack_deltas(tm.example_deltas(b=b, s=s, d=64)), cuda_device)
    mesh = mesh_from_spec("4", devices=[cuda_device] * 4)
    sides = [(tm.state_from_numpy(state, cuda_device), tm.to_device(seg, cuda_device), {}),
             (shard_state(state, mesh),
              ShardedTensor.put(tm.to_device(seg, cuda_device), mesh, FLAGS), {"mesh": mesh})]
    for st, sg, kw in sides:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _st, _sg, wire = tm.reconcile_step_fleet(st, sg, packed, patch_capacity=256,
                                                     seg_capacity=8, **kw)
            torch.cuda.synchronize()
        ops = {e.key for e in prof.key_averages()}
        assert "aten::index_add_" not in ops, kw
        assert int(wire[-8:].sum()) > 0


def test_fleet_step_on_card_equals_cpu(cuda_device):
    rng = np.random.default_rng(11)
    b, s = 4096, 32
    state = tm.example_state(b=b, s=s, r=16, p=8, l=1, c=8, dirty_frac=0.2)
    state = state._replace(status_mask=rng.random((b, s)) < 0.2)
    packed = tm.pack_deltas(tm.example_deltas(b=b, s=s, d=128))
    acks = np.full(64, -1, np.int32)
    acks[:4] = [1, 2, 3, 4]
    seg = rng.integers(0, 10, b).astype(np.int32)
    wires = []
    for dev in (cuda_device, torch.device("cpu")):
        _st, _seg, wire = tm.reconcile_step_fleet(
            tm.state_from_numpy(state, dev), tm.to_device(seg, dev),
            tm.to_device(packed, dev), tm.to_device(acks, dev),
            patch_capacity=256, seg_capacity=8)
        wires.append(tm.wire_to_numpy(wire))
    assert wires[0].tobytes() == wires[1].tobytes()


def test_fused_core_closed_loop_on_card(cuda_device):
    from kcp_tpu_torch.bench import closed_loop
    from kcp_tpu_torch.syncer.core import FusedCore

    core = FusedCore(batch_window=0.0005)
    before = decide_and_match.launches
    out = asyncio.run(closed_loop(core, 4096, 64, churn=64, seconds=1.0,
                                  warmup_ticks=4))
    assert out["converged"]
    assert decide_and_match.launches - before >= core._fleet.stats["ticks"] > 0


@pytest.mark.parametrize("spec,b,s", [("4", 131072, 64), ("2x2", 8200, 32),
                                      ("4", 1027, 16)])
def test_sharded_kernel_equals_plain_version(cuda_device, spec, b, s):
    """One grouped launch over the repeated cuda:0 shards, counts summed
    in the kernel: equal to the unsharded plain version."""
    from kcp_tpu_torch.ops.cuda_kernels import decide_and_match_sharded
    from kcp_tpu_torch.parallel.mesh import mesh_from_spec

    mesh = mesh_from_spec(spec, devices=[cuda_device] * 4)
    case = _case(np.random.default_rng(b), b, s, 1, 8, True, cuda_device)
    before = decide_and_match_sharded.launches
    dec, ups, counts = decide_and_match_sharded(mesh, *case)
    torch.cuda.synchronize()
    assert decide_and_match_sharded.launches == before + 1  # one per device
    want = decide_and_match_plain(*case)
    assert torch.equal(dec.full(), want[0]) and torch.equal(ups.full(), want[1])
    assert torch.equal(counts, want[2])


@pytest.mark.parametrize("per_row", [True, False], ids=["row_mask", "bucket_mask"])
@pytest.mark.parametrize("spec,b,off", [("8", 131071, None), ("4", 131072, 1),
                                        ("4", 3, None), ("20", 20000, None)])
def test_grouped_launch_equals_plain_version(cuda_device, spec, b, off, per_row):
    """One launch per MAX_SHARDS shards of a card: 8 shards, a shard whose
    inputs start 4 bytes off (it alone takes the plain-load path), fewer
    rows than shards, and 20 shards (two launches); with the per-row mask
    and with the bucket-wide [S] mask, which each shard's tiles read from
    the shard's own copy."""
    from kcp_tpu_torch.ops.cuda_kernels import MAX_SHARDS, decide_and_match_sharded
    from kcp_tpu_torch.parallel import mesh as pm

    mesh = pm.mesh_from_spec(spec, devices=[cuda_device] * int(spec))
    rng = np.random.default_rng(b)
    case = (*_case(rng, b, 64, 1, 8, per_row, cuda_device),
            _segments(rng, b, 8, cuda_device))
    lays = [pm.ROWS, pm.FLAGS, pm.ROWS, pm.FLAGS, pm.ROWS if per_row else pm.SLOT_MASK,
            pm.FLAGS, pm.REPLICATED, pm.FLAGS]
    args = [pm.ShardedTensor.put(x, mesh, lay) for x, lay in zip(case, lays)]
    if off is not None:
        for a in args:
            if a.layout.rows:
                blk = a.blocks[off][0]
                flat = torch.empty(blk.numel() * blk.element_size() + 4, dtype=torch.uint8,
                                   device=cuda_device)
                a.blocks[off] = [flat[4:].view(blk.dtype).view(blk.shape).copy_(blk)]
    before = decide_and_match_sharded.launches
    got = decide_and_match_sharded(mesh, *args, seg_capacity=8)
    torch.cuda.synchronize()
    assert decide_and_match_sharded.launches == before + -(-int(spec) // MAX_SHARDS)
    if off is not None:
        bulk = [t.bulk_tiles > 0 for t in cuda_kernels.last_plan.shards]
        assert bulk == [i != off for i in range(int(spec))]
    _assert_equal((got[0].full(), got[1].full(), *got[2:]),
                  decide_and_match_plain(*case[:7], seg_ids=case[7], seg_capacity=8))


@pytest.mark.parametrize("per_row", [True, False], ids=["row_mask", "bucket_mask"])
def test_sharded_kernel_across_cards_equals_plain_version(cuda_device, per_row):
    """A mesh over the visible cards, one row shard a card: each card's
    group is one shard, one launch a card, its counts summed on the lead."""
    from kcp_tpu_torch.ops.cuda_kernels import decide_and_match_sharded
    from kcp_tpu_torch.parallel import mesh as pm

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA cards or more: one row shard a card")
    mesh = pm.mesh_from_spec(str(n))
    b = 131071
    rng = np.random.default_rng(n)
    case = (*_case(rng, b, 64, 1, 8, per_row, mesh.lead),
            _segments(rng, b, 8, mesh.lead))
    before = decide_and_match_sharded.launches
    got = decide_and_match_sharded(mesh, *case[:7], seg_ids=case[7], seg_capacity=8)
    for i in range(n):
        torch.cuda.synchronize(i)
    assert decide_and_match_sharded.launches == before + n  # one per card
    assert {blk[0].device for blk in got[0].blocks} == set(mesh.local_devices)
    _assert_equal((got[0].full(), got[1].full(), *got[2:]),
                  decide_and_match_plain(*case[:7], seg_ids=case[7], seg_capacity=8))


def test_sharded_fleet_step_on_card_equals_unsharded(cuda_device):
    """A 4-shard step on cuda:0 gives the unsharded step's wire, bytes
    for bytes, over two chained ticks (the second overflows)."""
    from kcp_tpu_torch.parallel.mesh import FLAGS, ShardedTensor, mesh_from_spec, shard_state

    rng = np.random.default_rng(12)
    b, s = 8192, 32
    state = tm.example_state(b=b, s=s, r=16, p=8, l=1, c=8, dirty_frac=0.2)
    state = state._replace(status_mask=rng.random((b, s)) < 0.2)
    seg = (np.arange(b) // 1500).astype(np.int32)  # segments straddle shards
    mesh = mesh_from_spec("4", devices=[cuda_device] * 4)
    one = [tm.state_from_numpy(state, cuda_device), tm.to_device(seg, cuda_device)]
    sh = [shard_state(state, mesh),
          ShardedTensor.put(tm.to_device(seg, cuda_device), mesh, FLAGS)]
    for tick, cap in enumerate((4096, 64)):
        packed = tm.pack_deltas(tm.example_deltas(b=b, s=s, d=128, seed=tick))
        acks = np.full(64, -1, np.int32)
        acks[:4] = [1, 2050, 4100, 8000]
        wires = []
        for side, kw in ((one, {}), (sh, {"mesh": mesh})):
            side[0], side[1], wire = tm.reconcile_step_fleet(
                side[0], side[1], tm.to_device(packed, cuda_device),
                tm.to_device(acks, cuda_device), patch_capacity=cap,
                seg_capacity=8, **kw)
            wires.append(tm.wire_to_numpy(wire))
        assert wires[0].tobytes() == wires[1].tobytes(), tick
        assert bool(wires[0][1]) == (cap == 64)


def _two_cards() -> int:
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two CUDA cards or more, {n} visible")
    return n


def _fleet_ticks(b: int = 8192, s: int = 32):
    """A seeded fleet state and two chained ticks (the second overflows)."""
    rng = np.random.default_rng(12)
    state = tm.example_state(b=b, s=s, r=16, p=8, l=1, c=8, dirty_frac=0.2)
    state = state._replace(status_mask=rng.random((b, s)) < 0.2)
    seg = (np.arange(b) // 1500).astype(np.int32)  # segments straddle shards
    ticks = []
    for tick, cap in enumerate((4096, 64)):
        acks = np.full(64, -1, np.int32)
        acks[:4] = [1, 2050, 4100, 8000]
        ticks.append((tm.pack_deltas(tm.example_deltas(b=b, s=s, d=128, seed=tick)), acks,
                      cap))
    return state, seg, ticks


def test_sharded_fleet_step_across_cards_equals_unsharded(cuda_device):
    """A step over a row shard on each visible card gives the unsharded
    step's wire on cuda:0, bytes for bytes, over two chained ticks (the
    second overflows), with one sharded kernel launch per card a tick."""
    from kcp_tpu_torch.ops.cuda_kernels import decide_and_match_sharded
    from kcp_tpu_torch.parallel.mesh import FLAGS, ShardedTensor, mesh_from_spec, shard_state

    n = _two_cards()
    mesh = mesh_from_spec(str(n))
    assert mesh.local_devices == tuple(torch.device("cuda", i) for i in range(n))
    state, seg, ticks = _fleet_ticks()
    dev = mesh.lead
    one = [tm.state_from_numpy(state, dev), tm.to_device(seg, dev)]
    sh = [shard_state(state, mesh), ShardedTensor.put(tm.to_device(seg, dev), mesh, FLAGS)]
    for tick, (packed, acks, cap) in enumerate(ticks):
        wires = []
        for side, kw in ((one, {}), (sh, {"mesh": mesh})):
            before = decide_and_match_sharded.launches
            side[0], side[1], wire = tm.reconcile_step_fleet(
                side[0], side[1], tm.to_device(packed, dev), tm.to_device(acks, dev),
                patch_capacity=cap, seg_capacity=8, **kw)
            wires.append(tm.wire_to_numpy(wire))
        assert decide_and_match_sharded.launches - before == n, tick
        assert wires[0].tobytes() == wires[1].tobytes(), tick
        assert bool(wires[0][1]) == (cap == 64)
    assert {blk[0].device for blk in sh[0].up_vals.blocks} == set(mesh.local_devices)


_NCCL_RANK = r"""
import json, sys
sys.path.insert(0, REPO)
import numpy as np, torch
import torch.distributed as dist
from kcp_tpu_torch.models import reconcile_model as tm
from kcp_tpu_torch.ops.cuda_kernels import decide_and_match_sharded as kernel
from kcp_tpu_torch.parallel import mesh as pmesh
from kcp_tpu_torch.parallel.distributed import init_distributed

init_distributed()
mesh = pmesh.mesh_on("2x1x1", None)
dev = mesh.lead
case = np.load(CASE)
state = tm.ReconcileState(*(case[f] for f in tm.ReconcileState._fields))
sh = [pmesh.shard_state(state, mesh),
      pmesh.ShardedTensor.put(tm.to_device(case["seg"], dev), mesh, pmesh.FLAGS)]
wires = []
for tick, cap in enumerate(case["caps"].tolist()):
    sh[0], sh[1], wire = tm.reconcile_step_fleet(
        sh[0], sh[1], tm.to_device(case[f"packed{tick}"], dev),
        tm.to_device(case[f"acks{tick}"], dev), patch_capacity=cap, seg_capacity=8,
        mesh=mesh)
    wires.append(tm.wire_to_numpy(wire).tolist())
print(json.dumps({"backend": dist.get_backend(), "cards": [str(d) for d in mesh.local_devices],
                  "current": torch.cuda.current_device(), "launches": kernel.launches,
                  "wires": wires}))
dist.destroy_process_group()
"""


def test_two_nccl_ranks_wires_equal_the_one_process_mesh(cuda_device, tmp_path):
    """Two rank processes, each serving on a card of its own (no device:
    ``init_distributed`` picks NCCL), over ``2x1x1``: each rank reports
    ``nccl`` on its own card, launches once a tick, and every wire equals
    the one-process ``2x1x1`` run's over the visible cards."""
    import json
    import os
    import socket
    import subprocess
    import sys

    from kcp_tpu_torch.parallel.mesh import FLAGS, ShardedTensor, mesh_from_spec, shard_state

    _two_cards()
    state, seg, ticks = _fleet_ticks()
    case = {f: np.asarray(getattr(state, f)) for f in tm.ReconcileState._fields}
    case.update(seg=seg, caps=np.array([cap for _p, _a, cap in ticks]))
    for tick, (packed, acks, _cap) in enumerate(ticks):
        case[f"packed{tick}"], case[f"acks{tick}"] = packed, acks
    np.savez(tmp_path / "case.npz", **case)
    mesh = mesh_from_spec("2x1x1")
    dev = mesh.lead
    sh = [shard_state(state, mesh), ShardedTensor.put(tm.to_device(seg, dev), mesh, FLAGS)]
    want = []
    for packed, acks, cap in ticks:
        sh[0], sh[1], wire = tm.reconcile_step_fleet(
            sh[0], sh[1], tm.to_device(packed, dev), tm.to_device(acks, dev),
            patch_capacity=cap, seg_capacity=8, mesh=mesh)
        want.append(tm.wire_to_numpy(wire).tolist())
    assert bool(want[1][1]), "overflow coverage went vacuous"
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("LOCAL_RANK", "LOCAL_WORLD_SIZE") and not k.startswith("KCP_")}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
               NCCL_SOCKET_IFNAME="lo")
    code = _NCCL_RANK.replace("REPO", repr(repo)).replace("CASE", repr(str(tmp_path / "case.npz")))
    procs = [subprocess.Popen([sys.executable, "-c", code], env={**env, "RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        got.append(json.loads(out.strip().splitlines()[-1]))
    assert [g["backend"] for g in got] == ["nccl", "nccl"]
    assert got[0]["cards"] != got[1]["cards"]
    for g in got:
        assert len(g["cards"]) == 1 and g["cards"][0] == f"cuda:{g['current']}"
        assert g["launches"] == len(ticks)
        assert g["wires"] == want


@pytest.mark.parametrize("t", [1, 7, 256])
def test_schema_hashes_on_card_equal_cpu(cuda_device, t):
    from kcp_tpu_torch.ops.schemahash import schema_hashes

    rng = np.random.default_rng(t)
    toks = rng.integers(0, 2**32, (513, t), dtype=np.uint64).astype(np.uint32)
    toks[:, 0] = 2**32 - 1
    want = schema_hashes(torch.from_numpy(toks))
    got = schema_hashes(torch.from_numpy(toks).to(cuda_device))
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("mesh", [None, "4"])
def test_kubecon_demo_on_card(cuda_device, mesh):
    from kcp_tpu_torch import demo
    from kcp_tpu_torch.ops.cuda_kernels import decide_and_match_sharded

    counter = decide_and_match if mesh is None else decide_and_match_sharded
    counter.launches = 0
    m = demo.demo_mesh(mesh or "", None)
    got = asyncio.run(demo.run("kubecon", None, m))
    assert got == demo.golden()[-len(got):] and got[0] == "=== demo: kubecon ==="
    assert counter.launches > 0


def test_controller_plane_on_card(cuda_device):
    from kcp_tpu_torch import demo

    decide_and_match.launches = 0
    out = asyncio.run(demo.controller_plane_load(None, None, n_logical=2,
                                                 n_physical=3, roots=32, seed=3))
    assert out["leaves"] == 2 * 3 * 32 and out["fused_placements"] == 64
    assert decide_and_match.launches > 0


def test_front_door_on_card_feeds_the_ledger_as_on_the_cpu(cuda_device, tmp_path):
    """kcp start's server with its controllers on the card: one fake
    cluster's Deployments synced over REST, /debug/trace written, and the
    ledger's device lane equal to the same load's on the CPU."""
    from kcp_tpu_torch import demo

    card = demo.front_door_load(None, 1, 1, 4, seed=3, timeout=120.0,
                                trace_dir=str(tmp_path))
    assert card["launches"] >= card["ticks"] - card["empty_ticks"] > 0
    host = demo.front_door_load("cpu", 1, 1, 4, seed=3, timeout=120.0)
    assert card["leaves"] == host["leaves"] == 4
    assert card["device_lane"] == host["device_lane"] == {"lc-00": 4}
    assert card["usage_device"] == host["usage_device"] == 4


@pytest.mark.parametrize("mesh", [None, "4"])
def test_fleet_solver_on_card_equals_solve_host(cuda_device, mesh):
    """The placement benchmark's shape (10,000 workspaces x 8 physical
    clusters, spread 2, seed 17): the solve on the card byte-equal to the
    numpy twin, unsharded and over mesh "4" (cuda:0 x4), full and on
    the 37-row incremental re-solve."""
    from kcp_tpu_torch.bench import placement_inputs
    from kcp_tpu_torch.fleet.solver import FleetSolver, solve_host
    from kcp_tpu_torch.parallel.mesh import mesh_from_spec

    x = placement_inputs(10000, 8, 37)
    args = [x[k] for k in ("demand", "cand", "alloc", "region", "home")]
    m = None if mesh is None else mesh_from_spec(mesh, devices=[cuda_device] * 4)
    solver = FleetSolver(spread=2, mesh=m)
    assert solver.device.type == "cuda"
    assert np.array_equal(solver.solve(*args), solve_host(*args, 2))
    args[1] = x["cand2"]
    rows = [int(i) for i in x["dirty_rows"]]
    before = solver.stats["rows_solved"]
    assert np.array_equal(solver.solve(*args, rows=rows), solve_host(*args, 2))
    assert solver.stats["rows_solved"] - before == 37


def test_fleet_placement_through_kcp_start_on_card(cuda_device):
    from kcp_tpu_torch import demo

    out = demo.fleet_front_door_load(None, 2, 2, 8, timeout=120.0)
    assert out["launches"] > 0 and out["leaves"] > 0
    assert out["capacity_change"]["first_solve_rows"] == 8


@pytest.mark.parametrize("name", ["capacity-skew-binpack", "fleet-churn"])
def test_scenario_on_card_passes_every_slo(cuda_device, name, tmp_path):
    from kcp_tpu_torch.ops.cuda_kernels import decide_and_match
    from kcp_tpu_torch.scenarios import SCENARIOS, run_scenario

    before = decide_and_match.launches
    r = run_scenario(SCENARIOS[name], seed=42, scale=1.0, workdir=str(tmp_path),
                     device="cuda")
    assert r["passed"], [row for row in r["slos"] if not row["passed"]]
    if name == "fleet-churn":
        assert decide_and_match.launches > before
