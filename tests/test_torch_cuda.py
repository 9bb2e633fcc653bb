"""The port on the card: the CUDA kernel against its plain version (both
forms, every path of its tile plan), the step on the card against the
step on the CPU, and a short FusedCore loop.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one. The file imports neither JAX nor the JAX package, so on a machine
without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

All outputs are integers: every comparison is exact equality.
"""

import asyncio

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
    got = decide_and_match(*case)
    torch.cuda.synchronize()
    assert decide_and_match.launches == before + 1
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
    from kcp_tpu_torch.parallel.mesh import mesh_from_spec, row_factor

    mesh = mesh_from_spec(spec, devices=[cuda_device] * 4)
    rng = np.random.default_rng(b)
    case = _case(rng, b, 32, 1, 8, True, cuda_device)
    seg = _segments(rng, b, 8, cuda_device)
    before = decide_and_match_sharded.launches
    dec, ups, counts, seg_counts = decide_and_match_sharded(
        mesh, *case, seg_ids=seg, seg_capacity=8)
    torch.cuda.synchronize()
    assert decide_and_match_sharded.launches == before + row_factor(mesh)
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
    """Per-shard launches on repeated cuda:0 shards, counts accumulated
    per device: equal to the unsharded plain version."""
    from kcp_tpu_torch.ops.cuda_kernels import decide_and_match_sharded
    from kcp_tpu_torch.parallel.mesh import mesh_from_spec, row_factor

    mesh = mesh_from_spec(spec, devices=[cuda_device] * 4)
    case = _case(np.random.default_rng(b), b, s, 1, 8, True, cuda_device)
    before = decide_and_match_sharded.launches
    dec, ups, counts = decide_and_match_sharded(mesh, *case)
    torch.cuda.synchronize()
    assert decide_and_match_sharded.launches == before + row_factor(mesh)
    want = decide_and_match_plain(*case)
    assert torch.equal(dec.full(), want[0]) and torch.equal(ups.full(), want[1])
    assert torch.equal(counts, want[2])


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
