"""The port on the card: the CUDA kernel against its plain version, the
step on the card against the step on the CPU, and a short FusedCore loop.

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
