"""The port's serving paths under the reference's fuzz and scale tests,
on the CPU.

The reference's cases of ``test_watch_fuzz.py``, ``test_watch_scale.py``
(watch windows, eviction, coalescing, bookmarks, watches spread over
read replicas through the router),
``test_differential_fuzz.py`` (``start_syncer`` fused against host, on
a mesh too) and ``test_fleet.py`` (the fleet batch, quarantine, the
ledger's segment counts, a mesh), run against the port
(``test_torch_engine.port_module``). Left out, for a named reason:
``test_fleet.py::test_fleet_on_mesh_matches_unsharded_fleet``: it
asserts the JAX ``PartitionSpec`` of the fleet state
(``.sharding.spec``). ``test_fleet_on_mesh_matches_unsharded_fleet_port``
below runs the same schedule and asserts the same layout on the port's
``ShardedTensor``.
"""

import asyncio

import numpy as np
import pytest

from test_torch_engine import _cases, port_module, run_mirrored

_SKIP = {
    "test_fleet.py": ("test_fleet_on_mesh_matches_unsharded_fleet",),
}
FILES = ("test_watch_fuzz.py", "test_watch_scale.py", "test_differential_fuzz.py",
         "test_fleet.py")
MIRRORED = [c for f in FILES for c in _cases(f, skip=_SKIP.get(f, ()))]


@pytest.mark.parametrize("ref_file,name,kwargs", MIRRORED)
def test_reference_fuzz_case_against_the_port(ref_file, name, kwargs, request):
    run_mirrored(ref_file, name, kwargs, request)


def test_mirrored_fuzz_files_leave_out_only_the_named_cases():
    names = {(p.values[0], p.values[1]) for p in MIRRORED}
    for ref_file, skipped in _SKIP.items():
        assert not {(ref_file, n) for n in skipped} & names
        assert all(hasattr(port_module(ref_file), n) for n in skipped)
    # 1 + 10 + 6 + 7 test functions, less the one above
    assert len(names) == 23


def test_fleet_on_mesh_matches_unsharded_fleet_port():
    """``test_fleet.py::test_fleet_on_mesh_matches_unsharded_fleet`` on
    the port: the same schedule on an 8-way tenants mesh (8 CPU shards)
    emits the streams the single-device fleet emits, and the fleet state
    carries the layout of the reference's ``(tenants, slots)`` spec on
    this mesh: the [B, S] mirrors split over the 8 row shards, and the
    slots axis of size 1 leaves each row block whole (one block holding
    every slot column)."""
    from kcp_tpu_torch.parallel.mesh import Layout, ShardedTensor, make_mesh, row_bounds
    from kcp_tpu_torch.syncer.core import FusedCore

    ref = port_module("test_fleet.py")
    widths = ref.WIDTHS

    async def main():
        single, _, _ = await ref._run_schedule(True, seed=5)
        mesh = make_mesh(n_devices=8, tenants=8, slots=1, devices=["cpu"] * 8)
        core = FusedCore(batch_window=0.0005, pipeline="double", fleet=True,
                         mesh=mesh, device="cpu")
        owners = [ref.Owner(core, 256, w) for w in widths]
        owners.append(ref.Owner(core, 3, widths[0]))
        await core.start()
        buckets = list({id(o.section.bucket): o.section.bucket
                        for o in owners}.values())
        rng = np.random.default_rng(5)
        for _ in range(15):
            before = {id(b): b.stats["ticks"] for b in buckets}
            for o in owners:
                hi = min(100, o.B)
                n = int(rng.integers(1, min(16, hi + 1)))
                touched = rng.choice(hi, size=n, replace=False)
                o.up_vals[touched] = rng.integers(1, 2**32, (n, o.S), dtype=np.uint32)
                core.enqueue_many(o.section, False, touched.tolist())
            assert await ref.wait_until(
                lambda: all(b.stats["ticks"] > before[id(b)] for b in buckets), 15)
        fleet = core._fleet
        up = fleet._state.up_vals
        assert isinstance(up, ShardedTensor) and up.layout == Layout(rows=True, cols=False)
        # fleet rows pad to the row factor: 8-way mesh -> B % 8 == 0
        assert fleet.B % 8 == 0 and fleet.B > 0
        assert up.bounds == row_bounds(fleet.B, 8)
        assert len(up.blocks) == 8 and all(len(r) == 1 for r in up.blocks)
        for (lo, hi), (block,) in zip(up.bounds, up.blocks):
            assert tuple(block.shape) == (hi - lo, up.shape[1])
        await core.stop()
        meshed = [ref._stream_bytes(o.stream) for o in owners]
        assert meshed == single, "mesh-sharded fleet diverged from single-device"

    asyncio.run(main())
