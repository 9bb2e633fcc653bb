"""The port's mesh serving against the JAX package's, on the CPU.

JAX meshes here are the conftest's 8 virtual CPU devices; the port's are
meshes whose device list repeats ``cpu`` (every shard is still its own
tensor). Cases mirror ``test_mesh_serving.py``, the mesh cases of
``test_pallas.py`` and ``test_model_sharding.py``: the spec grammar and
its errors, the sharded kernel against JAX ``decide_and_match_sharded``
in interpret mode, the sharded step against the JAX mesh step and the
unsharded port step (with an overflowing tick and a fleet segment that
straddles a shard boundary), a B that does not split evenly, a lockstep
``FusedCore(mesh=)`` patch stream against the JAX one, growth and
overflow under a mesh, and the ``init_distributed`` argument assembly and
group formation.
All outputs are integers: every comparison is exact equality.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kcp_tpu.models import reconcile_model as jm
from kcp_tpu.ops.pallas_kernels import decide_and_match_sharded as jax_sharded
from kcp_tpu.parallel import mesh as jmesh
from kcp_tpu_torch.models import reconcile_model as tm
from kcp_tpu_torch.ops.cuda_kernels import decide_and_match_plain, decide_and_match_sharded
from kcp_tpu_torch.parallel import mesh as pmesh
from kcp_tpu_torch.parallel.distributed import init_distributed
from kcp_tpu_torch.syncer.core import FusedBucket

from test_torch_core import ClosedLoopOwner, _lockstep, _until
from test_torch_distributed import form_world_of_two
from test_torch_model import _as_int32, _fuzz_case

CPU8 = [torch.device("cpu")] * 8
SPECS = ["8", "4x2", "2x2x2"]


def port_mesh(spec: str) -> pmesh.Mesh:
    return pmesh.mesh_from_spec(spec, devices=CPU8)


# ------------------------------------------------------------------ meshes


def test_mesh_from_spec_shapes():
    assert port_mesh("8").shape == {pmesh.TENANTS_AXIS: 8, pmesh.SLOTS_AXIS: 1}
    assert port_mesh("4x2").shape == {pmesh.TENANTS_AXIS: 4, pmesh.SLOTS_AXIS: 2}
    assert port_mesh("2x2x2").shape == {
        "hosts": 2, pmesh.TENANTS_AXIS: 2, pmesh.SLOTS_AXIS: 2}
    for spec in SPECS:  # same axes and shapes as the reference's meshes
        ref = jmesh.mesh_from_spec(spec)
        assert port_mesh(spec).shape == dict(zip(ref.axis_names, ref.devices.shape))
    for bad in ("3x3x3x3", "", "x2", "0"):
        with pytest.raises(ValueError):
            port_mesh(bad)
    with pytest.raises(ValueError):
        port_mesh("16")  # only 8 devices given


@pytest.mark.parametrize("spec,need", [("16", 16), ("4x4", 16), ("2x4x2", 16)])
def test_mesh_from_spec_validates_device_count_actionably(spec, need):
    """A short device list fails up front, naming the spec, the counts,
    and the way out (devices=, which may repeat a device)."""
    with pytest.raises(ValueError) as ei:
        port_mesh(spec)
    msg = str(ei.value)
    assert spec in msg and str(need) in msg and "have 8" in msg
    assert "devices=" in msg


def test_default_devices_are_the_cards():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device list is valid here")
    for build in (lambda: pmesh.mesh_from_spec("2"), lambda: pmesh.make_mesh(),
                  lambda: pmesh.mesh_from_spec("auto"),
                  lambda: pmesh.set_serving_mesh("2")):
        with pytest.raises(RuntimeError, match="devices="):
            build()
    assert pmesh.get_serving_mesh() is None


def test_row_and_slot_factor_on_non_pow2_meshes():
    m3 = pmesh.mesh_from_spec("3", devices=CPU8)
    assert pmesh.row_factor(m3) == 3 and pmesh.slot_factor(m3) == 1
    m32 = pmesh.make_mesh(n_devices=6, tenants=3, slots=2, devices=CPU8)
    assert pmesh.row_factor(m32) == 3 and pmesh.slot_factor(m32) == 2
    m5 = pmesh.make_mesh(n_devices=5, devices=CPU8)
    assert pmesh.row_factor(m5) == 5 and pmesh.slot_factor(m5) == 1
    b = FusedBucket(16, mesh=m3)
    b._grow(65)  # pad_pow2 -> 128, then up to a multiple of 3
    assert b.B >= 65 and b.B % 3 == 0
    b._pl_grow(9)
    assert b.R >= 9 and b.R % 3 == 0


def test_bucket_slot_axis_divisibility_error():
    m32 = pmesh.make_mesh(n_devices=6, tenants=3, slots=2, devices=CPU8)
    with pytest.raises(ValueError, match="slots axis"):
        FusedBucket(7, mesh=m32)


@pytest.mark.parametrize("spec", SPECS)
def test_shard_state_layout_and_round_trip(spec):
    """Rows over (hosts, tenants), [B,S] columns over slots, selectors
    replicated; every block is its own allocation; gathering gives the
    input back bit for bit."""
    mesh = port_mesh(spec)
    rf, sf = pmesh.row_factor(mesh), pmesh.slot_factor(mesh)
    st = tm.example_state(b=100, s=16, r=12, p=4, l=2, c=8)
    st = st._replace(status_mask=np.random.default_rng(0).random((100, 16)) < 0.3)
    sh = pmesh.shard_state(st, mesh)
    assert len(sh.up_vals.blocks) == rf and len(sh.up_vals.blocks[0]) == sf
    assert sh.up_vals.blocks[0][0].shape == (25 if rf == 4 else 13, 16 // sf)
    assert len(sh.up_exists.blocks[0]) == 1 and len(sh.sel_hashes.blocks) == rf
    ptrs = [b.data_ptr() for t in sh for r in t.blocks for b in r if b.numel()]
    assert len(ptrs) == len(set(ptrs)), "shards must not alias"
    for name, got in zip(tm.ReconcileState._fields, pmesh.gather_state(sh)):
        np.testing.assert_array_equal(got.numpy(), _as_int32(getattr(st, name)),
                                      err_msg=name)
    assert sh.up_vals.shape == (100, 16) and sh.avail.shape == (12, 4)


# ------------------------------------------------------------------ kernel


def _kernel_case(rng, b, s=64, l=8, c=16):
    up = rng.integers(1, 2**32, (b, s), dtype=np.uint32)
    down = up.copy()
    down[rng.random(b) < 0.2, rng.integers(0, s)] ^= 7
    upe = rng.random(b) < 0.9
    dne = rng.random(b) < 0.9
    rowmask = rng.random((b, s)) < 0.4
    pair = rng.integers(1, 24, (b, l), dtype=np.uint32)
    sel = rng.integers(1, 24, c, dtype=np.uint32)
    return up, upe, down, dne, rowmask, pair, sel


@pytest.mark.parametrize("per_row", [True, False], ids=["row_mask", "bucket_mask"])
@pytest.mark.parametrize("spec", SPECS)
def test_sharded_kernel_matches_jax_sharded_kernel(spec, per_row):
    """Port decide_and_match_sharded == JAX decide_and_match_sharded
    (Pallas in interpret mode under shard_map) == the unsharded lanes."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(11)
    case = list(_kernel_case(rng, 256))
    if not per_row:
        case[4] = rng.random(64) < 0.2
    jmesh_ = jmesh.mesh_from_spec(spec)
    row = (jmesh.HOSTS_AXIS, jmesh.TENANTS_AXIS) if jmesh.HOSTS_AXIS in jmesh_.axis_names \
        else jmesh.TENANTS_AXIS
    specs = (P(row, jmesh.SLOTS_AXIS), P(row), P(row, jmesh.SLOTS_AXIS), P(row),
             P(row, jmesh.SLOTS_AXIS) if per_row else P(), P(row, None), P())
    jargs = [jax.device_put(x, NamedSharding(jmesh_, sp)) for x, sp in zip(case, specs)]
    jdec, jups, jcounts = jax_sharded(jmesh_, *jargs, interpret=True)

    mesh = port_mesh(spec)
    targs = [tm.to_device(x, torch.device("cpu")) for x in case]
    dec, ups, counts = decide_and_match_sharded(mesh, *targs)
    np.testing.assert_array_equal(dec.full().numpy(), np.asarray(jdec))
    np.testing.assert_array_equal(ups.full().numpy(), np.asarray(jups))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    # and the unsharded plain lanes
    pd, pu, pc = decide_and_match_plain(*targs)
    assert torch.equal(dec.full(), pd) and torch.equal(ups.full(), pu)
    assert torch.equal(counts, pc) and int(pc.sum()) > 0


@pytest.mark.parametrize("b", [1028, 5, 0])
def test_sharded_kernel_on_uneven_and_tiny_row_counts(b):
    """Row counts that do not split evenly (or leave shards empty) split
    unevenly, never pad: the answer is the unsharded one."""
    rng = np.random.default_rng(b)
    case = [tm.to_device(x, torch.device("cpu")) for x in _kernel_case(rng, b, s=16)]
    dec, ups, counts = decide_and_match_sharded(port_mesh("8"), *case)
    pd, pu, pc = decide_and_match_plain(*case)
    assert torch.equal(dec.full(), pd) and torch.equal(ups.full(), pu)
    assert torch.equal(counts, pc)


# -------------------------------------------------------------------- step


@pytest.mark.parametrize("spec", SPECS)
def test_sharded_step_matches_jax_mesh_step_and_unsharded_step(spec):
    """The whole fused step (mirror of test_pallas.py's mesh step case):
    port sharded == JAX sharded with Pallas == port unsharded, outputs
    and resident state."""
    state = jm.example_state(b=1024, s=64, r=16, p=8, l=8, c=16, dirty_frac=0.2)
    deltas = jm.example_deltas(b=1024, s=64, d=64)
    jmesh_ = jmesh.mesh_from_spec(spec)
    step = jax.jit(jm.reconcile_step, static_argnames=("use_pallas", "mesh"))
    _, ref = step(jmesh.shard_state(state, jmesh_), deltas, use_pallas=True, mesh=jmesh_)

    mesh = port_mesh(spec)
    tstate, out = tm.reconcile_step(pmesh.shard_state(state, mesh),
                                    tm.deltas_from_numpy(deltas, "cpu"), mesh=mesh)
    one_state, one = tm.reconcile_step(tm.state_from_numpy(state, "cpu"),
                                       tm.deltas_from_numpy(deltas, "cpu"))
    for name in jm.ReconcileOutputs._fields:
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      _as_int32(getattr(ref, name)), err_msg=name)
        assert torch.equal(getattr(out, name), getattr(one, name)), name
    for name, got in zip(tm.ReconcileState._fields, pmesh.gather_state(tstate)):
        assert torch.equal(got, getattr(one_state, name)), name


@pytest.mark.parametrize("hosts,tenants,slots", [(1, 8, 1), (1, 4, 2), (2, 4, 1),
                                                 (2, 2, 2), (4, 2, 1)])
def test_sharded_step_matches_single_device_jax_step(hosts, tenants, slots):
    """test_model_sharding.py's mesh cases: the port's sharded step on a
    (hosts,) tenants x slots mesh equals the single-device JAX step, and
    each row shard holds B / (hosts x tenants) rows."""
    b, s = 256, 32
    state = jm.example_state(b=b, s=s, r=32, p=4, l=4, c=8, dirty_frac=0.05)
    deltas = jm.example_deltas(b=b, s=s, d=16)
    ref_state, ref = jax.jit(jm.reconcile_step)(state, deltas)
    if hosts > 1:
        mesh = pmesh.make_multihost_mesh(hosts, tenants, slots, devices=CPU8)
    else:
        mesh = pmesh.make_mesh(n_devices=8, tenants=tenants, slots=slots, devices=CPU8)
    new_state, out = tm.reconcile_step(pmesh.shard_state(state, mesh),
                                       tm.deltas_from_numpy(deltas, "cpu"), mesh=mesh)
    for name in ("decision", "stats", "leaf_replicas", "status_upsync", "match_counts"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      _as_int32(getattr(ref, name)), err_msg=name)
    np.testing.assert_array_equal(new_state.up_vals.full().numpy(),
                                  _as_int32(ref_state.up_vals))
    blk = new_state.up_vals.blocks[0][0]
    assert blk.shape == (b // (hosts * tenants), s // slots)


def test_non_divisible_b_matches_the_reference():
    """B=1028 over 8 shards (test_pallas.py): the reference answers
    through its XLA lanes; the port runs the kernel per shard over an
    uneven split and must give the same outputs."""
    state = jm.example_state(b=1028, s=16, r=8, p=4, l=2, c=4)
    deltas = jm.example_deltas(b=1028, s=16, d=16)
    jmesh_ = jmesh.make_mesh(n_devices=8, tenants=8, slots=1)
    step = jax.jit(jm.reconcile_step, static_argnames=("use_pallas", "mesh"))
    _, ref = step(state, deltas, use_pallas=True, mesh=jmesh_)
    mesh = pmesh.make_mesh(n_devices=8, tenants=8, slots=1, devices=CPU8)
    sh = pmesh.shard_state(state, mesh)
    assert {hi - lo for lo, hi in sh.up_vals.bounds} == {129, 125}
    _, out = tm.reconcile_step(sh, tm.deltas_from_numpy(deltas, "cpu"), mesh=mesh)
    for name in jm.ReconcileOutputs._fields:
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      _as_int32(getattr(ref, name)), err_msg=name)


@pytest.mark.parametrize("per_row_mask", [True, False], ids=["row_mask", "bucket_mask"])
@pytest.mark.parametrize("spec", SPECS)
def test_sharded_fleet_wires_byte_equal_jax_mesh_and_unsharded(spec, per_row_mask):
    """Three chained fleet ticks: acks with padding, mask and segment
    stamps, an overflowing tick, and segments laid out in runs of 100
    rows so that they straddle the 128-row shard boundaries. The port's
    sharded wire == the JAX mesh wire == the port's unsharded wire."""
    rng = np.random.default_rng(41)
    b, s, seg_cap = 1024, 16, 16
    state, _seg, packed, acks = _fuzz_case(rng, b, s, per_row_mask, seg_cap=seg_cap)
    seg = (np.arange(b) // 100).astype(np.int32)  # runs straddle 128-row shards
    seg[rng.random(b) < 0.05] = jm.SEG_NONE
    jmesh_ = jmesh.mesh_from_spec(spec)
    jfleet = jax.jit(jm.reconcile_step_fleet, static_argnames=(
        "patch_capacity", "seg_capacity", "use_pallas", "mesh"))
    jstate = jmesh.shard_state(state, jmesh_)
    jseg = jax.device_put(seg, jmesh.state_shardings(jmesh_)["flags"])
    mesh = port_mesh(spec)
    sstate = pmesh.shard_state(state, mesh)
    sseg = pmesh.ShardedTensor.put(torch.from_numpy(seg.copy()), mesh, pmesh.FLAGS)
    ostate, oseg = tm.state_from_numpy(state, "cpu"), torch.from_numpy(seg.copy())
    for tick, cap in enumerate((1024, 8, 1024)):
        if tick:
            _s, _g, packed, acks = _fuzz_case(rng, b, s, per_row_mask, seg_cap=seg_cap)
        jstate, jseg, jw = jfleet(jstate, jseg, jnp.asarray(packed), jnp.asarray(acks),
                                  patch_capacity=cap, seg_capacity=seg_cap,
                                  use_pallas=True, mesh=jmesh_)
        p_t, a_t = torch.from_numpy(packed.view(np.int32)), torch.from_numpy(acks)
        sstate, sseg, sw = tm.reconcile_step_fleet(
            sstate, sseg, p_t, a_t, patch_capacity=cap, seg_capacity=seg_cap, mesh=mesh)
        ostate, oseg, ow = tm.reconcile_step_fleet(
            ostate, oseg, p_t, a_t, patch_capacity=cap, seg_capacity=seg_cap)
        jw = np.asarray(jw)
        assert tm.wire_to_numpy(sw).tobytes() == jw.tobytes(), tick
        assert tm.wire_to_numpy(ow).tobytes() == jw.tobytes(), tick
        assert bool(jw[1]) == (cap == 8), "overflow coverage went vacuous"
        np.testing.assert_array_equal(sseg.full().numpy(), np.asarray(jseg))
        for name, got in zip(tm.ReconcileState._fields, pmesh.gather_state(sstate)):
            np.testing.assert_array_equal(got.numpy(), _as_int32(getattr(jstate, name)),
                                          err_msg=name)
    counts = tm.unpack_seg_counts(jw, 1024, 16, 4, seg_cap)
    assert (counts[1:3] > 50).all(), "straddling segments went vacuous"


def test_reconcile_model_with_mesh():
    state = jm.example_state(b=512, s=32, r=8, p=4, l=2, c=4, dirty_frac=0.1)
    deltas = jm.example_deltas(b=512, s=32, d=32)
    sharded = tm.ReconcileModel(state, mesh=port_mesh("4x2"))
    whole = tm.ReconcileModel(state, device="cpu")
    assert isinstance(sharded.state.up_vals, pmesh.ShardedTensor)
    for _ in range(2):
        a, b_ = sharded.step(deltas), whole.step(deltas)
        for name in tm.ReconcileOutputs._fields:
            assert torch.equal(getattr(a, name), getattr(b_, name)), name


# -------------------------------------------------------------------- core


@pytest.mark.parametrize("fleet", [False, True], ids=["buckets", "fleet"])
@pytest.mark.parametrize("pipeline", ["serial", "double"])
@pytest.mark.parametrize("spec", SPECS)
def test_lockstep_core_with_mesh_matches_jax_core(spec, pipeline, fleet):
    """Byte-identical patch streams: port FusedCore(mesh=) against JAX
    FusedCore(mesh=..., use_pallas=True), the harness of
    test_torch_core.py."""

    async def main():
        ref, ref_ticks = await _lockstep("jax", pipeline, fleet, 9, pallas=True,
                                         mesh=jmesh.mesh_from_spec(spec))
        got, got_ticks = await _lockstep("torch", pipeline, fleet, 9,
                                         mesh=port_mesh(spec))
        assert got_ticks == ref_ticks
        assert len(ref) > 1
        assert got == ref

    asyncio.run(main())


def test_growth_overflow_and_quarantine_under_a_mesh():
    """Bucket growth reshards, patch overflow doubles capacity and
    reticks, and a poisoned row is bisected with probes that step a
    clone of the sharded state — all on an 8-shard mesh."""
    from kcp_tpu_torch import faults

    async def main():
        from kcp_tpu_torch.syncer.core import FusedCore

        core = FusedCore(mesh=port_mesh("8"), batch_window=0.0005)
        owner = ClosedLoopOwner(core, 160, s=16)
        bucket = owner.section.bucket
        bucket.patch_capacity = 16
        await core.start()
        rows = list(range(150))  # > MIN_ROWS: growth, and > capacity: overflow
        owner.up_vals[rows] = np.arange(1, 151, dtype=np.uint32)[:, None]
        core.enqueue_many(owner.section, False, rows)
        assert await _until(lambda: (owner.down_vals == owner.up_vals).all())
        assert bucket.stats["overflows"] >= 1 and bucket.B >= 192
        state = core._fleet._state
        assert isinstance(state.up_vals, pmesh.ShardedTensor)
        assert state.up_vals.shape[0] == core._fleet.B
        faults.install(faults.FaultInjector("device.step:poison_row=3", seed=0))
        try:
            owner.up_vals[:8] += 1000
            core.enqueue_many(owner.section, False, list(range(8)))
            assert await _until(lambda: bucket.stats["quarantined"] >= 1)
            assert await _until(
                lambda: (owner.down_vals[[0, 1, 2, 4, 5, 6, 7]]
                         == owner.up_vals[[0, 1, 2, 4, 5, 6, 7]]).all())
            assert (owner.down_vals[3] != owner.up_vals[3]).any()
        finally:
            faults.clear()
        assert await _until(lambda: (owner.down_vals == owner.up_vals).all())
        await core.stop()

    asyncio.run(main())


def test_for_current_loop_falls_back_to_the_serving_mesh():
    from kcp_tpu_torch.syncer.core import FusedCore

    mesh = port_mesh("4x2")
    pmesh.set_serving_mesh(mesh)
    try:
        async def main():
            core = FusedCore.for_current_loop(pipeline="serial")
            assert core.mesh is mesh and core.device == torch.device("cpu")
            assert FusedCore.for_current_loop() is core

        asyncio.run(main())
    finally:
        pmesh.set_serving_mesh(None)


# ------------------------------------------------------------- distributed


def test_distributed_arg_assembly(monkeypatch):
    """Explicit args win over the torch.distributed environment; an
    explicit single process is a no-op; a larger world forms the group
    (two gloo ranks on 127.0.0.1, ``test_torch_distributed.py``)."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "envhost")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    assert init_distributed(_dry_run=True) == {
        "init_method": "tcp://envhost:1234", "world_size": 4, "rank": 2}
    assert init_distributed(coordinator="cli:9", num_processes=8, process_id=0,
                            _dry_run=True) == {
        "init_method": "tcp://cli:9", "world_size": 8, "rank": 0}
    form_world_of_two()
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var)
    assert init_distributed(num_processes=1) == {"world_size": 1}
