"""The port's reconcile step against the JAX step, on the CPU.

A seeded fuzz feeds one numpy state and one packed wire to
``kcp_tpu.models.reconcile_model`` and ``kcp_tpu_torch.models.
reconcile_model``; the int32 output wires must be byte-equal, and so must
the resident state after the step. It covers both mask forms, acks with
-1 padding, mask and segment stamps, patch overflow, the placement
segment, and several chained steps. All integers: exact equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kcp_tpu.models import reconcile_model as jm
from kcp_tpu_torch.models import reconcile_model as tm

_JAX_PACKED = jax.jit(jm.reconcile_step_packed, static_argnames=("patch_capacity",))
_JAX_FLEET = jax.jit(jm.reconcile_step_fleet,
                     static_argnames=("patch_capacity", "seg_capacity"))


def _as_int32(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _assert_state_equal(port_state, jax_state) -> None:
    for name in jm.ReconcileState._fields:
        np.testing.assert_array_equal(
            getattr(port_state, name).numpy(), _as_int32(getattr(jax_state, name)),
            err_msg=name)


def _fuzz_case(rng, b, s, per_row_mask, d=64, n_acks=8, ack_cap=32, seg_cap=8):
    """(state, seg_ids, packed, acks) with every wire feature present."""
    state = jm.example_state(b=b, s=s, r=16, p=4, l=2, c=8,
                             seed=int(rng.integers(1 << 30)), dirty_frac=0.3)
    if per_row_mask:
        state = state._replace(status_mask=rng.random((b, s)) < 0.25)
    # some deleted / not-yet-created rows on either side
    up_e = rng.random(b) < 0.9
    dn_e = rng.random(b) < 0.9
    state = state._replace(up_exists=up_e, down_exists=dn_e,
                           current=rng.integers(0, 20, (16, 4)).astype(np.int32))
    deltas = jm.example_deltas(b=b, s=s, d=d, seed=int(rng.integers(1 << 30)))
    packed = jm.pack_deltas(deltas)
    # mask stamps (with segment ids) for a few rows, some as padding
    n_st = 6
    stamp_rows = rng.choice(b, n_st, replace=False).astype(np.uint32)
    segs = rng.integers(0, seg_cap + 3, n_st).astype(np.uint32)  # some out of range
    stamps = np.zeros((n_st, s + 2), np.uint32)
    stamps[:, :s] = rng.random((n_st, s)) < 0.3
    stamps[:, s] = stamp_rows
    stamps[:, s + 1] = 4 | jm.MASK_STAMP_BIT | (segs << jm.SEG_SHIFT)
    stamps[-1, s + 1] &= ~np.uint32(4)  # an invalid stamp: must not apply
    packed = np.concatenate([packed, stamps])
    # acks: rows no up-side delta touches (the host's eligibility rule),
    # padded with -1
    up_rows = set(deltas.idx[deltas.valid & ~deltas.side].tolist())
    free = np.array([r for r in range(b) if r not in up_rows])
    acks = np.full(ack_cap, -1, np.int32)
    acks[:n_acks] = rng.choice(free, n_acks, replace=False)
    seg_ids = rng.integers(0, seg_cap + 2, b).astype(np.int32)
    seg_ids[rng.random(b) < 0.1] = jm.SEG_NONE
    return state, seg_ids, packed, acks


@pytest.mark.parametrize("per_row_mask", [False, True], ids=["bucket_mask", "row_mask"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("capacity", [8, 256], ids=["overflow", "fits"])
def test_packed_step_wire_matches_jax(seed, per_row_mask, capacity):
    rng = np.random.default_rng(seed)
    b, s = 256, 16
    state, _seg, packed, acks = _fuzz_case(rng, b, s, per_row_mask)
    js, jw = _JAX_PACKED(jax.tree.map(jnp.asarray, state), jnp.asarray(packed),
                         jnp.asarray(acks), patch_capacity=capacity)
    ts, tw = tm.reconcile_step_packed(
        tm.state_from_numpy(state, "cpu"), torch.from_numpy(packed.view(np.int32)),
        torch.from_numpy(acks), patch_capacity=capacity)
    jw = np.asarray(jw)
    assert tm.wire_to_numpy(tw).tobytes() == jw.tobytes()
    assert bool(jw[1]) == (capacity == 8), "overflow coverage went vacuous"
    assert jw[tm.PACK_PLACEMENT_COUNT] > 0, "placement segment went vacuous"
    _assert_state_equal(ts, js)


@pytest.mark.parametrize("per_row_mask", [False, True], ids=["bucket_mask", "row_mask"])
@pytest.mark.parametrize("seed", [3, 4, 5])
def test_fleet_step_wire_matches_jax_over_chained_steps(seed, per_row_mask):
    """Three chained fleet steps (resident state carried, in place on the
    port side), ragged B, segment stamps and the per-segment tail."""
    rng = np.random.default_rng(seed)
    b, s, seg_cap = 200, 24, 8
    state, seg, packed, acks = _fuzz_case(rng, b, s, per_row_mask, seg_cap=seg_cap)
    jstate = jax.tree.map(jnp.asarray, state)
    jseg = jnp.asarray(seg)
    tstate = tm.state_from_numpy(state, "cpu")
    tseg = torch.from_numpy(seg.copy())
    for step in range(3):
        if step:
            _s, _seg, packed, acks = _fuzz_case(rng, b, s, per_row_mask, seg_cap=seg_cap)
        jstate, jseg, jw = _JAX_FLEET(jstate, jseg, jnp.asarray(packed),
                                      jnp.asarray(acks), patch_capacity=64,
                                      seg_capacity=seg_cap)
        tstate, tseg, tw = tm.reconcile_step_fleet(
            tstate, tseg, torch.from_numpy(packed.view(np.int32)),
            torch.from_numpy(acks), patch_capacity=64, seg_capacity=seg_cap)
        assert tm.wire_to_numpy(tw).tobytes() == np.asarray(jw).tobytes(), step
        np.testing.assert_array_equal(tseg.numpy(), np.asarray(jseg))
        _assert_state_equal(tstate, jstate)
    counts = tm.unpack_seg_counts(tm.wire_to_numpy(tw), 64, 16, 4, seg_cap)
    assert counts.sum() > 0


def test_ack_lane_padding_never_clobbers_row_zero():
    base = jm.example_state(b=64, s=16, r=8, p=8, l=4, c=8)
    down = np.asarray(base.down_vals).copy()
    down[0] = 12345
    base = base._replace(down_vals=down)
    packed = torch.zeros((8, 18), dtype=torch.int32)
    # padding-only acks: row 0 stays divergent
    s1, _ = tm.reconcile_step_packed(tm.state_from_numpy(base, "cpu"), packed,
                                     torch.full((8,), -1, dtype=torch.int32),
                                     patch_capacity=16)
    np.testing.assert_array_equal(s1.down_vals[0].numpy(), down[0].view(np.int32))
    # a real ack for row 0 among padding: down becomes exactly up
    acks = torch.full((8,), -1, dtype=torch.int32)
    acks[0] = 0
    s2, _ = tm.reconcile_step_packed(tm.state_from_numpy(base, "cpu"), packed,
                                     acks, patch_capacity=16)
    np.testing.assert_array_equal(s2.down_vals[0].numpy(),
                                  base.up_vals[0].view(np.int32))
    assert bool(s2.down_exists[0])


def test_mask_stamp_wire_entry_updates_device_mask():
    s = 16
    base = jm.example_state(b=64, s=s, r=8, p=8, l=4, c=8, dirty_frac=0.0)
    down = np.asarray(base.down_vals).copy()
    down[3, s - 1] ^= 1
    base = base._replace(status_mask=np.zeros((64, s), bool), down_vals=down)
    state = tm.state_from_numpy(base, "cpu")
    state, wire = tm.reconcile_step_packed(
        state, torch.zeros((8, s + 2), dtype=torch.int32), None, patch_capacity=16)
    idx, code, upsync, _, _ = tm.unpack_patches(tm.wire_to_numpy(wire))
    assert idx.tolist() == [3] and code.tolist() == [2] and not upsync[0]
    stamp = np.zeros((8, s + 2), np.uint32)
    stamp[0, s - 1] = 1
    stamp[0, s] = 3
    stamp[0, s + 1] = 4 | tm.MASK_STAMP_BIT
    state, wire = tm.reconcile_step_packed(
        state, torch.from_numpy(stamp.view(np.int32)), None, patch_capacity=16)
    idx, code, upsync, _, _ = tm.unpack_patches(tm.wire_to_numpy(wire))
    assert idx.tolist() == [3] and code.tolist() == [0] and bool(upsync[0])
    np.testing.assert_array_equal(state.down_vals.numpy(), down.view(np.int32))


def test_model_wrapper_and_example_generators_match_jax():
    """example_state/example_deltas are the reference's generators seed
    for seed, and ReconcileModel's outputs equal the JAX model's."""
    st, dl = tm.example_state(b=512, s=32, r=32, p=8, l=4, c=16), \
        tm.example_deltas(b=512, s=32, d=64)
    jst, jdl = jm.example_state(b=512, s=32, r=32, p=8, l=4, c=16), \
        jm.example_deltas(b=512, s=32, d=64)
    for a, b in zip(list(st) + list(dl), list(jst) + list(jdl)):
        np.testing.assert_array_equal(a, b)
    jmodel = jm.ReconcileModel(jst, donate=False)
    tmodel = tm.ReconcileModel(st, device="cpu")
    for _ in range(2):
        ref, got = jmodel.step(jdl), tmodel.step(dl)
        for name in ref._fields:
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(ref, name)), err_msg=name)


def test_wire_buffers_rotate_and_reset_on_the_cpu():
    bufs = tm.WireBuffers(2)
    slot, packed, acks = bufs.acquire(4, 6, 8)
    packed[:] = 7
    acks[:] = 3
    p_d, a_d = bufs.upload(slot)
    assert p_d.dtype == torch.int32 and int(p_d[0, 0]) == 7
    slot2, packed2, _ = bufs.acquire(4, 6, 8)
    assert slot2 != slot
    slot3, packed3, acks3 = bufs.acquire(4, 6, 8)
    assert slot3 == slot and (packed3 == 0).all() and (acks3 == -1).all()
    assert packed3.dtype == np.uint32 and acks3.dtype == np.int32
    assert bufs.reuse_waits == 0
    wire = tm.HostWire(torch.arange(5, dtype=torch.int32))
    assert wire.is_ready() and np.asarray(wire).tolist() == [0, 1, 2, 3, 4]


def test_mesh_and_missing_card_are_refused():
    st = tm.state_from_numpy(tm.example_state(b=64, s=8, r=8, p=4, l=1, c=2), "cpu")
    dl = tm.deltas_from_numpy(tm.example_deltas(b=64, s=8, d=8), "cpu")
    # a mesh step takes a state sharded over that mesh (shard_state); an
    # unsharded state is refused, not silently stepped whole
    with pytest.raises(TypeError, match="shard_state"):
        tm.reconcile_step(st, dl, mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tm.state_from_numpy(tm.example_state(b=8, s=8, r=8, p=4, l=1, c=2))
