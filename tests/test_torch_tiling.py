"""The host side of the redesigned ``decide_and_match``: the tile plan,
the fleet form's plain version against the JAX fleet step, the checks of
``seg_ids`` and the build key.

The CUDA kernel runs only on a card (``tests/test_torch_cuda.py``); what
it is handed is decided here, on the host, so it is tested here. Every
comparison is exact: all outputs are integers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kcp_tpu.models import reconcile_model as jm
from kcp_tpu_torch.models import reconcile_model as tm
from kcp_tpu_torch.ops import cuda_kernels as ck

_JAX_FLEET = jax.jit(jm.reconcile_step_fleet,
                     static_argnames=("patch_capacity", "seg_capacity"))
ALIGNED = (1 << 20,) * 7  # every input on a 16-byte boundary


def _tile_plan(b, s, l, c, per_row, ptrs, fleet, cap=0, sms=132) -> ck.TilePlan:
    """The plan of one call over B rows (a group of one shard): ``ptrs``
    are the inputs' device addresses in ``ck.RANGES`` order."""
    aligned = ck._aligned(ptrs, ck._row_bytes(s, l, per_row, fleet))
    return ck._group_plan(((b, aligned),), s, l, c, per_row, fleet,
                          cap if fleet else 0, sms)


def _walk(plan: ck.TilePlan, b: int):
    """The kernel's walk: block k takes tiles k, k + grid, ...; tiles
    below ``bulk_tiles`` come through the ring, the rest through plain
    loads. Yields (first row, rows, bulk)."""
    for blk in range(plan.grid):
        for t in range(blk, plan.tiles, plan.grid):
            r0 = t * plan.tile
            yield r0, min(plan.tile, b - r0), t < plan.bulk_tiles


@pytest.mark.parametrize("fleet", [False, True], ids=["three", "fleet"])
@pytest.mark.parametrize("per_row", [False, True], ids=["bucket_mask", "row_mask"])
@pytest.mark.parametrize("s", [1, 5, 33, 64])
@pytest.mark.parametrize("b", [1, 15, 16, 17, 131071, 131072])
def test_plan_tiles_cover_every_row_once(b, s, per_row, fleet):
    plan = _tile_plan(b, s, 1, 8, per_row, ALIGNED, fleet, 8)
    assert plan.tile % 16 == 0 and plan.tile >= 16
    assert all(n % 16 == 0 for n in plan.ranges)
    assert plan.ranges[2] == (plan.tile * s if per_row else 0)
    assert plan.ranges[6] == (4 * plan.tile if fleet else 0)
    assert plan.smem <= ck.SMEM_BLOCK_MAX
    seen = np.zeros(b, np.int32)
    for r0, n, bulk in _walk(plan, b):
        assert n > 0
        assert not bulk or n == plan.tile  # the ring only takes full tiles
        seen[r0:r0 + n] += 1
    assert (seen == 1).all()
    assert plan.tail_rows == b - plan.bulk_tiles * plan.tile
    if plan.bulk:
        assert 2 <= plan.stages <= ck.MAX_STAGES
        assert plan.tail_rows < plan.tile
    else:
        assert plan.stages == 0 and plan.bulk_tiles == 0 and plan.tail_rows == b
    assert plan.bulk == (b >= plan.tile)  # aligned, small S: only size decides


def test_serving_shape_takes_the_bulk_path():
    plan = _tile_plan(131072, 64, 1, 8, True, ALIGNED, True, 8, sms=132)
    assert plan.bulk and plan.tail_rows == 0
    assert plan.tile == 32 and plan.stages == 2 and plan.grid == 2 * 132
    # one stage: up, down, mask, two exists flags, pair, seg ids
    assert plan.ranges == (8192, 8192, 2048, 32, 32, 128, 128)
    assert plan.bulk_tiles == plan.tiles == 4096


@pytest.mark.parametrize("which", range(7))
def test_misaligned_input_takes_the_plain_path(which):
    ptrs = list(ALIGNED)
    ptrs[which] += 1 if which in (2, 3, 4) else 4  # a row-offset view
    plan = _tile_plan(131072, 64, 1, 8, True, tuple(ptrs), True, 8)
    assert not plan.bulk and plan.tail_rows == 131072 and plan.stages == 0


def test_unloaded_inputs_do_not_decide_alignment():
    ptrs = list(ALIGNED)
    ptrs[2] += 1  # a bucket-wide mask is not bulk-copied
    ptrs[5] += 3  # L = 0: no pair hashes to copy
    ptrs[6] = 0  # no seg ids outside the fleet form
    plan = _tile_plan(4096, 64, 0, 8, False, tuple(ptrs), False)
    assert plan.bulk


def test_partial_tile_and_large_s_take_the_plain_path():
    ragged = _tile_plan(131071, 64, 1, 8, True, ALIGNED, True, 8)
    assert ragged.bulk and ragged.tail_rows == 131071 % ragged.tile
    huge = _tile_plan(1024, 8192, 1, 8, True, ALIGNED, True, 8)
    assert not huge.bulk and huge.tile == 16 and huge.tail_rows == 1024


def test_two_blocks_per_sm_halve_the_budget(monkeypatch):
    plans = {}
    for bps in (1, 2):
        monkeypatch.setattr(ck, "BLOCKS_PER_SM", bps)
        ck._group_plan.cache_clear()
        plans[bps] = _tile_plan(131072, 64, 1, 8, True, ALIGNED, True, 8)
    ck._group_plan.cache_clear()
    assert plans[2].grid == 2 * plans[1].grid
    assert 2 * (plans[2].smem + ck.SMEM_RESERVED) <= ck.SMEM_PER_SM


def test_plan_refuses_histograms_that_do_not_fit():
    with pytest.raises(ValueError, match="selectors"):
        _tile_plan(1024, 64, 1, 40000, True, ALIGNED, False)


# ------------------------------------------------------- the fleet form


def _nasty_segments(rng, b, cap):
    """Segment ids in range, negative (from the end and beyond it), out of
    range and SEG_NONE."""
    seg = rng.integers(-2 * cap - 1, 2 * cap + 2, b).astype(np.int32)
    seg[rng.random(b) < 0.1] = jm.SEG_NONE
    return seg


@pytest.mark.parametrize("cap", [1, 8])
@pytest.mark.parametrize("per_row", [False, True], ids=["bucket_mask", "row_mask"])
def test_fleet_form_plain_matches_jax_fleet_step_tail(cap, per_row):
    """The fleet form of the plain version, on the state the JAX fleet
    step leaves, gives the JAX wire's per-segment tail exactly; and the
    port's fleet step gives the JAX wire, tail included."""
    rng = np.random.default_rng(40 + cap)
    b, s, k = 300, 16, 64
    state = jm.example_state(b=b, s=s, r=8, p=4, l=2, c=8, dirty_frac=0.2)
    if per_row:
        state = state._replace(status_mask=rng.random((b, s)) < 0.25)
    state = state._replace(up_exists=rng.random(b) < 0.8)
    seg = _nasty_segments(rng, b, cap)
    packed = jm.pack_deltas(jm.example_deltas(b=b, s=s, d=32))
    acks = np.full(16, -1, np.int32)
    js, jseg, jw = _JAX_FLEET(jax.tree.map(jnp.asarray, state), jnp.asarray(seg),
                              jnp.asarray(packed), jnp.asarray(acks),
                              patch_capacity=k, seg_capacity=cap)
    tail = np.asarray(jw)[-cap:]
    assert tail.sum() > 0

    after = tm.state_from_numpy(jax.tree.map(np.array, js), "cpu")
    out = ck.decide_and_match(*(getattr(after, n) for n in (
        "up_vals", "up_exists", "down_vals", "down_exists", "status_mask",
        "pair_hashes", "sel_hashes")), seg_ids=torch.from_numpy(np.array(jseg)),
        seg_capacity=cap)
    assert len(out) == 4 and out[3].dtype == torch.int32
    np.testing.assert_array_equal(out[3].numpy(), tail)

    _ts, tseg, tw = tm.reconcile_step_fleet(
        tm.state_from_numpy(state, "cpu"), torch.from_numpy(seg.copy()),
        torch.from_numpy(packed.view(np.int32)), torch.from_numpy(acks),
        patch_capacity=k, seg_capacity=cap)
    assert tm.wire_to_numpy(tw).tobytes() == np.asarray(jw).tobytes()
    np.testing.assert_array_equal(tseg.numpy(), np.asarray(jseg))


def test_packed_step_without_seg_ids_is_unchanged():
    """The segment lane is optional: without it the packed wire has no
    tail, and with it the tail is the plain version's count."""
    rng = np.random.default_rng(3)
    b, s = 128, 8
    state = jm.example_state(b=b, s=s, r=4, p=2, l=1, c=4)
    packed = torch.from_numpy(jm.pack_deltas(jm.example_deltas(b=b, s=s, d=16)).view(np.int32))
    _s, plain = tm.reconcile_step_packed(tm.state_from_numpy(state, "cpu"), packed)
    seg = torch.from_numpy(_nasty_segments(rng, b, 4))
    st, fleet = tm.reconcile_step_packed(tm.state_from_numpy(state, "cpu"), packed,
                                         seg_ids=seg, seg_capacity=4)
    assert torch.equal(fleet[:plain.shape[0]], plain)
    assert torch.equal(fleet[plain.shape[0]:],
                       ck.segment_counts_plain(seg, st.up_exists, 4))


def test_wrapper_rejects_a_bad_seg_ids():
    rng = np.random.default_rng(0)
    b = 8
    case = [tm.to_device(a, "cpu") for a in (
        rng.integers(1, 9, (b, 4), dtype=np.uint32), np.ones(b, bool),
        rng.integers(1, 9, (b, 4), dtype=np.uint32), np.ones(b, bool),
        np.zeros(4, bool), np.ones((b, 1), np.uint32), np.ones(2, np.uint32))]
    good = torch.zeros(b, dtype=torch.int32)
    ck._check(*case, seg_ids=good)
    with pytest.raises(TypeError, match="seg_ids"):
        ck._check(*case, seg_ids=good.to(torch.int64))
    with pytest.raises(ValueError, match="seg_ids"):
        ck._check(*case, seg_ids=torch.zeros(b + 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="seg_ids"):
        ck._check(*case, seg_ids=torch.zeros((2, b), dtype=torch.int32)[:, 0])
    with pytest.raises(ValueError, match="seg_ids"):
        ck._check(*case, seg_ids=good.to("meta"))
    with pytest.raises(ValueError, match="seg_capacity"):
        ck.decide_and_match(*case, seg_ids=good)
    with pytest.raises(ValueError, match="seg_capacity"):
        ck.decide_and_match(*case, seg_ids=good, seg_capacity=-1)


# ------------------------------------------------------------ build key


def test_build_key_follows_every_source_and_the_flags(tmp_path, monkeypatch):
    (tmp_path / "decide_match.cu").write_text("// kernel\n")
    monkeypatch.setattr(ck, "_CSRC", str(tmp_path))
    base = ck._source_key()
    assert ck._source_key() == base
    (tmp_path / "common.cuh").write_text("// a header\n")
    with_header = ck._source_key()
    assert with_header != base
    (tmp_path / "common.cuh").write_text("// a changed header\n")
    assert ck._source_key() not in (base, with_header)
    changed = ck._source_key()
    monkeypatch.setattr(ck, "NVCC_FLAGS", ck.NVCC_FLAGS + ("-lineinfo",))
    assert ck._source_key() != changed
