"""The grouped launch of ``decide_and_match`` on the host: the group plan
(``_group_plan``) that one launch over several row shards of a card
walks, its tile order walked in Python through the plain version against
JAX ``decide_and_match_sharded`` in interpret mode, the grouped plain
version, and the shard descriptors against the CUDA source's layout.

The kernel runs only on a card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 3b); the plan it is handed and the order it walks
are decided here. Every comparison is exact: all outputs are integers.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from kcp_tpu.ops.pallas_kernels import decide_and_match_sharded as jax_sharded
from kcp_tpu.parallel import mesh as jmesh
from kcp_tpu_torch.models import reconcile_model as tm
from kcp_tpu_torch.ops import cuda_kernels as ck
from kcp_tpu_torch.parallel import mesh as pmesh

CPU = torch.device("cpu")
SOURCE = os.path.join(os.path.dirname(ck.__file__), "..", "csrc", "decide_match.cu")
# the fleet form at the serving row size: S=64, per-row mask, L=1, C=8, cap 8
FLEET = dict(s=64, l=1, c=8, per_row=True, fleet=True, cap=8, sms=132)


def _plan(sizes, aligned=None, **shape):
    shape = {**FLEET, **shape}
    aligned = [True] * len(sizes) if aligned is None else aligned
    return ck._group_plan(tuple(zip(sizes, aligned)), shape["s"], shape["l"], shape["c"],
                          shape["per_row"], shape["fleet"], shape["cap"], shape["sms"])


def _locate(plan: ck.TilePlan, t: int) -> tuple[int, int]:
    """The kernel's ``locate``: global tile t -> (shard, the shard's tile).
    Tiles below ``bulk_tiles`` are every shard's bulk tiles in shard order,
    the rest every shard's plain-path tiles in shard order."""
    bulk = t < plan.bulk_tiles
    u = t if bulk else t - plan.bulk_tiles
    k = 0
    while k + 1 < len(plan.shards) and u >= (
            plan.shards[k + 1].bulk_first if bulk else plan.shards[k + 1].plain_first):
        k += 1
    sh = plan.shards[k]
    return k, (u - sh.bulk_first if bulk else sh.bulk_tiles + u - sh.plain_first)


def _walk(plan: ck.TilePlan):
    """The kernel's walk: block b takes global tiles b, b + grid, ...
    Yields (tile, shard, its tile, first row, rows, bulk)."""
    for blk in range(plan.grid):
        for t in range(blk, plan.tiles, plan.grid):
            k, lt = _locate(plan, t)
            r0 = lt * plan.tile
            yield t, k, lt, r0, min(plan.tile, plan.shards[k].rows - r0), t < plan.bulk_tiles


def _bounds(b: int, spec: str) -> list[int]:
    rf = pmesh.row_factor(pmesh.mesh_from_spec(spec, devices=[CPU] * 8))
    return [hi - lo for lo, hi in pmesh.row_bounds(b, rf)]


GROUPS = {
    "mesh4": [32768] * 4,
    "mesh8": [16384] * 8,
    "ragged_4": _bounds(131071, "4"),
    "ragged_8": _bounds(131071, "8"),
    "ragged_2x2": _bounds(131071, "2x2"),
    "fewer_rows_than_shards": _bounds(3, "8"),
    "empty_between": [100, 0, 4096, 0, 31],
    "all_empty": [0, 0],
    "sixteen_uneven": [int(x) for x in np.random.default_rng(3).integers(0, 5000, 16)],
    "one": [131072],
}


@pytest.mark.parametrize("misaligned", [None, 0, 1], ids=["aligned", "first_off", "second_off"])
@pytest.mark.parametrize("group", GROUPS, ids=list(GROUPS))
def test_group_plan_covers_every_row_once(group, misaligned):
    sizes = GROUPS[group]
    aligned = [k != misaligned for k in range(len(sizes))]
    plan = _plan(sizes, aligned)
    t = plan.tile
    assert t == 32 and plan.ranges == (8192, 8192, 2048, 32, 32, 128, 128)
    assert [sh.rows for sh in plan.shards] == sizes
    seen = [np.zeros(n, np.int32) for n in sizes]
    for _t, k, lt, r0, n, bulk in _walk(plan):
        assert 0 < n <= t and r0 + n <= sizes[k]  # no tile crosses a shard
        if bulk:  # the ring takes only full tiles of aligned shards
            assert n == t and aligned[k] and lt < plan.shards[k].bulk_tiles
        else:
            assert lt >= plan.shards[k].bulk_tiles
        seen[k][r0:r0 + n] += 1
    assert all((x == 1).all() for x in seen)
    for k, (n, sh) in enumerate(zip(sizes, plan.shards)):
        assert sh.tiles == -(-n // t)
        assert sh.bulk_tiles == (n // t if aligned[k] else 0)
    assert plan.bulk_tiles == sum(sh.bulk_tiles for sh in plan.shards)
    assert plan.tiles == sum(sh.tiles for sh in plan.shards)
    assert plan.tail_rows == sum(sizes) - plan.bulk_tiles * t
    assert plan.bulk == (plan.bulk_tiles > 0) and plan.stages == (2 if plan.bulk else 0)
    assert plan.grid == max(1, min(2 * 132, plan.tiles))
    assert plan.smem <= ck.SMEM_BLOCK_MAX


@pytest.mark.parametrize("group", GROUPS, ids=list(GROUPS))
def test_bulk_tiles_come_first_and_tails_go_plain(group):
    sizes = GROUPS[group]
    plan = _plan(sizes)
    where = [_locate(plan, t) for t in range(plan.tiles)]
    # bulk tiles first, shard by shard, then the plain-path tiles shard by shard
    bulk, plain = where[:plan.bulk_tiles], where[plan.bulk_tiles:]
    assert bulk == sorted(bulk) and plain == sorted(plain)
    assert all(lt < plan.shards[k].bulk_tiles for k, lt in bulk)
    assert all(lt >= plan.shards[k].bulk_tiles for k, lt in plain)
    # each shard's partial tail, and only it, takes the plain path
    tails = [(k, n // plan.tile) for k, n in enumerate(sizes) if n % plan.tile]
    assert plain == tails
    assert sorted(set(where)) == sorted(where)  # every tile once


def test_a_misaligned_shard_goes_plain_while_its_neighbours_stay_bulk():
    plan = _plan([32768] * 4, [True, False, True, True])
    assert [sh.bulk_tiles for sh in plan.shards] == [1024, 0, 1024, 1024]
    assert plan.bulk and plan.stages == 2
    assert plan.bulk_tiles == 3072 and plan.tiles == 4096 and plan.tail_rows == 32768
    plain = {k for t, k, _lt, _r0, _n, bulk in _walk(plan) if not bulk}
    assert plain == {1}
    # no shard aligned: nothing is bulk-copied and no ring is kept
    none = _plan([32768] * 4, [False] * 4)
    assert not none.bulk and none.stages == 0 and none.smem < plan.smem


def test_one_launch_over_the_group_matches_the_unsharded_plan():
    """Mesh 4's group walks the unsharded call's 4,096 tiles on the same
    grid: the old per-shard launches had 1,024 tiles each."""
    one = _plan([131072])
    group = _plan(GROUPS["mesh4"])
    assert (group.tile, group.stages, group.grid, group.smem) == (
        one.tile, one.stages, one.grid, one.smem)
    assert group.tiles == group.bulk_tiles == one.tiles == 4096


def test_plan_is_cached_on_the_group_shape():
    ck._group_plan.cache_clear()
    a = _plan([1000, 2000])
    assert _plan([1000, 2000]) is a
    assert ck._group_plan.cache_info().hits == 1
    assert _plan([1000, 2000], [True, False]) is not a


# ------------------------------------------- the walk against JAX sharded


def _case(rng, b, s=16, l=2, c=16, per_row=True):
    up = rng.integers(1, 2**32, (b, s), dtype=np.uint32)
    down = up.copy()
    down[rng.random(b) < 0.2, rng.integers(0, s)] ^= 7
    upe = rng.random(b) < 0.9
    dne = rng.random(b) < 0.9
    mask = rng.random((b, s) if per_row else s) < 0.4
    pair = rng.integers(1, 24, (b, l), dtype=np.uint32)
    sel = rng.integers(1, 24, c, dtype=np.uint32)
    return [up, upe, down, dne, mask, pair, sel]


def _grouped_walk(shards, plan, seg_capacity=None):
    """The grouped launch in Python: every block's tiles in the kernel's
    order, each tile through ``decide_and_match_plain``, each shard's
    lanes written at its rows, every tile's counts summed."""
    fleet = seg_capacity is not None
    c = shards[0][6].shape[0]
    decisions = [torch.zeros(a[0].shape[0], dtype=torch.uint8) for a in shards]
    upsyncs = [torch.zeros(a[0].shape[0], dtype=torch.bool) for a in shards]
    counts = torch.zeros(c, dtype=torch.int32)
    seg_counts = torch.zeros(seg_capacity or 0, dtype=torch.int32)
    for _t, k, _lt, r0, n, _bulk in _walk(plan):
        up, upe, down, dne, mask, pair, sel = shards[k][:7]
        rows = slice(r0, r0 + n)
        out = ck.decide_and_match_plain(
            up[rows], upe[rows], down[rows], dne[rows],
            mask[rows] if mask.ndim == 2 else mask, pair[rows], sel,
            shards[k][7][rows] if fleet else None, seg_capacity)
        decisions[k][rows] = out[0]
        upsyncs[k][rows] = out[1]
        counts += out[2]
        if fleet:
            seg_counts += out[3]
    return decisions, upsyncs, counts, seg_counts


def _shards(case, mesh, fleet=False):
    layouts = [pmesh.ROWS, pmesh.FLAGS, pmesh.ROWS, pmesh.FLAGS,
               pmesh.ROWS if case[4].ndim == 2 else pmesh.SLOT_MASK,
               pmesh.FLAGS, pmesh.REPLICATED] + [pmesh.FLAGS] * fleet
    args = [pmesh.ShardedTensor.put(tm.to_device(x, CPU), mesh, lay)
            for x, lay in zip(case, layouts)]
    return [tuple(a.row_block(i) for a in args) for i in mesh.local_rows]


def _group_plan_of(shards, s, l, c, per_row, fleet=False, cap=0, misaligned=None):
    return ck._group_plan(tuple((a[0].shape[0], k != misaligned) for k, a in enumerate(shards)),
                          s, l, c, per_row, fleet, cap, 132)


@pytest.mark.parametrize("misaligned", [None, 1], ids=["aligned", "second_off"])
@pytest.mark.parametrize("per_row", [True, False], ids=["row_mask", "bucket_mask"])
@pytest.mark.parametrize("b", [3000, 4096])
@pytest.mark.parametrize("spec", ["8", "4x2", "2x2x2"])
def test_grouped_walk_matches_jax_sharded_kernel(spec, b, per_row, misaligned):
    """The plan's tile order walked through the plain version, counts
    summed over the group == JAX decide_and_match_sharded (Pallas in
    interpret mode under shard_map, counts psummed) == the unsharded
    plain lanes."""
    rng = np.random.default_rng(b + len(spec))
    case = _case(rng, b, per_row=per_row)
    jm_ = jmesh.mesh_from_spec(spec)
    row = (jmesh.HOSTS_AXIS, jmesh.TENANTS_AXIS) if jmesh.HOSTS_AXIS in jm_.axis_names \
        else jmesh.TENANTS_AXIS
    specs = (P(row, jmesh.SLOTS_AXIS), P(row), P(row, jmesh.SLOTS_AXIS), P(row),
             P(row, jmesh.SLOTS_AXIS) if per_row else P(), P(row, None), P())
    jargs = [jax.device_put(x, NamedSharding(jm_, sp)) for x, sp in zip(case, specs)]
    jdec, jups, jcounts = jax_sharded(jm_, *jargs, interpret=True)

    shards = _shards(case, pmesh.mesh_from_spec(spec, devices=[CPU] * 8))
    plan = _group_plan_of(shards, 16, 2, 16, per_row, misaligned=misaligned)
    assert plan.tail_rows > 0 and plan.bulk  # both paths of the kernel walked
    dec, ups, counts, _ = _grouped_walk(shards, plan)
    np.testing.assert_array_equal(torch.cat(dec).numpy(), np.asarray(jdec))
    np.testing.assert_array_equal(torch.cat(ups).numpy(), np.asarray(jups))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    whole = ck.decide_and_match_plain(*(tm.to_device(x, CPU) for x in case))
    assert torch.equal(torch.cat(dec), whole[0]) and torch.equal(counts, whole[2])
    assert int(counts.sum()) > 0 and int(whole[0].ne(0).sum()) > 0


def _segments(rng, b, cap):
    seg = rng.integers(-2 * cap - 1, 2 * cap + 2, b).astype(np.int32)
    seg[rng.random(b) < 0.1] = 0xFFFF
    return seg


@pytest.mark.parametrize("b", [4093, 1027, 5])
@pytest.mark.parametrize("spec", ["8", "2x2", "4"])
def test_grouped_walk_fleet_form_sums_the_group(spec, b):
    """The fleet form over uneven and nearly empty groups: the walk, the
    grouped plain version and the unsharded plain version agree, counts
    and per-segment counts summed over the shards."""
    rng = np.random.default_rng(b)
    case = _case(rng, b, s=8, l=1, c=8) + [_segments(rng, b, 8)]
    shards = _shards(case, pmesh.mesh_from_spec(spec, devices=[CPU] * 8), fleet=True)
    plan = _group_plan_of(shards, 8, 1, 8, True, fleet=True, cap=8)
    walked = _grouped_walk(shards, plan, seg_capacity=8)
    grouped = ck.decide_and_match_group_plain(shards, seg_capacity=8)
    whole = ck.decide_and_match_plain(*(tm.to_device(x, CPU) for x in case[:7]),
                                      seg_ids=torch.from_numpy(case[7]), seg_capacity=8)
    for got in (walked, grouped):
        assert torch.equal(torch.cat(got[0]), whole[0])
        assert torch.equal(torch.cat(got[1]), whole[1])
        assert torch.equal(got[2], whole[2]) and torch.equal(got[3], whole[3])


def test_group_plain_three_output_form_has_no_segment_counts():
    rng = np.random.default_rng(1)
    shards = _shards(_case(rng, 100), pmesh.mesh_from_spec("4", devices=[CPU] * 4))
    decs, ups, counts, seg = ck.decide_and_match_group_plain(shards)
    assert seg is None and len(decs) == len(ups) == 4
    assert counts.dtype == torch.int32 and counts.shape == (16,)


def test_shards_core_groups_cpu_shards_as_the_plain_version():
    """decide_and_match_shards on CPU shards: the grouped plain version's
    lanes per shard and counts on the lead; launches no kernel."""
    rng = np.random.default_rng(2)
    case = _case(rng, 999, s=8, l=1, c=8) + [_segments(rng, 999, 4)]
    shards = _shards(case, pmesh.mesh_from_spec("8", devices=[CPU] * 8), fleet=True)
    before = ck.decide_and_match_sharded.launches
    decs, ups, counts, seg = ck.decide_and_match_shards(shards, CPU, seg_capacity=4)
    want = ck.decide_and_match_group_plain(shards, seg_capacity=4)
    assert ck.decide_and_match_sharded.launches == before
    assert all(torch.equal(a, b) for a, b in zip(decs, want[0]))
    assert all(torch.equal(a, b) for a, b in zip(ups, want[1]))
    assert torch.equal(counts, want[2]) and torch.equal(seg, want[3])


# ------------------------------------------------- the launch's parameters


def _source() -> str:
    with open(SOURCE) as f:
        return f.read()


def test_descriptor_words_follow_the_cuda_struct():
    """``_descriptors`` writes each shard's words in ``KcpShardDesc``'s
    field order, and the shard limits agree."""
    body = re.search(r"struct KcpShardDesc \{(.*?)\};", _source(), re.S).group(1)
    fields = re.findall(r"(\w+);", body)
    assert len(fields) == 11
    assert int(re.search(r"kMaxShards = (\d+);", _source()).group(1)) == ck.MAX_SHARDS

    rng = np.random.default_rng(4)
    case = _case(rng, 200, s=8, l=1, c=8) + [_segments(rng, 200, 4)]
    shards = _shards(case, pmesh.mesh_from_spec("4", devices=[CPU] * 4), fleet=True)
    plan = _group_plan_of(shards, 8, 1, 8, True, fleet=True, cap=4)
    sizes = [a[0].shape[0] for a in shards]
    decs = list(torch.empty(sum(sizes), dtype=torch.uint8).split(sizes))
    ups = list(torch.empty(sum(sizes), dtype=torch.bool).split(sizes))
    ptrs = [(a[0].data_ptr(), a[2].data_ptr(), a[4].data_ptr(), a[1].data_ptr(),
             a[3].data_ptr(), a[5].data_ptr(), a[7].data_ptr()) for a in shards]
    words = ck._descriptors(ptrs, plan, decs, ups)
    assert len(words) == len(fields) * len(shards)
    for k, a in enumerate(shards):
        want = dict(up=a[0], down=a[2], up_exists=a[1], down_exists=a[3], mask=a[4],
                    pair=a[5], seg=a[7], decision=decs[k], upsync=ups[k])
        got = dict(zip(fields, words[k * len(fields):(k + 1) * len(fields)]))
        assert {f: got[f] for f in want} == {f: t.data_ptr() for f, t in want.items()}
        assert got["rows"] == sizes[k] == plan.shards[k].rows
        assert got["bulk_tiles"] == plan.shards[k].bulk_tiles


def test_kernel_takes_the_group_table_as_a_grid_constant():
    """The table is indexed with a runtime shard number: passed by value
    it would be copied to local memory."""
    assert "decide_match_kernel(const __grid_constant__ Params p)" in _source()


def test_launch_refuses_a_group_it_cannot_take():
    rng = np.random.default_rng(5)
    one = tuple(tm.to_device(x, CPU) for x in _case(rng, 16, s=8, l=1, c=8))
    counts = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="shards in one launch"):
        ck._launch([], counts)
    with pytest.raises(ValueError, match="shards in one launch"):
        ck._launch([one] * (ck.MAX_SHARDS + 1), counts)
    wide = tuple(tm.to_device(x, CPU) for x in _case(rng, 16, s=16, l=1, c=8))
    with pytest.raises(ValueError, match="differ"):
        ck._launch([one, wide], counts)
    with pytest.raises(ValueError, match="inputs"):
        ck._launch([one], counts, torch.zeros(4, dtype=torch.int32))
