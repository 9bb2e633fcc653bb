"""The port's device ops against the JAX package's, on the CPU.

Same inputs (numpy, from seeds or the reference's own encoders) go
through ``kcp_tpu.ops.*`` and ``kcp_tpu_torch.ops.*``. Every output is an
integer or a flag, so every comparison is exact equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kcp_tpu.ops import diff as jdiff
from kcp_tpu.ops import labelmatch as jlm
from kcp_tpu.ops import placement as jpl
from kcp_tpu.ops.encode import BucketEncoder, encode_label_batch
from kcp_tpu.ops.hashing import hash_pair
from kcp_tpu.store.selectors import parse_selector
from kcp_tpu_torch.ops import diff as tdiff
from kcp_tpu_torch.ops import labelmatch as tlm
from kcp_tpu_torch.ops import placement as tpl
from kcp_tpu_torch.ops.encode import pad_pow2


def t(a) -> torch.Tensor:
    """A numpy array as a CPU tensor (uint32 as an int32 bit view)."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def same(torch_out, jax_out) -> None:
    want = np.asarray(jax_out)
    if want.dtype == np.uint32:
        want = want.view(np.int32)
    np.testing.assert_array_equal(torch_out.numpy(), want)


# ------------------------------------------------------------------ diff


def obj(name, data, status=None):
    o = {"apiVersion": "v1", "kind": "ConfigMap",
         "metadata": {"name": name, "namespace": "d", "resourceVersion": "9"},
         "data": data}
    if status is not None:
        o["status"] = status
    return o


def run_both(pairs):
    enc = BucketEncoder(capacity=64)
    up = enc.encode_batch([p[0] for p in pairs])
    down = enc.encode_batch([p[1] for p in pairs])
    mask = enc.status_mask()
    ref = jdiff.sync_decisions_jit(up.values, up.exists, down.values,
                                   down.exists, mask)
    got = tdiff.sync_decisions(t(up.values), t(up.exists), t(down.values),
                               t(down.exists), t(mask))
    same(got.decision, ref.decision)
    same(got.status_upsync, ref.status_upsync)
    same(got.changed_slots, ref.changed_slots)
    return got.decision.tolist(), got.status_upsync.tolist()


def test_decision_matrix():
    decisions, upsync = run_both([
        (obj("a", {"k": "v"}), obj("a", {"k": "v"})),
        (obj("b", {"k": "v"}), None),
        (None, obj("c", {"k": "v"})),
        (obj("d", {"k": "NEW"}), obj("d", {"k": "old"})),
        (None, None),
    ])
    assert decisions == [tdiff.DECISION_NOOP, tdiff.DECISION_CREATE,
                         tdiff.DECISION_DELETE, tdiff.DECISION_UPDATE,
                         tdiff.DECISION_NOOP]
    assert not any(upsync)


def test_status_lane_independent_of_spec_lane():
    decisions, upsync = run_both([
        (obj("a", {"k": "v"}), obj("a", {"k": "v"}, status={"ready": True})),
        (obj("b", {"k": "1"}, status={"n": 1}), obj("b", {"k": "2"}, status={"n": 2})),
        (obj("c", {}, status={"n": 1}), None),
    ])
    assert decisions == [tdiff.DECISION_NOOP, tdiff.DECISION_UPDATE,
                         tdiff.DECISION_CREATE]
    assert upsync == [True, True, False]


def test_volatile_metadata_does_not_dirty():
    a = obj("a", {"k": "v"})
    b = obj("a", {"k": "v"})
    b["metadata"]["resourceVersion"] = "9999"
    b["metadata"]["uid"] = "different"
    decisions, _ = run_both([(a, b)])
    assert decisions == [tdiff.DECISION_NOOP]


def test_apply_deltas_scatter_and_padding():
    enc = BucketEncoder(capacity=32)
    base = enc.encode_batch([obj("a", {"v": "0"}), obj("b", {"v": "0"}), None], pad_to=4)
    delta = enc.encode_batch([obj("b", {"v": "1"}), obj("c", {"v": "2"})], pad_to=4)
    idx = np.array([1, 2, 0, 0], dtype=np.int32)
    new_exists = np.array([True, True, False, False])
    valid = np.array([True, True, False, False])
    ref_vals, ref_exists = jdiff.apply_deltas_jit(
        base.values, base.exists, idx, delta.values, new_exists, valid)
    vals, exists = t(base.values), t(base.exists)
    tdiff.apply_deltas(vals, exists, t(idx), t(delta.values), t(new_exists), t(valid))
    same(vals, ref_vals)
    same(exists, ref_exists)
    assert exists.tolist() == [True, True, True, False]


def test_delete_via_delta():
    enc = BucketEncoder(capacity=32)
    base = enc.encode_batch([obj("a", {"v": "0"})], pad_to=2)
    vals, exists = t(base.values), t(base.exists)
    tdiff.apply_deltas(vals, exists, t(np.array([0, 0], np.int32)),
                       t(np.zeros_like(base.values)), t(np.array([False, False])),
                       t(np.array([True, False])))
    assert not exists[0]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_apply_deltas_drop_mode_fuzz(seed):
    """Drop-mode scatter semantics: padding interleaved with real rows,
    out-of-range and negative indices (JAX normalizes negatives), a
    padding entry aimed at a row a valid entry also writes."""
    rng = np.random.default_rng(seed)
    b, s, d = 64, 8, 48
    vals = rng.integers(0, 2**32, (b, s), dtype=np.uint32)
    exists = rng.random(b) < 0.5
    idx = rng.permutation(b)[:d].astype(np.int32)
    valid = rng.random(d) < 0.6
    # padding rows point at rows valid entries write, and some rows go
    # out of range either way
    idx[~valid] = rng.choice(idx[valid], size=int((~valid).sum()))
    idx[:3] = [b + 5, -1, -b - 2]
    new = rng.integers(0, 2**32, (d, s), dtype=np.uint32)
    new_e = rng.random(d) < 0.5
    rv, re = jdiff.apply_deltas_jit(vals, exists, idx, new, new_e, valid)
    tv, te = t(vals), t(exists)
    tdiff.apply_deltas(tv, te, t(idx), t(new), t(new_e), t(valid))
    same(tv, rv)
    same(te, re)


def test_compact_patches_extracts_actionable_rows():
    decision = np.array([0, 1, 0, 2, 3, 0, 0, 0], np.uint8)
    upsync = np.array([False, False, True, False, False, False, True, False])
    ref = jax.jit(jdiff.compact_patches, static_argnames=("capacity",))(
        decision, upsync, capacity=16)
    p = tdiff.compact_patches(t(decision), t(upsync), 16)
    for name in tdiff.PatchSet._fields:
        same(getattr(p, name), getattr(ref, name))
    assert int(p.count) == 5 and not bool(p.overflow)
    assert p.idx[:5].tolist() == [1, 2, 3, 4, 6]
    assert (p.idx[5:] == 8).all()


@pytest.mark.parametrize("capacity", [4, 31, 32, 64])
def test_compact_patches_capacity_edges(capacity):
    rng = np.random.default_rng(capacity)
    decision = rng.integers(0, 4, 32).astype(np.uint8)
    decision[rng.random(32) < 0.3] = 0
    upsync = rng.random(32) < 0.2
    ref = jax.jit(jdiff.compact_patches, static_argnames=("capacity",))(
        decision, upsync, capacity=capacity)
    p = tdiff.compact_patches(t(decision), t(upsync), capacity)
    for name in tdiff.PatchSet._fields:
        same(getattr(p, name), getattr(ref, name))


def test_compact_patches_overflow():
    p = tdiff.compact_patches(t(np.full(32, 2, np.uint8)), t(np.zeros(32, bool)), 4)
    assert int(p.count) == 4 and bool(p.overflow)
    assert p.idx.tolist() == [0, 1, 2, 3]


def test_pad_pow2():
    for n in (0, 1, 7, 8, 9, 63, 64, 65, 1000):
        from kcp_tpu.ops.encode import pad_pow2 as ref

        assert pad_pow2(n) == ref(n) and pad_pow2(n, floor=64) == ref(n, floor=64)


# ------------------------------------------------------------ labelmatch

SELECTORS = [
    "app=web", "app!=web", "env in (prod,staging)", "env notin (prod)",
    "app", "!app", "app=web,env in (prod,dev),!legacy,tier",
    "kcp.dev/cluster=us-east1", "",
]


def random_labels(rng):
    keys = ["app", "env", "tier", "legacy", "kcp.dev/cluster"]
    vals = {"app": ["web", "db"], "env": ["prod", "staging", "dev"], "tier": ["1", "2"],
            "legacy": ["true"], "kcp.dev/cluster": ["us-east1", "us-west1"]}
    labels = {}
    for k in keys:
        if rng.random() < 0.5:
            labels[k] = vals[k][rng.integers(len(vals[k]))]
    return labels or None


@pytest.mark.parametrize("spec", SELECTORS)
def test_match_batch_vs_jax_and_host(spec):
    rng = np.random.default_rng(7)
    label_maps = [random_labels(rng) for _ in range(256)]
    pairs, keys = encode_label_batch(label_maps, capacity=8)
    sel = parse_selector(spec)
    c = jlm.compile_selector(sel)
    ref = jlm.match_batch_jit(pairs, keys, c.alts, c.negate, c.use_key, c.valid)
    got = tlm.match_batch(t(pairs), t(keys), t(c.alts), t(c.negate),
                          t(c.use_key), t(c.valid))
    same(got, ref)
    np.testing.assert_array_equal(got.numpy(), jlm.match_host(sel, label_maps))


def test_fanout_match():
    clusters = [f"c{i}" for i in range(16)]
    rng = np.random.default_rng(3)
    label_maps, owner = [], []
    for _ in range(512):
        if rng.random() < 0.9:
            c = clusters[rng.integers(len(clusters))]
            label_maps.append({"kcp.dev/cluster": c, "x": "y"})
            owner.append(c)
        else:
            label_maps.append({"x": "y"})
            owner.append(None)
    pairs, _ = encode_label_batch(label_maps, capacity=4)
    sel_hashes = np.array([hash_pair("kcp.dev/cluster", c) for c in clusters],
                          dtype=np.uint32)
    got = tlm.fanout_match(t(pairs), t(sel_hashes))
    same(got, jlm.fanout_match_jit(pairs, sel_hashes))
    assert got.shape == (512, 16)
    for i, c in enumerate(owner):
        row = got[i]
        if c is None:
            assert not row.any()
        else:
            assert int(row.sum()) == 1 and row[clusters.index(c)]


# ------------------------------------------------------------- placement


def oracle_split(replicas, avail, balanced=False):
    idxs = [i for i, a in enumerate(avail) if a]
    out = [0] * len(avail)
    if not idxs:
        return out
    base, rem = divmod(replicas, len(idxs))
    for rank, i in enumerate(idxs):
        out[i] = base + ((1 if rank < rem else 0) if balanced
                         else (rem if rank == 0 else 0))
    return out


@pytest.mark.parametrize("balanced", [False, True])
def test_split_matches_oracle_and_jax_exhaustive_small(balanced):
    cases = [(r, [(m >> i) & 1 == 1 for i in range(4)])
             for r in range(12) for m in range(16)]
    reps = np.array([c[0] for c in cases], dtype=np.int32)
    avail = np.array([c[1] for c in cases], dtype=bool)
    got = tpl.split_replicas(t(reps), t(avail), balanced=balanced)
    same(got, jpl.split_replicas_jit(reps, avail, balanced=balanced))
    want = np.array([oracle_split(r, a, balanced) for r, a in cases], dtype=np.int32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_split_conservation_at_scale():
    rng = np.random.default_rng(0)
    reps = rng.integers(0, 1000, size=4096).astype(np.int32)
    avail = rng.random((4096, 8)) < 0.8
    for balanced in (False, True):
        got = tpl.split_replicas(t(reps), t(avail), balanced=balanced).numpy()
        same(torch.from_numpy(got), jpl.split_replicas_jit(reps, avail, balanced=balanced))
        n = avail.sum(-1)
        np.testing.assert_array_equal(got.sum(-1)[n > 0], reps[n > 0])
        assert (got[~avail] == 0).all()


def test_split_replicas_weighted_matches_jax():
    rng = np.random.default_rng(4)
    b, p = 512, 8
    reps = rng.integers(0, 65536, b).astype(np.int32)
    weights = rng.integers(1, 32768, (b, p)).astype(np.int32)
    sel = rng.random((b, p)) < 0.6
    rank = np.argsort(np.argsort(-np.where(sel, weights, -1), axis=1), axis=1).astype(np.int32)
    got = tpl.split_replicas_weighted(t(reps), t(weights), t(sel), t(rank))
    same(got, jpl.split_replicas_weighted_jit(reps, weights, sel, rank))


def test_aggregate_status_and_placement_changed():
    leaf = np.array([[[1, 1, 0], [2, 0, 2], [9, 9, 9]],
                     [[5, 4, 3], [0, 0, 0], [1, 1, 1]]], dtype=np.int32)
    mask = np.array([[True, True, False], [True, False, True]])
    got = tpl.aggregate_status(t(leaf), t(mask))
    same(got, jpl.aggregate_status_jit(leaf, mask))
    assert got.tolist() == [[3, 1, 2], [6, 5, 4]]
    cur = np.array([[1, 2], [3, 3]], dtype=np.int32)
    des = np.array([[1, 2], [4, 2]], dtype=np.int32)
    got = tpl.placement_changed(t(cur), t(des))
    same(got, jpl.placement_changed(jnp.asarray(cur), jnp.asarray(des)))
    assert got.tolist() == [False, True]
