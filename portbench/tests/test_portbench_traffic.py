"""The one traffic generator: O(churn) draws from the seed, of the changes a
syncer sees."""

import numpy as np
import pytest

from portbench.traffic import MIN_TICKS_BETWEEN_CHURNS, ChurnTraffic, apply_churn

PARAMS = {"ops_per_tick": {"spec_one_slot": 24, "spec_few_slots": 16, "status": 16,
                           "create_or_delete": 8},
          "few_slots": 4, "status_edit_slots": 2, "warmup_ticks": 24}
ROWS, OBJECTS, SLOTS, STATUS = 1 << 14, 12_500, 16, 4


def _traffic(seed, rows=ROWS, objects=OBJECTS, params=PARAMS):
    return ChurnTraffic(rows, objects, SLOTS, STATUS, params, seed)


def _keys(ch):
    return np.concatenate([ch.up_keys, ch.down_keys])


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3, 2**40 + 1])
def test_no_row_twice_in_a_tick_and_the_same_churns_for_the_same_seed(seed):
    a, b = _traffic(seed), _traffic(seed)
    assert all(np.array_equal(x, y) for x, y in zip(a.initial(), b.initial()))
    sa, sb = a.schedule(), b.schedule()
    for _ in range(300):
        ca, cb = sa.next(), sb.next()
        keys = _keys(ca)
        assert keys.shape == (64,) and np.unique(keys).shape == (64,)
        for x, y in zip(ca, cb):
            for u, v in zip(x if isinstance(x, tuple) else (x,), y if isinstance(y, tuple) else (y,)):
                assert np.array_equal(u, v)


def test_other_seeds_draw_other_churns_of_the_same_sizes():
    a, b = _traffic(1).schedule().next(), _traffic(2).schedule().next()
    assert not np.array_equal(_keys(a), _keys(b))
    assert [len(x) if not isinstance(x, tuple) else len(x[0]) for x in a] == \
        [len(x) if not isinstance(x, tuple) else len(x[0]) for x in b]


def test_each_kind_of_change_reaches_the_mirrors_as_drawn():
    t = _traffic(5)
    up, up_ex = t.initial()
    assert up_ex.sum() == OBJECTS
    down, down_ex = up.copy(), up_ex.copy()
    spec = SLOTS - STATUS
    sched = t.schedule()
    for k in range(4):
        before_up, before_ex, before_down = up.copy(), up_ex.copy(), down.copy()
        ch = sched.next()
        apply_churn(ch, up, up_ex, down)
        changed_up = (up != before_up).any(axis=1) | (up_ex != before_ex)
        changed_down = (down != before_down).any(axis=1)
        assert np.array_equal(np.sort(np.flatnonzero(changed_up)), np.sort(ch.up_keys))
        assert np.array_equal(np.sort(np.flatnonzero(changed_down)), np.sort(ch.down_keys))
        edited = ch.up_keys[:40]
        assert before_ex[edited].all() and up_ex[edited].all()
        # one-slot edits change one spec slot; few-slot edits 1..4 spec slots
        n = (up[edited] != before_up[edited]).sum(axis=1)
        assert (n[:24] == 1).all() and ((n[24:] >= 1) & (n[24:] <= 4)).all()
        assert (up[edited][:, spec:] == before_up[edited][:, spec:]).all()
        # status edits change only status slots, downstream
        s = (down[ch.down_keys] != before_down[ch.down_keys])
        assert not s[:, :spec].any() and s[:, spec:].any(axis=1).all()
        if k % 2 == 0:  # creates: absent rows come to exist upstream
            assert ch.created.shape == (8,) and ch.deleted.shape == (0,)
            assert not before_ex[ch.created].any() and up_ex[ch.created].all()
        else:  # deletes: live rows go
            assert ch.deleted.shape == (8,) and ch.created.shape == (0,)
            assert before_ex[ch.deleted].all() and not up_ex[ch.deleted].any()
    # the live count moved and came back
    assert up_ex.sum() == OBJECTS


def test_a_row_returns_only_after_its_ring_has_gone_round():
    t = _traffic(9, rows=1 << 13, objects=6_000)
    sched = t.schedule()
    last, gaps = {}, []
    for k in range(400):
        for r in _keys(sched.next()).tolist():
            if r in last:
                gaps.append(k - last[r])
            last[r] = k
    assert gaps and min(gaps) >= MIN_TICKS_BETWEEN_CHURNS


def test_a_churn_too_large_for_its_rows_is_refused():
    with pytest.raises(ValueError):
        _traffic(0, rows=1024, objects=900)
