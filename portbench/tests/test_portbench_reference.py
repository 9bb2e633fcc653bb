"""The reference agrees with the port at a small size, and the comparison
catches a wrong decision, the control (through the same run and judge as
every run) and each fault of the timed path that these cells can have."""

import time

import numpy as np
import pytest
import torch

from portbench import reference, spec
from portbench.cell import run_cell
from portbench.owner import APPLY, Journal
from portbench.traffic import ChurnTraffic


def test_decide_is_kcp_s_three_way_diff():
    mask = np.array([False, False, True])
    up = np.array([[1, 2, 3], [1, 2, 3], [1, 2, 3], [1, 2, 3], [1, 2, 3]], np.uint32)
    down = np.array([[1, 2, 3], [9, 2, 3], [1, 2, 9], [9, 2, 9], [1, 2, 3]], np.uint32)
    up_ex = np.array([True, True, True, True, False])
    down_ex = np.array([True, True, True, True, True])
    code, ups = reference.decide(up, up_ex, down, down_ex, mask)
    assert code.tolist() == [reference.NOOP, reference.UPDATE, reference.NOOP,
                             reference.UPDATE, reference.DELETE]
    assert ups.tolist() == [False, False, True, True, False]
    code, ups = reference.decide(up[:1], np.array([True]), down[:1], np.array([False]), mask)
    assert code.tolist() == [reference.CREATE] and ups.tolist() == [False]


def _cell(bench_copy):
    return spec.load_cell(bench_copy.add_cell("tiny"), root=bench_copy.root)


def _capture(monkeypatch):
    """Keep the run's journal and traffic for a second look."""
    import portbench.cell as cellmod

    seen = {}
    real_judge = reference.judge

    def judge(journal, traffic, control=False):
        seen.update(journal=journal, traffic=traffic)
        return real_judge(journal, traffic, control)

    monkeypatch.setattr(cellmod.reference, "judge", judge)
    return seen


def test_reference_agrees_and_catches_a_seeded_wrong_decision(bench_copy, monkeypatch):
    seen = _capture(monkeypatch)
    result, _ = run_cell(_cell(bench_copy), 11, 1.5, False, time.perf_counter(), device="cpu")
    assert result["correct"] is True
    journal, traffic = seen["journal"], seen["traffic"]
    assert reference.judge(journal, traffic)["patch_mismatches"] == 0
    applies = [(at, n) for kind, at, n in journal.ops[:journal.n_ops] if kind == APPLY]
    at, n = applies[len(applies) // 2]
    journal.ups[at] = not journal.ups[at]
    assert reference.judge(journal, traffic)["patch_mismatches"] >= 2
    journal.ups[at] = not journal.ups[at]
    journal.code[at] = reference.DELETE if journal.code[at] != reference.DELETE \
        else reference.UPDATE
    assert reference.judge(journal, traffic)["patch_mismatches"] >= 2
    assert reference.judge(journal, traffic, control=True)["patch_mismatches"] > 0


def test_an_empty_journal_replays_to_nothing():
    t = ChurnTraffic(4096, 3000, 8, 1, {
        "ops_per_tick": {"spec_one_slot": 3, "spec_few_slots": 2, "status": 2,
                         "create_or_delete": 1},
        "few_slots": 4, "status_edit_slots": 2, "warmup_ticks": 1}, 1)
    checks = reference.judge(Journal(), t)
    assert checks == {"patch_mismatches": 0, "count_mismatches": 0, "unconverged_rows": 0}


def _state_unchanged(real):
    def step(state, seg_ids, packed, acks=None, **kw):
        packed = torch.zeros_like(packed)  # no entry valid: nothing applied
        acks = None if acks is None else torch.full_like(acks, -1)
        return real(state, seg_ids, packed, acks, **kw)
    return step


def _half_the_batch(real):
    def step(state, seg_ids, packed, acks=None, **kw):
        packed = packed.clone()
        packed[1::2] = 0  # every second entry dropped
        return real(state, seg_ids, packed, acks, **kw)
    return step


def _answer_altered(real):
    from kcp_tpu_torch.models.reconcile_model import PACK_HDR, PACK_UPSYNC_BIT

    def step(*args, **kw):
        state, seg, wire = real(*args, **kw)
        wire = wire.clone()
        if int(wire[0]) > 0:  # flip the first patch's upsync flag
            wire[PACK_HDR] ^= PACK_UPSYNC_BIT
        return state, seg, wire
    return step


def _count_altered(real):
    def step(*args, **kw):
        state, seg, wire = real(*args, **kw)
        wire = wire.clone()
        wire[-kw["seg_capacity"]] += 1  # segment 0's count, first of the tail
        return state, seg, wire
    return step


def _one_slot_compared(real):
    def decide(up, up_ex, down, down_ex, mask):  # slot 0 alone, the rest unread
        return real(up[:, :1], up_ex, down[:, :1], down_ex, mask[..., :1])
    return decide


def _status_mask_ignored(real):
    def decide(up, up_ex, down, down_ex, mask):  # any differing slot: UPDATE and upsync
        d = real(up, up_ex, down, down_ex, torch.zeros_like(mask))
        return d._replace(status_upsync=up_ex & down_ex & (up != down).any(dim=-1))
    return decide


def _counts_of_every_row(real):
    def counts(seg_ids, up_exists, cap):  # every row counted, live or not
        return real(seg_ids, torch.ones_like(up_exists), cap)
    return counts


@pytest.mark.parametrize("target, fault, fails", [
    ("step", _state_unchanged, {"patch_mismatches", "count_mismatches", "unconverged_rows",
                                "lost_changes"}),
    ("step", _half_the_batch, {"patch_mismatches", "unconverged_rows", "lost_changes"}),
    ("step", _answer_altered, {"patch_mismatches"}),
    ("step", _count_altered, {"count_mismatches"}),
    ("decide", _one_slot_compared, {"patch_mismatches", "unconverged_rows", "lost_changes"}),
    ("decide", _status_mask_ignored, {"patch_mismatches"}),
    ("counts", _counts_of_every_row, {"count_mismatches"}),
])
def test_a_broken_timed_path_reads_incorrect(bench_copy, monkeypatch, target, fault, fails):
    import kcp_tpu_torch.ops.cuda_kernels as ck
    import kcp_tpu_torch.syncer.core as core

    module, name = {"step": (core, "reconcile_step_fleet"),
                    "decide": (ck, "sync_decisions"),
                    "counts": (ck, "segment_counts_plain")}[target]
    monkeypatch.setattr(module, name, fault(getattr(module, name)))
    result, lines = run_cell(_cell(bench_copy), 2**31 + 9, 1.5, False, time.perf_counter(),
                             device="cpu")
    assert result["correct"] is False
    # each fault fails at least these; a fault may leave others off too
    assert fails <= {k for k, c in result["checks"].items() if c["value"] > c["limit"]}
