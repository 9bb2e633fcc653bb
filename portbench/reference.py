"""The plain reference of a cell's run, in NumPy, and the comparison that
decides ``correct``. It imports nothing of the program and takes nothing the
program made.

From the seed it makes the traffic's inputs again (every row's first values
and exists flags, each churn's edits, creates and deletes) and replays the
owner's journal: a churn changes the owner's mirrors, an applied patch
writes them as a syncer would (``owner.apply_patches``), and an encode hands
the keys' current values and flags to the reference's own copy of the core's
state. An encode is one tick of the core, so after each one the reference
decides every row again, as kcp's syncer does (upstream without downstream:
CREATE; downstream without upstream: DELETE; both, and a spec slot differs:
UPDATE; both, and a status slot differs: an upsync), lists the actionable
rows, all of which that tick's wire must carry, and counts the live rows
(those that exist upstream), which that tick's per-segment count must equal.
Those are the patches the owner must then be handed, tick after tick; ticks
that find nothing to do route nothing. (A tick whose patches overflow the
wire makes the core tick again without an encode, which shows as patches and
counts the reference did not expect.)

The core stages only the side of a row that an event touched, where the
reference takes both sides of every encoded key. The two agree because the
other side of such a key already holds the value the owner hands out: a row
is churned again only long after its patch and echo settled
(``traffic.py``), each change is an event of the side it changed, and its
patch comes only after the change reached the device.

``status=False`` gives the control: a core that leaves out the status lane,
deciding over the spec slots alone and never raising an upsync. It breaks a
guarantee the configurations state, that every decision covers all the
slots: a differing status slot raises an upsync in the same tick."""

from __future__ import annotations

import numpy as np

from .owner import APPLY, CHURN, COUNTS, CREATE, DELETE, ENCODE, NOOP, UPDATE, Journal, \
    apply_patches
from .traffic import ChurnTraffic, apply_churn


def decide(up, up_ex, down, down_ex, mask, status_lane: bool = True):
    """(code int8 [n], upsync bool [n]) of n rows; ``mask`` bool [S] marks
    the status slots."""
    neq = up != down
    spec = (neq & ~mask).any(axis=1)
    status = (neq & mask).any(axis=1) & status_lane
    both = up_ex & down_ex
    code = np.where(both & spec, UPDATE, NOOP)
    code = np.where(~up_ex & down_ex, DELETE, code)
    code = np.where(up_ex & ~down_ex, CREATE, code)
    return code.astype(np.int8), both & status


def entry_ids(keys, code, ups) -> np.ndarray:
    """One sortable int64 per patch (key, code, upsync)."""
    return np.sort(keys.astype(np.int64) * 8 + code.astype(np.int64) * 2
                   + ups.astype(np.int64))


def replay(journal: Journal, traffic: ChurnTraffic, status: bool = True) -> dict:
    """The expected patch sets of the run's ticks that have any, the patch
    sets applied, the live count of every tick and the counts published,
    and the owner's mirrors at the end."""
    s = traffic.slots
    spec = s - traffic.status_slots
    mask = np.zeros(s, bool)
    mask[spec:] = True
    own_up, own_up_ex = traffic.initial()
    own_down, own_down_ex = own_up.copy(), own_up_ex.copy()
    ref_up, ref_down = own_up.copy(), own_up.copy()
    ref_up_ex, ref_down_ex = own_up_ex.copy(), own_up_ex.copy()
    live = int(ref_up_ex.sum())
    schedule = traffic.schedule()
    pending: dict[int, tuple[int, bool]] = {}  # actionable key -> (code, upsync)
    expected, applied, live_counts, counts = [], [], [], []
    for kind, rows, code, ups in journal.entries():
        if kind == CHURN:
            apply_churn(schedule.next(), own_up, own_up_ex, own_down)
        elif kind == APPLY:
            apply_patches(rows, code, ups, spec, own_up, own_up_ex, own_down, own_down_ex)
            applied.append(entry_ids(rows, code, ups))
        elif kind == COUNTS:
            counts.append(int(rows[0]))
        elif kind == ENCODE:
            live -= int(ref_up_ex[rows].sum())
            ref_up[rows], ref_up_ex[rows] = own_up[rows], own_up_ex[rows]
            ref_down[rows], ref_down_ex[rows] = own_down[rows], own_down_ex[rows]
            live += int(ref_up_ex[rows].sum())
            live_counts.append(live)
            c, u = decide(ref_up[rows], ref_up_ex[rows], ref_down[rows], ref_down_ex[rows],
                          mask, status)
            act = (c != NOOP) | u
            for key, cc, uu, a in zip(rows.tolist(), c.tolist(), u.tolist(),
                                      act.tolist()):
                if a:
                    pending[key] = (cc, uu)
                else:
                    pending.pop(key, None)
            keys = np.fromiter(pending, np.int64, len(pending))
            got = np.array(list(pending.values()), np.int64).reshape(-1, 2)
            tick = entry_ids(keys, got[:, 0], got[:, 1])
            if tick.shape[0]:
                expected.append(tick)
    return {"expected": expected, "applied": applied, "live_counts": live_counts,
            "counts": counts, "own_up": own_up, "own_up_ex": own_up_ex,
            "own_down": own_down, "own_down_ex": own_down_ex}


def mismatches(expected: list, applied: list) -> int:
    """Patches in one list and not the other, tick set by tick set in
    order; every patch of a set without a partner counts."""
    n = sum(np.setxor1d(e, a, assume_unique=True).shape[0]
            for e, a in zip(expected, applied))
    rest = expected[len(applied):] + applied[len(expected):]
    return n + sum(r.shape[0] for r in rest)


def judge(journal: Journal, traffic: ChurnTraffic, control: bool = False) -> dict:
    """The numbers compared, each to be 0: ``{name: value}``. With
    ``control`` the control's patch sets stand in the program's place."""
    r = replay(journal, traffic)
    served = replay(journal, traffic, status=False)["expected"] if control else r["applied"]
    want, got = r["live_counts"], r["counts"]
    unconverged = ((r["own_up_ex"] != r["own_down_ex"])
                   | (r["own_up_ex"] & (r["own_up"] != r["own_down"]).any(axis=1)))
    return {
        "patch_mismatches": mismatches(r["expected"], served),
        "count_mismatches": sum(a != b for a, b in zip(want, got)) + abs(len(want) - len(got)),
        "unconverged_rows": int(unconverged.sum()),
    }
