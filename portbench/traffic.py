"""The one generator of the closed churn loops: it reads a traffic mix's
parameters (``portbench/traffic/<name>.json``) and draws everything from
``--seed``. The changes are those a syncer sees:

- ``ops_per_tick``: after every tick, how many objects get each kind of
  change:

  - ``spec_one_slot``: one spec slot of the upstream object edited;
  - ``spec_few_slots``: ``few_slots`` spec slots drawn, with repeats, so
    one to ``few_slots`` of them edited upstream;
  - ``status``: ``status_edit_slots`` status slots drawn, with repeats, so
    one or more of them edited on the downstream copy (the physical
    cluster reports status; the syncer must upsync it);
  - ``create_or_delete``: objects created upstream after even churns and
    deleted upstream after odd ones, so the live count, and with it the
    per-segment counts, moves every tick;

- ``warmup_ticks``: ticks run before the measured window opens.

The configuration sizes the rows: ``rows`` keys of the bucket, of which
``objects`` exist at the start (both sides, converged, every slot drawn);
the rest are absent, the pool that deletes return rows to and creates take
them from. An edited slot takes its old value XOR a nonzero draw, so it
always differs.

Live objects wait in one ring and absent rows in another. Each churn takes
its edits and deletes from the head of the live ring and its creates from
the head of the absent ring, then puts edited and created objects at the
live ring's tail and deleted ones at the absent ring's tail: O(churn) a
tick, and every row comes back only after its ring has gone round, which
takes at least ``MIN_TICKS_BETWEEN_CHURNS`` ticks. By then the row's patch
and its echo have long settled, which the reference relies on
(``reference.py``).

Every consumer (the owner, the reference) makes its own
:meth:`ChurnTraffic.schedule`, and both read the same churns from the
seed."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

#: the fewest ticks between two churns of one row (see above)
MIN_TICKS_BETWEEN_CHURNS = 64
OPS = ("spec_one_slot", "spec_few_slots", "status", "create_or_delete")


class Churn(NamedTuple):
    """One churn: the edits as (rows, slots, xor values), one entry a slot
    edited, the rows created with their values, the rows deleted, and the
    keys of the events each side raises."""

    up_edit: tuple  # (rows int64 [e], slots int64 [e], xor uint32 [e])
    down_edit: tuple  # the same, on the downstream copy
    created: np.ndarray  # int64 [c]
    created_vals: np.ndarray  # uint32 [c, S]
    deleted: np.ndarray  # int64 [d]
    up_keys: np.ndarray  # int64: spec edits, creates, deletes
    down_keys: np.ndarray  # int64: status edits


def apply_churn(ch: Churn, up, up_ex, down) -> None:
    """Write a churn into a pair of mirrors, in place."""
    rows, slots, xor = ch.up_edit
    up[rows, slots] ^= xor
    rows, slots, xor = ch.down_edit
    down[rows, slots] ^= xor
    up[ch.created] = ch.created_vals
    up_ex[ch.created] = True
    up_ex[ch.deleted] = False


class ChurnTraffic:
    def __init__(self, rows: int, objects: int, slots: int, status_slots: int,
                 params: dict, seed: int):
        self.rows, self.objects, self.slots = rows, objects, slots
        self.status_slots = status_slots
        ops = params["ops_per_tick"]
        self.ops = {k: int(ops[k]) for k in OPS}
        self.few_slots = int(params["few_slots"])
        self.status_edit_slots = int(params["status_edit_slots"])
        self.warmup_ticks = int(params["warmup_ticks"])
        self.churn = sum(self.ops.values())
        edits = self.churn - self.ops["create_or_delete"]
        cd = self.ops["create_or_delete"]
        gaps = {"live": (objects - cd) // max(edits + cd, 1),
                "absent": (rows - objects - cd) // max(cd, 1)}
        low = {k: v for k, v in gaps.items() if v < MIN_TICKS_BETWEEN_CHURNS}
        if low or not 0 < objects < rows or self.churn <= 0:
            raise ValueError(f"{self.ops} over {objects} of {rows} rows: a row would "
                             f"come back within {low} ticks (at least "
                             f"{MIN_TICKS_BETWEEN_CHURNS})")
        self._init, self._order, self._values = np.random.SeedSequence(
            seed % 2**63).spawn(3)

    def initial(self) -> tuple[np.ndarray, np.ndarray]:
        """uint32 [rows, slots] and bool [rows]: every row's values and
        whether it exists, before the first churn (both sides alike)."""
        rng = np.random.default_rng(self._init)
        vals = rng.integers(0, 2**32, (self.rows, self.slots), dtype=np.uint32)
        exists = np.zeros(self.rows, bool)
        exists[self._rings()[0]] = True
        return vals, exists

    def _rings(self) -> tuple[np.ndarray, np.ndarray]:
        order = np.random.default_rng(self._order).permutation(self.rows)
        return order[:self.objects], order[self.objects:]

    def schedule(self) -> "Schedule":
        return Schedule(self)


class _Ring:
    """A queue of row keys on a buffer of fixed size."""

    def __init__(self, keys: np.ndarray, size: int):
        self.buf = np.zeros(size, np.int64)
        self.buf[:keys.shape[0]] = keys
        self.head, self.tail = 0, keys.shape[0]

    def pop(self, n: int) -> np.ndarray:
        out = self.buf[(self.head + np.arange(n)) % self.buf.shape[0]]
        self.head += n
        return out

    def push(self, keys: np.ndarray) -> None:
        self.buf[(self.tail + np.arange(keys.shape[0])) % self.buf.shape[0]] = keys
        self.tail += keys.shape[0]


class Schedule:
    """The churns of one run, in order, from the seed."""

    def __init__(self, t: ChurnTraffic):
        self.t = t
        live, absent = t._rings()
        self.live, self.absent = _Ring(live, t.rows), _Ring(absent, t.rows)
        self.rng = np.random.default_rng(t._values)
        self.k = 0

    def _edits(self, rows: np.ndarray, draws: int, lo: int, hi: int) -> tuple:
        slots = self.rng.integers(lo, hi, (rows.shape[0], draws))
        xor = self.rng.integers(1, 2**32, slots.shape, dtype=np.uint32)
        return np.repeat(rows, draws), slots.ravel(), xor.ravel()

    def next(self) -> Churn:
        t, ops = self.t, self.t.ops
        create = self.k % 2 == 0
        self.k += 1
        n_one, n_few, n_status = ops["spec_one_slot"], ops["spec_few_slots"], ops["status"]
        edits = n_one + n_few + n_status
        cd = ops["create_or_delete"]
        taken = self.live.pop(edits + (0 if create else cd))
        spec = t.slots - t.status_slots
        one = self._edits(taken[:n_one], 1, 0, spec)
        few = self._edits(taken[n_one:n_one + n_few], t.few_slots, 0, spec)
        status_rows = taken[n_one + n_few:edits]
        down_edit = self._edits(status_rows, t.status_edit_slots, spec, t.slots)
        deleted = taken[edits:]
        created = self.absent.pop(cd) if create else deleted[:0]
        created_vals = self.rng.integers(0, 2**32, (created.shape[0], t.slots),
                                         dtype=np.uint32)
        self.live.push(taken[:edits])
        self.live.push(created)
        self.absent.push(deleted)
        up_edit = tuple(np.concatenate([a, b]) for a, b in zip(one, few))
        return Churn(up_edit=up_edit, down_edit=down_edit, created=created,
                     created_vals=created_vals, deleted=deleted,
                     up_keys=np.concatenate([taken[:n_one + n_few], created, deleted]),
                     down_keys=status_rows)
