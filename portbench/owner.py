"""The cell's section owner and its journal.

The owner stands where a syncer's engine stands: it holds mirror arrays in
place of informer caches (the upstream objects and their downstream copies,
each with its exists flag), makes the traffic's churns on its schedule, and
applies each patch the core routes to it as a syncer would
(:func:`apply_patches`), echoing each write back as an event of the side it
wrote, as a syncer's write returns through its informer. Everything else
between, the queue, the encode, the fleet batch, the device step with its
kernel, the pipeline and the routing, is the program's.

The journal records, in order, every churn, every encode the core asked for
(the keys, whose values are the owner's mirrors at that instant), every
patch applied and every per-segment count the core published: what the
reference replays after the run. Its arrays, the per-row churn times and
the latencies are allocated ahead and grow by doubling, so the harness makes
no garbage per patch."""

from __future__ import annotations

import time

import numpy as np

from .traffic import ChurnTraffic, apply_churn

CHURN, ENCODE, APPLY, COUNTS = range(4)
LEDGER_KEY = "portbench"
NOOP, CREATE, UPDATE, DELETE = 0, 1, 2, 3


def apply_patches(rows, code, ups, spec: int, up, up_ex, down, down_ex) -> tuple:
    """A syncer's writes for one patch set, in place: CREATE makes the
    downstream copy, UPDATE copies the spec slots (the first ``spec``)
    down, DELETE removes the downstream copy, an upsync copies the status
    slots up. Returns the keys written downstream and upstream."""
    create, update = rows[code == CREATE], rows[code == UPDATE]
    down[create] = up[create]
    down_ex[create] = True
    down[update, :spec] = up[update, :spec]
    down_ex[rows[code == DELETE]] = False
    upsync = rows[ups]
    up[upsync, spec:] = down[upsync, spec:]
    return rows[code != NOOP], upsync


def _grown(a: np.ndarray, need: int) -> np.ndarray:
    if need <= a.shape[0]:
        return a
    out = np.zeros((max(need, 2 * a.shape[0]), *a.shape[1:]), a.dtype)
    out[: a.shape[0]] = a
    return out


class Journal:
    """Ops as (kind, start, length) over one log of rows (keys); an apply's
    codes and upsync flags sit beside its rows, a count op holds one value."""

    def __init__(self, ops: int = 1 << 14, rows: int = 1 << 20):
        self.ops = np.zeros((ops, 3), np.int64)
        self.rows = np.zeros(rows, np.int64)
        self.code = np.zeros(rows, np.int8)
        self.ups = np.zeros(rows, bool)
        self.n_ops = self.n_rows = 0

    def add(self, kind: int, rows: np.ndarray, code=None, ups=None) -> None:
        n, at = rows.shape[0], self.n_rows
        if at + n > self.rows.shape[0]:
            self.rows = _grown(self.rows, at + n)
            self.code = _grown(self.code, at + n)
            self.ups = _grown(self.ups, at + n)
        self.rows[at:at + n] = rows
        if code is not None:
            self.code[at:at + n] = code
            self.ups[at:at + n] = ups
        self.ops = _grown(self.ops, self.n_ops + 1)
        self.ops[self.n_ops] = (kind, at, n)
        self.n_ops += 1
        self.n_rows = at + n

    def entries(self):
        """(kind, rows, codes, upsync flags) per op, in order."""
        for kind, at, n in self.ops[:self.n_ops]:
            sl = slice(at, at + n)
            yield int(kind), self.rows[sl], self.code[sl], self.ups[sl]


class CountLedger:
    """The admission quota ledger's place: the core forwards each collected
    fleet wire's per-segment live-row counts here."""

    def __init__(self, journal: Journal):
        self.journal = journal

    def ingest_device_counts(self, counts: dict) -> None:
        self.journal.add(COUNTS, np.array([counts.get(LEDGER_KEY, -1)], np.int64))


class HarnessOwner:
    """The one section of the cell over ``traffic.rows`` rows."""

    def __init__(self, core, traffic: ChurnTraffic, patch_capacity: int,
                 journal: Journal):
        b, s = traffic.rows, traffic.slots
        self.core, self.traffic, self.journal = core, traffic, journal
        self.spec = s - traffic.status_slots
        self._mask = np.zeros(s, bool)
        self._mask[self.spec:] = True
        self.up, self.up_ex = traffic.initial()
        self.down, self.down_ex = self.up.copy(), self.up_ex.copy()
        self.schedule = traffic.schedule()
        self.encodes = self.changes = 0
        self.t_churn = np.zeros(b)
        self.pending = np.zeros(b, bool)  # churned, its patch not yet applied
        self.change_of = np.zeros(b, np.int64)
        self.lat_s = np.full(1 << 16, np.nan)  # per change: churn to apply
        #: called through ``loop`` after every encode, that is every tick
        self.on_tick = None
        self.loop = None
        self.section = core.register(self, s)
        for key in range(b):
            self.section.row_for(key)
        # the initial list goes up as one full upload of the bucket's
        # mirrors (the way ``bench.py``'s owner fills them); from here on
        # the core reads the owner only through ``fused_encode_many``
        bucket = self.section.bucket
        bucket.up_vals[:b] = self.up
        bucket.down_vals[:b] = self.down
        bucket.up_exists[:b] = self.up_ex
        bucket.down_exists[:b] = self.down_ex
        bucket.mark_stale()
        bucket.patch_capacity = patch_capacity
        # the acks lane's wire shape, pre-warmed as ``bench.py`` does
        floor = max(8192, b // 64, 2 * traffic.churn)
        bucket.ack_capacity = 1 << (floor - 1).bit_length()

    # ---------------------------------------------------- SectionOwner

    def fused_status_mask(self) -> np.ndarray:
        return self._mask

    def fused_ledger_key(self) -> str:
        return LEDGER_KEY

    def fused_encode_many(self, keys):
        idx = np.fromiter(keys, np.int64, len(keys))
        self.journal.add(ENCODE, idx)
        self.encodes += 1
        if self.on_tick is not None:
            self.loop.call_soon(self.on_tick)
        return self.up[idx], self.up_ex[idx], self.down[idx], self.down_ex[idx]

    def fused_apply(self, patches) -> None:
        now = time.perf_counter()
        arr = np.array(patches, dtype=np.int64).reshape(-1, 3)
        rows = arr[:, 0]
        self.journal.add(APPLY, rows, arr[:, 1], arr[:, 2] != 0)
        first = rows[self.pending[rows]]
        if first.shape[0]:
            self.lat_s[self.change_of[first]] = now - self.t_churn[first]
            self.pending[first] = False
        down_keys, up_keys = apply_patches(rows, arr[:, 1], arr[:, 2] != 0, self.spec,
                                           self.up, self.up_ex, self.down, self.down_ex)
        if down_keys.shape[0]:
            self.core.enqueue_many(self.section, True, down_keys.tolist())
        if up_keys.shape[0]:
            self.core.enqueue_many(self.section, False, up_keys.tolist())

    # ----------------------------------------------------------- churn

    def churn(self) -> None:
        """The next churn of the schedule, made and enqueued."""
        ch = self.schedule.next()
        apply_churn(ch, self.up, self.up_ex, self.down)
        rows = np.concatenate([ch.up_keys, ch.down_keys])
        n = rows.shape[0]
        self.lat_s = _grown(self.lat_s, self.changes + n)
        self.lat_s[self.changes:self.changes + n] = np.nan
        self.change_of[rows] = np.arange(self.changes, self.changes + n)
        self.changes += n
        self.t_churn[rows] = time.perf_counter()
        self.pending[rows] = True
        self.journal.add(CHURN, rows)
        self.core.enqueue_many(self.section, False, ch.up_keys.tolist())
        self.core.enqueue_many(self.section, True, ch.down_keys.tolist())
