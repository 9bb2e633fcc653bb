"""FusedCore — the served control plane runs the flagship device program
(the port of ``kcp_tpu.syncer.core`` onto PyTorch).

Every sync engine in the process registers a row *section* inside a
shared schema bucket, and each reconcile tick runs ONE fused step — by
default one ``reconcile_step_fleet`` over every bucket — on resident
tensors, with the packed one-array-each-way wire format and pipelined
collection. The step's decision and fan-out lanes run in the
hand-written CUDA kernel ``decide_and_match`` on the card.

Topology:

  FusedCore ── one per asyncio loop (the process's serving loop)
    ├── BatchController      one tick loop draining all engines' events
    └── FusedBucket(S)       one per slot capacity (the schema bucket)
          ├── ReconcileState resident [B, S] mirrors + per-row
          │                  status masks (engines have different slot
          │                  vocabularies, so masks are [B, S])
          └── Section        one per engine: a set of rows + callbacks

Tick pipeline — three explicit stages with a PIPELINE_DEPTH-deep
in-flight window (pipeline="double", the default; "serial" runs the
stages back-to-back as the A/B reference):

  drain/pack  — drain events (the NEXT batch drains concurrently with
                this tick: BatchController overlap_drain), engines
                encode touched keys, bucket stages rows into one of two
                rotating pre-allocated wire buffers (WireBuffers — tick
                N's upload never races tick N+1's packing)
  dispatch    — non-blocking upload from pinned staging + fused step
                (resident state updated in place, the port's form of
                donation) + a non-blocking wire copy to pinned host
                memory with an event; the host never blocks here
  fetch/apply — wires beyond the in-flight window (2 ticks old, or any
                age via the idle flusher) are fetched — blocking ONLY on
                the compact patch wire's event, never the state — then
                unpacked and routed to owning sections; engines'
                appliers take it from there without blocking the tick

Patch overflow: the wire carries at most ``patch_capacity`` actionable
rows. Because the loop is level-triggered (every tick re-decides every
row), overflow loses nothing — the core doubles capacity (a new buffer
size, nothing recompiles) and re-ticks.

Devices: the core runs on the CUDA card by default (``device=None``) and
raises without one; tests pass ``device="cpu"``, where the step takes the
kernel's plain PyTorch version.

Mesh serving: pass ``mesh=`` (a :class:`~kcp_tpu_torch.parallel.mesh.Mesh`)
to shard every bucket's state over the mesh, with the
layout of ``parallel/mesh.py``: rows over ``(hosts, tenants)``, slot
columns over ``slots``. Bucket rows pad to the row factor, the slot
capacity must divide by the slots axis, and each tick's step runs the
kernel once per device, over every row shard this process holds there
(``decide_and_match_sharded``: one grouped launch). The wire comes
back to the mesh's lead device; its host fetch waits on an event per
shard device.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Callable, NamedTuple, Protocol, Sequence

import numpy as np
import torch

from .. import faults
from ..models.reconcile_model import (
    MASK_STAMP_BIT,
    SEG_NONE,
    SEG_SHIFT,
    HostWire,
    ReconcileState,
    WireBuffers,
    reconcile_step_fleet,
    reconcile_step_packed,
    state_from_numpy,
    to_device,
    unpack_patches,
    unpack_placement,
    unpack_seg_counts,
)
from ..ops.encode import BucketOverflow, pad_pow2
from ..parallel.mesh import (
    FLAGS,
    Mesh,
    ShardedTensor,
    get_serving_mesh,
    row_factor,
    shard_state,
    slot_factor,
)
from ..reconciler.controller import BatchController
from ..utils.device import resolve_device
from ..utils.trace import DEPTH_BUCKETS, REGISTRY

log = logging.getLogger(__name__)


def _grown(a: np.ndarray, shape, dtype) -> np.ndarray:
    """Zero-padded copy of ``a`` at a larger ``shape`` (growth helper for
    the mirror and staging buffers)."""
    out = np.zeros(shape, dtype)
    out[: a.shape[0], ...] = a
    return out


def _upload_state(state: ReconcileState, device: torch.device, mesh):
    """Host mirrors as the resident state: whole on ``device``, or
    sharded over ``mesh``."""
    if mesh is None:
        return state_from_numpy(state, device)
    return shard_state(state, mesh)


def _upload(a: np.ndarray, device: torch.device, mesh, layout):
    """One host array as a resident leaf (``layout`` on a mesh)."""
    if mesh is None:
        return to_device(a, device)
    return ShardedTensor.put(to_device(a, torch.device("cpu")), mesh, layout)


def _mesh_devices(mesh) -> tuple:
    return () if mesh is None else mesh.local_devices


def _device_key(dev: torch.device) -> tuple[str, int]:
    """``cuda`` and ``cuda:0`` name one card (the current one)."""
    if dev.type == "cuda" and dev.index is None:
        return dev.type, torch.cuda.current_device()
    return dev.type, dev.index or 0


def _clone_state(state: ReconcileState) -> ReconcileState:
    """A copy the in-place step may scribble on (the probe's input)."""
    return ReconcileState(*(t.clone() for t in state))


def _phase(name: str, dt: float) -> None:
    """Record one tick-phase timing (histogram ``fused_<name>_seconds``).

    The point-sample form of :func:`kcp_tpu_torch.utils.trace.span` — used here
    because the tick segments (pack/put/step) share perf_counter points
    across branches and a with-block per segment cannot express that, and
    because some phases must record only on qualifying ticks (encode only
    when keys were touched) to keep the means meaningful. Same registry,
    same naming convention as span.

    The per-phase breakdown is the 'where does tick time go' answer;
    keep observations cheap —
    one perf_counter pair per phase per tick, never per row."""
    REGISTRY.histogram(f"fused_{name}_seconds").observe(dt)

MIN_ROWS = 64
MIN_EVENTS = 64
MIN_PATCH_CAPACITY = 256
# pipelined tick window: in-flight steps per bucket before a blocking
# collect. Depth 2 is the double-buffered pipeline — while the device
# executes tick N, the host packs tick N+1 and applies tick N-1 — and
# matches WireBuffers' two staging slots (a deeper window would reuse a
# staging buffer while its transfer could still be in flight). "serial"
# mode (depth 0) is the A/B reference: pack -> step -> fetch -> apply
# with no overlap, the sum-of-phases loop the pipeline exists to beat.
PIPELINE_DEPTH = 2
PIPELINE_MODES = ("serial", "double")
IDLE_FLUSH_S = 0.003  # collect leftovers when no new tick arrives
# poison-row quarantine: a failed device step is retried once wholesale
# (full re-upload from the host mirrors); a second consecutive failure
# bisects the submitted rows with probe steps to isolate the poison.
# Quarantined keys are requeued to their owners with bounded backoff.
QUARANTINE_BASE_BACKOFF = 0.05
QUARANTINE_MAX_BACKOFF = 5.0
BISECT_MAX_PROBES = 64


def _group_test_poison(probe: Callable[[Sequence[int]], bool],
                       groups: Sequence[Sequence[int]],
                       max_probes: int) -> list[int]:
    """The shared bisection loop: group-test ``groups`` of suspect rows
    against a probe oracle (~k*log2(n) probes for k poisons). Seeding
    with one group per segment makes the fleet bisection segment-scoped:
    a clean segment is cleared in ONE probe, and poison isolates within
    its own segment without probing cross-segment mixtures."""
    bad: list[int] = []
    stack: list[list[int]] = [list(g) for g in groups if g]
    probes = 0
    while stack:
        rows = stack.pop()
        if not rows:
            continue
        if probes >= max_probes:
            log.warning("fused-core: bisection probe budget exhausted; "
                        "quarantining %d unresolved rows wholesale",
                        len(rows))
            bad.extend(rows)
            continue
        probes += 1
        if probe(rows):
            continue
        if len(rows) == 1:
            bad.append(rows[0])
        else:
            mid = len(rows) // 2
            stack.append(rows[:mid])
            stack.append(rows[mid:])
    return bad


class SectionOwner(Protocol):
    """What an engine provides to its section (see BatchSyncEngine)."""

    def fused_encode(self, key) -> tuple[np.ndarray, bool, np.ndarray, bool]:
        """(up_vals[S], up_exists, down_vals[S], down_exists) for a key,
        re-read from the informer caches. May raise BucketOverflow."""
        ...

    def fused_status_mask(self) -> np.ndarray:
        """bool[S] — the engine's current status-slot mask."""
        ...

    def fused_apply(self, patches: list[tuple[object, int, bool]]) -> None:
        """Receive (key, decision_code, upsync) patches for this engine's
        rows. Must not block the loop (hand off to an applier pool)."""
        ...

    def fused_overflow(self) -> None:
        """The engine's slot vocabulary outgrew its bucket: grow the
        encoder, re-register in a larger bucket, replay all rows."""
        ...


class Section:
    """One engine's row allocation inside a bucket."""

    def __init__(self, bucket: "FusedBucket", owner: SectionOwner):
        self.bucket = bucket
        self.owner = owner
        self.rows: dict[object, int] = {}  # key -> global row
        self.row_keys: dict[int, object] = {}  # global row -> key
        # seed the mask cache now: row_for stamps every new row with the
        # current mask, so refresh_mask must only fire on real changes
        self._mask: np.ndarray = owner.fused_status_mask().copy()
        # fleet segment id (FusedCore.register assigns it): the per-row
        # identity the ragged fleet batch carries on device so the
        # per-segment counters can attribute live rows to this section
        self.seg: int | None = None
        self.released = False

    def row_for(self, key) -> int:
        row = self.rows.get(key)
        if row is None:
            row = self.bucket.alloc_row(self)
            self.rows[key] = row
            self.row_keys[row] = key
            # stamp with the cached mask; refresh_mask restamps everything
            # if the owner's vocabulary has drifted since
            self.bucket.status_mask[row, : self._mask.shape[0]] = self._mask
            # the DEVICE must see this stamp too: the delta wire carries
            # values only, and without a mask stamp a row allocated after
            # the last full upload reads its status churn as spec churn
            # forever (fuzz-found) — ship it as a wire entry. A stale
            # bucket needs no stamp: the pending full upload carries the
            # host mask arrays wholesale (and bulk row preallocation
            # before the first tick would otherwise stage one per row)
            # in fleet mode EVERY new row stamps (even an all-False mask):
            # the stamp entry is also how the device learns the row's
            # segment id for the per-segment counters
            if ((self._mask.any() or self.bucket.always_stamp)
                    and not self.bucket._stale):
                self.bucket.stage_mask(row, self.bucket.status_mask[row])
        return row

    def refresh_mask(self) -> None:
        """Restamp this section's rows after the owner's vocabulary grew
        new status slots (rare; triggers a full re-upload)."""
        mask = self.owner.fused_status_mask()
        if np.array_equal(self._mask, mask):
            return
        self._mask = mask.copy()
        for row in self.rows.values():
            self.bucket.status_mask[row] = False
            self.bucket.status_mask[row, : mask.shape[0]] = mask
        self.bucket.mark_stale()

    def release(self) -> None:
        self.released = True
        for row in self.rows.values():
            self.bucket.free_row(row)
        self.rows.clear()
        self.row_keys.clear()


class FusedBucket:
    """One schema bucket: host staging + device-resident fused state."""

    def __init__(self, slots: int, device: torch.device | None = None,
                 mesh: Mesh | None = None, always_stamp: bool = False):
        self.S = slots
        self.B = 0
        self.mesh = mesh
        self.device = mesh.lead if mesh is not None else resolve_device(device)
        # fleet mode: every newly-allocated row stages a mask stamp (the
        # wire entry that also carries its segment id), mask or no mask
        self.always_stamp = always_stamp
        # converged-row ack compression kill switch, resolved once (the
        # opt-out cannot change mid-process; staging is the hot path)
        self.use_acks = os.environ.get("KCP_NO_ACKS") != "1"
        # sharded state splits cleanly: row counts are padded to a
        # multiple of the row-axis product (see _grow), and the slots
        # axis must divide the (power-of-two) slot capacity up front
        self._row_factor = 1
        if mesh is not None:
            self._row_factor = row_factor(mesh)
            slot_dim = slot_factor(mesh)
            if slots % slot_dim:
                raise ValueError(
                    f"bucket slot capacity {slots} is not divisible by the "
                    f"mesh slots axis ({slot_dim}); use a power-of-two "
                    f"slots axis")
        self.up_vals = np.zeros((0, slots), np.uint32)
        self.down_vals = np.zeros((0, slots), np.uint32)
        self.up_exists = np.zeros(0, bool)
        self.down_exists = np.zeros(0, bool)
        self.status_mask = np.zeros((0, slots), bool)
        self.sections: list[Section] = []
        self.row_owner: dict[int, Section] = {}
        self._free: list[int] = []
        self._next = 0
        # placement lanes (the deployment splitter's serving section):
        # root rows with replicas + per-cluster availability, returned as
        # compacted dirty rows in the wire's placement segment
        self.placement_owner = None
        self.P = 8
        self.R = 0
        self.pl_replicas = np.zeros(0, np.int32)
        self.pl_avail = np.zeros((0, 8), bool)
        self.pl_rows: dict[object, int] = {}
        self.pl_row_keys: dict[int, object] = {}
        self._pl_free: list[int] = []
        self._pl_next = 0
        self._pl_staged = False
        self._state: ReconcileState | None = None
        self._stale = True
        self.patch_capacity = MIN_PATCH_CAPACITY
        # staged events for the next tick, accumulated directly in the
        # packed-wire layout (vals / row / flags) with last-wins dedup via
        # an O(1) (row<<1|side) -> slot map: staging and packing are
        # array copies, with no per-event Python loop.
        self._staged_slot = np.full(0, -1, np.int32)  # [2B] key -> slot
        self._staged_vals = np.zeros((0, slots), np.uint32)
        self._staged_rows = np.zeros(0, np.uint32)
        self._staged_flags = np.zeros(0, np.uint32)
        self._staged_keys = np.zeros(0, np.int64)  # slot -> key, for reset
        # converged-row ack compression (reconcile_step_packed's acks
        # lane): a down-side event equal to the resident up mirror ships
        # as a 4-byte row index instead of an (S+2)-column entry
        self._staged_ack = np.zeros(0, bool)
        self._staged_n = 0
        # mask stamps for rows allocated since the last full upload
        # (row -> bool[S]); ride the packed wire as MASK_STAMP entries
        self._staged_masks: dict[int, np.ndarray] = {}
        # acks-lane wire capacity: sticky high-water doubling from a
        # generous floor (4 KB of -1s), the reference's policy (its wire
        # shapes are compiled), kept so both packers emit the same wires
        self.ack_capacity = 1024
        # double-buffered packed-wire staging (models/reconcile_model.py):
        # tick N+1 packs into the other (pinned) buffer while tick N's
        # upload may still be reading this one — the allocation-free hot
        # path that makes the 2-deep pipeline window safe
        self._wire_bufs = WireBuffers(PIPELINE_DEPTH, self.device)
        # degraded-mode bookkeeping (poison-row quarantine): the rows the
        # last submission covered (the bisection's suspect set) and the
        # consecutive step-failure count. Probes step a CLONE of the
        # resident state, which the in-place step would otherwise change
        self._last_rows: list[int] = []
        self._step_failures = 0
        self._dropped_logged: set[int] = set()
        self.stats = {"ticks": 0, "full_uploads": 0, "overflows": 0,
                      "acked": 0, "step_failures": 0, "quarantined": 0}

    # ------------------------------------------------------------- rows

    def section(self, owner: SectionOwner) -> Section:
        s = Section(self, owner)
        self.sections.append(s)
        return s

    def alloc_row(self, section: Section) -> int:
        if self._free:
            row = self._free.pop()
        else:
            if self._next >= self.B:
                self._grow(self._next + 1)
            row = self._next
            self._next += 1
        self.row_owner[row] = section
        return row

    def free_row(self, row: int) -> None:
        self.up_exists[row] = self.down_exists[row] = False
        self.up_vals[row] = self.down_vals[row] = 0
        self.row_owner.pop(row, None)
        self._free.append(row)
        self.mark_stale()

    def _grow(self, needed: int) -> None:
        new_b = pad_pow2(max(needed, MIN_ROWS))
        if new_b % self._row_factor:
            # non-power-of-two row sharding (e.g. a 5-device tenants
            # axis): round up so every row shard is the same size
            new_b += self._row_factor - new_b % self._row_factor
        self.up_vals = _grown(self.up_vals, (new_b, self.S), np.uint32)
        self.down_vals = _grown(self.down_vals, (new_b, self.S), np.uint32)
        self.up_exists = _grown(self.up_exists, (new_b,), bool)
        self.down_exists = _grown(self.down_exists, (new_b,), bool)
        self.status_mask = _grown(self.status_mask, (new_b, self.S), bool)
        slot = np.full(2 * new_b, -1, np.int32)
        slot[: self._staged_slot.shape[0]] = self._staged_slot
        self._staged_slot = slot
        self.B = new_b
        self.mark_stale()

    def mark_stale(self) -> None:
        self._stale = True

    # -------------------------------------------------------- placement

    def register_placement(self, owner, p: int = 8) -> None:
        """Attach the deployment splitter as this bucket's placement
        owner: its roots ride the replicas/avail lanes of the SAME fused
        step that serves the sync sections (VERDICT r3 item 5 — the
        serving tick computes real placement, not zeros)."""
        if self.placement_owner is not None and self.placement_owner is not owner:
            raise RuntimeError("bucket already has a placement owner")
        self.placement_owner = owner
        self.P = pad_pow2(max(p, 1), floor=8)
        if self.pl_avail.shape[1] != self.P:
            old = self.pl_avail
            self.pl_avail = np.zeros((old.shape[0], self.P), bool)
            self.pl_avail[:, : old.shape[1]] = old[:, : self.P]
            self.mark_stale()

    def pl_row_for(self, key) -> int:
        row = self.pl_rows.get(key)
        if row is None:
            if self._pl_free:
                row = self._pl_free.pop()
            else:
                if self._pl_next >= self.R:
                    self._pl_grow(self._pl_next + 1)
                row = self._pl_next
                self._pl_next += 1
            self.pl_rows[key] = row
            self.pl_row_keys[row] = key
        return row

    def free_pl_row(self, key) -> None:
        row = self.pl_rows.pop(key, None)
        if row is None:
            return
        self.pl_row_keys.pop(row, None)
        self.pl_replicas[row] = 0
        self.pl_avail[row] = False
        self._pl_free.append(row)
        # the device-resident `current` still holds this row's last split;
        # a future occupant staging inputs whose split EQUALS it would
        # never re-dirty — rebuild the resident state (root retirement is
        # rare relative to ticks, so the full upload is acceptable)
        self.mark_stale()

    def invalidate_placement(self) -> None:
        """Force every placement row to re-emit on the next tick (rebuilds
        the resident state, zeroing `current`). Used when a host-side
        apply rejected device counts — identical re-staged inputs would
        otherwise never re-dirty."""
        self.mark_stale()

    def _pl_grow(self, needed: int) -> None:
        new_r = pad_pow2(max(needed, 8))
        if new_r % self._row_factor:
            new_r += self._row_factor - new_r % self._row_factor
        self.pl_replicas = _grown(self.pl_replicas, (new_r,), np.int32)
        self.pl_avail = _grown(self.pl_avail, (new_r, self.P), bool)
        self.R = new_r
        # shape change: the resident current[R,P] must be rebuilt too
        self.mark_stale()

    def stage_placement(self, key, replicas: int, n_clusters: int) -> None:
        """Stage one root's desired placement inputs (replicas + how many
        of the P cluster slots are available). The width grows on demand
        — P is a padding floor, never a silent cap (matching the host
        splitter's 'width follows the widest row' contract)."""
        row = self.pl_row_for(key)
        if n_clusters > self.P:
            self._pl_widen(pad_pow2(n_clusters, floor=8))
        self.pl_replicas[row] = replicas
        self.pl_avail[row] = False
        self.pl_avail[row, :n_clusters] = True
        self._pl_staged = True

    def _pl_widen(self, new_p: int) -> None:
        avail = np.zeros((self.R, new_p), bool)
        avail[:, : self.P] = self.pl_avail
        self.pl_avail = avail
        self.P = new_p
        # shape change: resident avail/current must be rebuilt
        self.mark_stale()

    # ------------------------------------------------------------ events

    def _ensure_staged_capacity(self, need: int) -> None:
        cap = self._staged_vals.shape[0]
        if need <= cap:
            return
        new_cap = pad_pow2(max(need, MIN_EVENTS))
        self._staged_vals = _grown(self._staged_vals, (new_cap, self.S), np.uint32)
        self._staged_rows = _grown(self._staged_rows, (new_cap,), np.uint32)
        self._staged_flags = _grown(self._staged_flags, (new_cap,), np.uint32)
        self._staged_keys = _grown(self._staged_keys, (new_cap,), np.int64)
        self._staged_ack = _grown(self._staged_ack, (new_cap,), bool)

    def _clear_staged(self) -> None:
        n = self._staged_n
        if n:
            self._staged_slot[self._staged_keys[:n]] = -1
            self._staged_n = 0
        self._staged_masks.clear()

    def stage_mask(self, row: int, mask: np.ndarray) -> None:
        """Stage a status-mask stamp for a newly-allocated row (ships as
        a MASK_STAMP wire entry; a full upload supersedes it)."""
        self._staged_masks[row] = mask.copy()

    def stage(self, row: int, side: bool, vals: np.ndarray, exists: bool) -> None:
        """Stage one delta event (last-wins per (row, side)) and mirror it
        into host staging (the rebuild source of truth). The 1-row form
        of :meth:`stage_many` — one copy of the slot-map logic."""
        self.stage_many(np.array([row]), side, np.asarray(vals)[None, :],
                        np.array([exists]))

    def stage_many(self, rows: np.ndarray, side: bool, vals: np.ndarray,
                   exists: np.ndarray) -> None:
        """Vectorized :meth:`stage` for one side of a unique row batch
        (the fused_encode_many path): fancy-indexed mirror writes plus a
        single slot-map pass, no per-event python loop."""
        n, w = vals.shape
        ack_ok = None
        if side:
            if self.use_acks:
                # ack eligibility must be proven BEFORE any buffers
                # change: the event's value equals the host up mirror
                # (which equals the device's resident row, because no
                # up-side entry is staged for it this tick) — then the
                # device can produce the row itself from a 4-byte index
                ack_ok = (exists & self.up_exists[rows]
                          & (self._staged_slot[rows.astype(np.int64) << 1] < 0)
                          & (vals == self.up_vals[rows, :w]).all(axis=1))
                if w < self.S:
                    ack_ok &= (self.up_vals[rows, w:] == 0).all(axis=1)
            self.down_vals[rows, :w] = vals
            self.down_vals[rows, w:] = 0
            self.down_exists[rows] = exists
        else:
            self.up_vals[rows, :w] = vals
            self.up_vals[rows, w:] = 0
            self.up_exists[rows] = exists
        keys = (rows.astype(np.int64) << 1) | (1 if side else 0)
        slots = self._staged_slot[keys].astype(np.int64)
        fresh = slots < 0
        n_new = int(fresh.sum())
        if n_new:
            self._ensure_staged_capacity(self._staged_n + n_new)
            new_slots = np.arange(self._staged_n, self._staged_n + n_new)
            slots[fresh] = new_slots
            self._staged_slot[keys[fresh]] = new_slots
            self._staged_keys[new_slots] = keys[fresh]
            self._staged_rows[slots] = rows
            self._staged_n += n_new
        self._staged_vals[slots, :w] = vals
        self._staged_vals[slots, w:] = 0
        self._staged_flags[slots] = (exists.astype(np.uint32)
                                     | (2 if side else 0) | 4)
        self._staged_ack[slots] = ack_ok if ack_ok is not None else False

    @property
    def dirty(self) -> bool:
        return (bool(self._staged_n) or bool(self._staged_masks)
                or self._stale or self._pl_staged)

    # -------------------------------------------------------------- tick

    def _device_state(self) -> ReconcileState:
        # placement lanes: real when a placement owner registered (the
        # splitter's roots), minimal placeholders otherwise — either way
        # the program IS the flagship step, lanes and all (placement
        # rows are row-sharded too — pad to the row factor)
        f = self._row_factor
        if self.R:
            replicas, avail = self.pl_replicas, self.pl_avail
            r, p = self.R, self.P
        else:
            r = ((8 + f - 1) // f) * f
            p = 8
            replicas = np.zeros(r, np.int32)
            avail = np.zeros((r, p), bool)
        l, c = 1, 8
        state = ReconcileState(
            up_vals=self.up_vals, up_exists=self.up_exists,
            down_vals=self.down_vals, down_exists=self.down_exists,
            status_mask=self.status_mask,
            replicas=replicas,
            avail=avail,
            current=np.zeros((r, p), np.int32),
            pair_hashes=np.zeros((self.B, l), np.uint32),
            sel_hashes=np.zeros(c, np.uint32),
        )
        return _upload_state(state, self.device, self.mesh)

    def submit(self) -> tuple[HostWire, tuple[int, int]] | None:
        """Upload staged events, run one fused step, return the wire (its
        copy to the host already issued) plus the (patch_capacity, P)
        needed to unpack it. None if nothing to do."""
        if not self.dirty:
            return None
        t0 = time.perf_counter()
        s = self.S
        was_stale = self._stale
        if self._stale:
            self._state = self._device_state()
            self._stale = False
            self._clear_staged()
            self._pl_staged = False
            self.stats["full_uploads"] += 1
            # a full upload re-submits every owned row — they are all
            # suspects if this step fails (quarantine bisection input)
            self._last_rows = sorted(self.row_owner)
            # full upload replaces the mirrors wholesale; still run the
            # step so decisions for the new state come back
            buf_slot, packed, acks = self._wire_bufs.acquire(
                MIN_EVENTS, s + 2, self.ack_capacity)
        else:
            if self._pl_staged:
                # placement inputs changed (roots staged/retired): swap
                # ONLY the small replicas/avail leaves — never the [B,S]
                # mirrors (shapes are stable here; growth marks stale)
                self._pl_staged = False
                reps = _upload(self.pl_replicas, self.device, self.mesh, FLAGS)
                avail = _upload(self.pl_avail, self.device, self.mesh, FLAGS)
                self._state = self._state._replace(replicas=reps, avail=avail)
            # the staged buffers already hold the packed-wire layout
            # (vals / row / flags, the unpack_deltas format) — one padded
            # block copy and a reset of the slot map finish the pack.
            # Ack-eligible slots ship on the 4-byte acks lane instead;
            # mask stamps for newly-allocated rows append as MASK_STAMP
            # entries (vals columns = the bool mask row).
            n = self._staged_n
            ack_sel = self._staged_ack[:n]
            na = int(ack_sel.sum())
            nf = n - na
            nm = len(self._staged_masks)
            d = pad_pow2(nf + nm, floor=MIN_EVENTS)
            # always ship the acks array, even all-padding: one wire
            # shape pair for every tick (the reference's compile-variant
            # rule, kept so both packers stay byte-identical)
            while self.ack_capacity < na:
                self.ack_capacity *= 2
            buf_slot, packed, acks = self._wire_bufs.acquire(
                d, s + 2, self.ack_capacity)
            if na:
                self.stats["acked"] += na
                full_sel = ~ack_sel
                packed[:nf, :s] = self._staged_vals[:n][full_sel]
                packed[:nf, s] = self._staged_rows[:n][full_sel]
                packed[:nf, s + 1] = self._staged_flags[:n][full_sel]
                acks[:na] = self._staged_rows[:n][ack_sel]
            else:
                packed[:n, :s] = self._staged_vals[:n]
                packed[:n, s] = self._staged_rows[:n]
                packed[:n, s + 1] = self._staged_flags[:n]
            if nm:
                mrows = np.fromiter(self._staged_masks, np.uint32, nm)
                masks = np.stack(list(self._staged_masks.values()))
                packed[nf:nf + nm, : masks.shape[1]] = masks.astype(np.uint32)
                packed[nf:nf + nm, s] = mrows
                packed[nf:nf + nm, s + 1] = 4 | MASK_STAMP_BIT
            rows_touched = set(self._staged_rows[:n].tolist())
            rows_touched.update(self._staged_masks)
            self._last_rows = sorted(rows_touched)
            self._clear_staged()
        t1 = time.perf_counter()
        # non-blocking upload; the slot's next acquire waits on its event
        packed, acks = self._wire_bufs.upload(buf_slot)
        t2 = time.perf_counter()
        _phase("put", t2 - t1)
        k = min(self.patch_capacity, self.B)
        # KCP_FAULTS `device.step` injection point (raise@tick / error /
        # poison_row): fires HERE, where a real launch failure would
        # surface — the quarantine machinery recovers either way
        faults.maybe_fail("device.step", rows=self._last_rows)
        self._state, wire = reconcile_step_packed(
            self._state, packed, acks, patch_capacity=k, mesh=self.mesh)
        self._step_failures = 0
        wire = HostWire(wire, _mesh_devices(self.mesh))
        t3 = time.perf_counter()
        # a stale tick's t1-t0 is the whole-mirror device upload, not the
        # steady-state pack — keep the histograms separable
        _phase("full_upload" if was_stale else "pack", t1 - t0)
        _phase("step_dispatch", t3 - t2)
        self.stats["ticks"] += 1
        return wire, (k, int(self._state.avail.shape[1]))

    # ------------------------------------------------------- quarantine

    def probe_rows(self, rows: Sequence[int]) -> bool:
        """Run one trial step over a synthetic wire carrying only
        ``rows`` (both sides, from the host mirrors), discarding the
        result. True iff the step completed — the bisection's oracle.

        The probe steps a clone of the resident state: the state must
        survive an arbitrary number of probes."""
        if self.B == 0:
            return True
        rows = [int(r) for r in rows]
        try:
            faults.maybe_fail("device.step", rows=rows)
            if self._state is None:
                self._state = self._device_state()
                self._stale = False
            s = self.S
            d = pad_pow2(max(2 * len(rows), 1), floor=MIN_EVENTS)
            packed = np.zeros((d, s + 2), np.uint32)
            for i, row in enumerate(rows):
                packed[2 * i, :s] = self.up_vals[row]
                packed[2 * i, s] = row
                packed[2 * i, s + 1] = (1 if self.up_exists[row] else 0) | 4
                packed[2 * i + 1, :s] = self.down_vals[row]
                packed[2 * i + 1, s] = row
                packed[2 * i + 1, s + 1] = (
                    (1 if self.down_exists[row] else 0) | 2 | 4)
            acks = np.full(self.ack_capacity, -1, np.int32)
            _state, wire = reconcile_step_packed(
                _clone_state(self._state), to_device(packed, self.device),
                to_device(acks, self.device),
                patch_capacity=min(self.patch_capacity, self.B), mesh=self.mesh)
            # force execution: the card reports kernel faults at a sync
            np.asarray(HostWire(wire, _mesh_devices(self.mesh)))
            return True
        except Exception:  # noqa: BLE001 — any failure means "poisoned"
            return False

    def bisect_poison(self, suspects: Sequence[int],
                      max_probes: int = BISECT_MAX_PROBES) -> list[int] | None:
        """Isolate the rows whose presence makes the step fail, by
        group-testing probe steps (~k*log2(n) probes for k poisons).

        Returns None when even an EMPTY probe fails — the failure is
        row-independent and quarantine cannot help. If the probe budget
        runs out, the unresolved remainder is quarantined wholesale
        (innocents may be swept up; degraded beats dead, and their
        requeue brings them back)."""
        if not self.probe_rows([]):
            return None
        return _group_test_poison(
            self.probe_rows, [[int(r) for r in suspects]], max_probes)

    def note_step_failure(self) -> None:
        self.stats["step_failures"] += 1
        self._step_failures += 1

    def quarantine_row(self, row: int) -> tuple[object | None, Section | None]:
        """Evict one poisoned row: zero its host mirrors (the pending
        full re-upload then excludes it from the resident state), free
        the row, and return (key, section) so the core can requeue the
        key to its owner with bounded backoff. One bad object must never
        stall its bucket's co-tenants."""
        sec = self.row_owner.get(row)
        key = sec.row_keys.get(row) if sec is not None else None
        self.up_vals[row] = 0
        self.down_vals[row] = 0
        self.up_exists[row] = False
        self.down_exists[row] = False
        self.status_mask[row] = False
        if sec is not None:
            if key is not None:
                sec.rows.pop(key, None)
            sec.row_keys.pop(row, None)
            self.row_owner.pop(row, None)
            self._free.append(row)
        self.stats["quarantined"] += 1
        REGISTRY.counter(
            "quarantined_rows",
            "rows evicted from fused buckets by poison-row quarantine").inc()
        self.mark_stale()
        return key, sec

    # ----------------------------------------------------------- routing

    def dispatch(self, wire: np.ndarray, meta: tuple[int, int]) -> bool:
        """Route a collected wire's patches (and dirty placement rows) to
        their owners.

        Returns True if the patch set overflowed (caller re-ticks after
        doubling capacity)."""
        idx, code, upsync, overflow, _stats = unpack_patches(wire)
        self.route_patches(idx, code, upsync)
        if self.placement_owner is not None:
            k, p = meta
            rows, counts = unpack_placement(wire, k, p)
            self.route_placement(rows, counts)
        if overflow:
            self.note_overflow()
        return bool(overflow)

    def route_patches(self, idx: np.ndarray, code: np.ndarray,
                      upsync: np.ndarray) -> None:
        """Route patch rows (bucket-local indices) to their owning
        sections — shared by the per-bucket dispatch and the fleet batch
        (which splits a fleet wire's patches by row range first)."""
        per_section: dict[Section, list[tuple[object, int, bool]]] = {}
        dropped = 0
        for r, c, u in zip(idx.tolist(), code.tolist(), upsync.tolist()):
            s = self.row_owner.get(r)
            key = s.row_keys.get(r) if s is not None else None
            if key is None:
                # an unowned/unkeyed patch row (released section, freed or
                # quarantined row, in-flight wire racing a retirement):
                # benign by design, but it must be COUNTED, not silent
                dropped += 1
                if r not in self._dropped_logged:
                    self._dropped_logged.add(r)
                    log.warning(
                        "fused-core: dropping patch for row %d (%s); "
                        "counted in fused_dropped_patch_rows", r,
                        "no owning section" if s is None else "no key mapping")
                continue
            per_section.setdefault(s, []).append((key, c, u))
        if dropped:
            REGISTRY.counter(
                "fused_dropped_patch_rows",
                "patch rows dropped at dispatch because their row had no "
                "owner/key (released, freed, or quarantined)").inc(dropped)
        for s, patches in per_section.items():
            s.owner.fused_apply(patches)

    def route_placement(self, rows: np.ndarray, counts: np.ndarray) -> None:
        """Route dirty placement rows (bucket-local) to the placement
        owner."""
        if self.placement_owner is None:
            return
        applies = []
        for i, row in enumerate(rows.tolist()):
            key = self.pl_row_keys.get(row)
            if key is not None:
                # copy: a view would pin the whole wire buffer in the
                # applier queue / retry cache
                applies.append((key, counts[i].copy()))
        if applies:
            self.placement_owner.placement_apply(applies)

    def note_overflow(self) -> None:
        self.stats["overflows"] += 1
        self.patch_capacity = min(self.patch_capacity * 2, max(self.B, MIN_ROWS))


class FleetMeta(NamedTuple):
    """Per-submit layout snapshot riding with an in-flight fleet wire.

    The fleet layout can change while a wire is still in flight (bucket
    growth, new buckets, placement widening all mark the fleet stale for
    the NEXT tick) — collection must unpack against the layout the wire
    was built under, never the current one."""

    k: int                      # patch capacity submitted
    p: int                      # placement width in the wire
    r_total: int                # placement rows in the wire
    members: tuple              # member buckets, layout order
    bases: tuple[int, ...]      # fleet row base per member
    ends: tuple[int, ...]       # fleet row end (base + B) per member
    pl_members: tuple           # members contributing placement rows
    pl_bases: tuple[int, ...]
    pl_ends: tuple[int, ...]
    seg_capacity: int


class FleetBatch:
    """One ragged device batch for the whole bucket fleet.

    Per-bucket dispatch pays full dispatch/pipeline latency per schema
    bucket — small and ragged buckets leave the chip idle between kicks.
    The fleet batch packs EVERY bucket's rows into one unified
    ReconcileState (rows range-partitioned by bucket, slot columns
    zero-padded to the widest member, per-row status masks — the [B, S]
    form the kernel takes, at any ragged B) so a reconcile tick is ONE
    pipelined ``reconcile_step_fleet`` no matter how many buckets exist.
    Results scatter back to per-bucket patch streams on collect
    (row ranges -> bucket.route_patches), so engines observe byte-
    identical patch streams vs per-bucket dispatch — the differential-
    fuzz contract.

    Per-row *segment ids* (the owning section) ride the batch as a
    resident int32 lane; the step returns per-segment live-row counts on
    the wire tail, which the core forwards to the admission quota ledger
    (admission accounting rides the same batch, no host-side pass).

    Degraded mode preserves the PR 2 semantics: a failed step retries
    once wholesale, then bisects *by segment* — the group test is seeded
    with one group per member bucket, so poison isolates within its own
    segment and only the poison rows are quarantined (via the owning
    bucket, which requeues the keys with bounded backoff).
    """

    def __init__(self, core: "FusedCore"):
        self.core = core
        self.device = core.device
        self.mesh = core.mesh
        self._members: list[FusedBucket] = []
        self._bases: list[int] = []
        self._ends: list[int] = []
        self._pl_members: list[FusedBucket] = []
        self._pl_bases: list[int] = []
        self._pl_ends: list[int] = []
        self._layout_key: tuple | None = None
        self.B = 0
        self.S = 0
        self.R = 0
        self.P = 8
        self._state: ReconcileState | None = None
        self._seg_ids = None  # device int32 [B]: row -> section segment
        self._seg_capacity = 8
        self._stale = True
        self.ack_capacity = 1024
        self._wire_bufs = WireBuffers(PIPELINE_DEPTH, self.device)
        self._last_rows: list[int] = []
        self._step_failures = 0
        # empty_ticks: fleet steps with no synced rows (placement lanes
        # only), where decide_and_match has nothing to decide and launches
        # nothing
        self.stats = {"ticks": 0, "empty_ticks": 0, "full_uploads": 0, "overflows": 0,
                      "acked": 0, "step_failures": 0, "quarantined": 0}

    # ----------------------------------------------------------- layout

    def _refresh_layout(self) -> None:
        members = list(self.core.buckets.values())
        key = tuple((id(b), b.B, b.S, b.R, b.P) for b in members)
        if key == self._layout_key:
            return
        self._layout_key = key
        self._members = members
        self._bases, self._ends = [], []
        base, s = 0, 0
        for b in members:
            self._bases.append(base)
            base += b.B
            self._ends.append(base)
            s = max(s, b.S)
        self.B = base
        self.S = s
        self._pl_members, self._pl_bases, self._pl_ends = [], [], []
        r, p = 0, 8
        for b in members:
            if b.R:
                self._pl_members.append(b)
                self._pl_bases.append(r)
                r += b.R
                self._pl_ends.append(r)
                p = max(p, b.P)
        self.R = r
        self.P = p
        # any layout change invalidates the resident fleet state: row
        # bases moved, so a full re-upload rebuilds it (bucket growth is
        # pow2 + rare, same cost class as a bucket's own growth)
        self._stale = True

    @property
    def dirty(self) -> bool:
        return self._stale or any(b.dirty
                                  for b in self.core.buckets.values())

    def mark_stale(self) -> None:
        self._stale = True

    def _locate(self, fleet_row: int) -> tuple[FusedBucket, int]:
        """(owning bucket, bucket-local row) for a fleet row index."""
        for b, base, end in zip(self._members, self._bases, self._ends):
            if base <= fleet_row < end:
                return b, fleet_row - base
        raise KeyError(f"fleet row {fleet_row} outside layout (B={self.B})")

    # ------------------------------------------------------------ state

    def _placement_leaves(self) -> tuple[np.ndarray, np.ndarray, int, int]:
        f = self._members[0]._row_factor if self._members else 1
        if self.R:
            r, p = self.R, self.P
            replicas = np.zeros(r, np.int32)
            avail = np.zeros((r, p), bool)
            for b, pb in zip(self._pl_members, self._pl_bases):
                replicas[pb:pb + b.R] = b.pl_replicas
                avail[pb:pb + b.R, :b.P] = b.pl_avail
        else:
            r = ((8 + f - 1) // f) * f
            p = 8
            replicas = np.zeros(r, np.int32)
            avail = np.zeros((r, p), bool)
        return replicas, avail, r, p

    def _device_state(self) -> tuple[ReconcileState, torch.Tensor]:
        """The concatenated fleet state + the row->segment lane, sharded
        like any bucket state on a mesh (the seg lane like the exists
        flags)."""
        s = self.S
        up_vals = np.zeros((self.B, s), np.uint32)
        down_vals = np.zeros((self.B, s), np.uint32)
        up_exists = np.zeros(self.B, bool)
        down_exists = np.zeros(self.B, bool)
        status_mask = np.zeros((self.B, s), bool)
        seg = np.full(self.B, SEG_NONE, np.int32)
        for b, base in zip(self._members, self._bases):
            end = base + b.B
            up_vals[base:end, :b.S] = b.up_vals
            down_vals[base:end, :b.S] = b.down_vals
            up_exists[base:end] = b.up_exists
            down_exists[base:end] = b.down_exists
            status_mask[base:end, :b.S] = b.status_mask
            for row, sec in b.row_owner.items():
                if sec.seg is not None:
                    seg[base + row] = sec.seg
        replicas, avail, r, p = self._placement_leaves()
        state = ReconcileState(
            up_vals=up_vals, up_exists=up_exists,
            down_vals=down_vals, down_exists=down_exists,
            status_mask=status_mask,
            replicas=replicas, avail=avail,
            current=np.zeros((r, p), np.int32),
            pair_hashes=np.zeros((self.B, 1), np.uint32),
            sel_hashes=np.zeros(8, np.uint32),
        )
        return (_upload_state(state, self.device, self.mesh),
                _upload(seg, self.device, self.mesh, FLAGS))

    # ------------------------------------------------------------- tick

    def _patch_capacity(self) -> int:
        # member patch capacities pool into the fleet wire, so one
        # bucket's overflow-doubled budget benefits the whole batch
        return min(sum(b.patch_capacity for b in self._members), self.B)

    def submit(self) -> tuple[HostWire, FleetMeta] | None:
        """Pack every dirty bucket's staged rows into one ragged batch,
        run ONE fused step, return the wire (its copy to the host already
        issued) plus the layout snapshot needed to unpack it at collect
        time."""
        if not self.dirty:
            return None
        self._refresh_layout()
        if not self._members:
            return None
        t0 = time.perf_counter()
        s = self.S
        self._seg_capacity = pad_pow2(max(self.core._next_seg, 1), floor=8)
        was_stale = self._stale or any(b._stale for b in self._members)
        local_rows: list[int] = []  # bucket-local ids for KCP_FAULTS
        if was_stale:
            self._state, self._seg_ids = self._device_state()
            self._stale = False
            self._last_rows = []
            for b, base in zip(self._members, self._bases):
                b._stale = False
                b._clear_staged()
                b._pl_staged = False
                b.stats["full_uploads"] += 1
                owned = sorted(b.row_owner)
                local_rows.extend(owned)
                self._last_rows.extend(base + r for r in owned)
            self.stats["full_uploads"] += 1
            buf_slot, packed, acks = self._wire_bufs.acquire(
                MIN_EVENTS, s + 2, self.ack_capacity)
        else:
            if any(b._pl_staged for b in self._members):
                for b in self._members:
                    b._pl_staged = False
                replicas, avail, _r, _p = self._placement_leaves()
                reps = _upload(replicas, self.device, self.mesh, FLAGS)
                av = _upload(avail, self.device, self.mesh, FLAGS)
                self._state = self._state._replace(replicas=reps, avail=av)
            # gather the members' staged arrays (already the packed-wire
            # layout) into one fleet wire: row indices shift by the
            # member's base, ack-eligible slots pool on one acks lane,
            # mask stamps gain the owning section's segment id
            per: list[tuple] = []
            nf_total = na_total = nm_total = 0
            for b, base in zip(self._members, self._bases):
                n = b._staged_n
                ack_sel = b._staged_ack[:n]
                na = int(ack_sel.sum())
                nm = len(b._staged_masks)
                per.append((b, base, n, ack_sel, na, nm))
                nf_total += n - na
                na_total += na
                nm_total += nm
            d = pad_pow2(nf_total + nm_total, floor=MIN_EVENTS)
            # fleet acks capacity honors each member's sticky high-water
            # (a pre-warmed bucket.ack_capacity keeps the wire shapes of
            # the reference's packer — the fleet must not undo that)
            cap = max(self.ack_capacity,
                      max((b.ack_capacity for b in self._members),
                          default=1024))
            while cap < na_total:
                cap *= 2
            self.ack_capacity = cap
            buf_slot, packed, acks = self._wire_bufs.acquire(d, s + 2, cap)
            pos = apos = 0
            self._last_rows = []
            for b, base, n, ack_sel, na, nm in per:
                w = b.S
                if n:
                    if na:
                        full_sel = ~ack_sel
                        nf = n - na
                        packed[pos:pos + nf, :w] = b._staged_vals[:n][full_sel]
                        packed[pos:pos + nf, s] = (
                            b._staged_rows[:n][full_sel] + np.uint32(base))
                        packed[pos:pos + nf, s + 1] = (
                            b._staged_flags[:n][full_sel])
                        acks[apos:apos + na] = (
                            b._staged_rows[:n][ack_sel].astype(np.int32)
                            + base)
                        apos += na
                        b.stats["acked"] += na
                        self.stats["acked"] += na
                        pos += nf
                    else:
                        packed[pos:pos + n, :w] = b._staged_vals[:n]
                        packed[pos:pos + n, s] = (
                            b._staged_rows[:n] + np.uint32(base))
                        packed[pos:pos + n, s + 1] = b._staged_flags[:n]
                        pos += n
                if nm:
                    mrows = np.fromiter(b._staged_masks, np.uint32, nm)
                    masks = np.stack(list(b._staged_masks.values()))
                    packed[pos:pos + nm, :masks.shape[1]] = (
                        masks.astype(np.uint32))
                    packed[pos:pos + nm, s] = mrows + np.uint32(base)
                    segs = np.fromiter(
                        (sec.seg if (sec := b.row_owner.get(r)) is not None
                         and sec.seg is not None else SEG_NONE
                         for r in b._staged_masks), np.uint32, nm)
                    packed[pos:pos + nm, s + 1] = (
                        4 | MASK_STAMP_BIT | (segs << SEG_SHIFT))
                    pos += nm
                touched = set(b._staged_rows[:n].tolist())
                touched.update(b._staged_masks)
                local_rows.extend(touched)
                self._last_rows.extend(base + r for r in sorted(touched))
                b._clear_staged()
        t1 = time.perf_counter()
        packed_d, acks_d = self._wire_bufs.upload(buf_slot)
        t2 = time.perf_counter()
        _phase("put", t2 - t1)
        k = self._patch_capacity()
        # KCP_FAULTS `device.step`: rows are BUCKET-LOCAL ids (the union
        # across members), so a poison_row spec targets the same logical
        # rows whether dispatch is per-bucket or fleet-wide — the
        # differential fuzz relies on it
        faults.maybe_fail("device.step", rows=local_rows)
        self._state, self._seg_ids, wire = reconcile_step_fleet(
            self._state, self._seg_ids, packed_d, acks_d,
            patch_capacity=k, seg_capacity=self._seg_capacity, mesh=self.mesh)
        self._step_failures = 0
        wire = HostWire(wire, _mesh_devices(self.mesh))
        t3 = time.perf_counter()
        _phase("full_upload" if was_stale else "pack", t1 - t0)
        _phase("step_dispatch", t3 - t2)
        self.stats["ticks"] += 1
        self.stats["empty_ticks"] += self.B == 0
        # member tick counters advance too: the fleet step covers every
        # bucket's rows, and engines/benches read their bucket's counter
        for b in self._members:
            b.stats["ticks"] += 1
        REGISTRY.counter(
            "fused_fleet_ticks_total",
            "fleet-wide ragged batch steps dispatched").inc()
        REGISTRY.gauge(
            "fused_fleet_rows", "rows in the fleet batch").set(self.B)
        REGISTRY.gauge(
            "fused_fleet_buckets",
            "schema buckets packed into the fleet batch").set(
            len(self._members))
        REGISTRY.gauge(
            "fused_fleet_segments",
            "registered sections (fleet segments)").set(
            len(self.core._segments))
        meta = FleetMeta(
            k=k, p=int(self._state.avail.shape[1]),
            r_total=int(self._state.replicas.shape[0]),
            members=tuple(self._members), bases=tuple(self._bases),
            ends=tuple(self._ends), pl_members=tuple(self._pl_members),
            pl_bases=tuple(self._pl_bases), pl_ends=tuple(self._pl_ends),
            seg_capacity=self._seg_capacity,
        )
        return wire, meta

    # ---------------------------------------------------------- routing

    def dispatch(self, wire: np.ndarray, meta: FleetMeta) -> bool:
        """Scatter a collected fleet wire back to per-bucket patch
        streams: split patches and placement rows by the row ranges of
        the submitting layout, then route through each member's own
        section/placement routing. Returns True on patch overflow."""
        idx, code, upsync, overflow, _stats = unpack_patches(wire)
        if idx.size:
            ends = np.asarray(meta.ends, np.int64)
            mi = np.searchsorted(ends, idx, side="right")
            for j, b in enumerate(meta.members):
                sel = mi == j
                if sel.any():
                    b.route_patches(idx[sel] - meta.bases[j],
                                    code[sel], upsync[sel])
        if meta.pl_members:
            rows, counts = unpack_placement(wire, meta.k, meta.p,
                                            r=meta.r_total)
            if rows.size:
                pl_ends = np.asarray(meta.pl_ends, np.int64)
                pmi = np.searchsorted(pl_ends, rows, side="right")
                for j, b in enumerate(meta.pl_members):
                    sel = pmi == j
                    if sel.any():
                        pw = min(b.P, meta.p)
                        b.route_placement(rows[sel] - meta.pl_bases[j],
                                          counts[sel][:, :pw])
        # per-segment live-row counts -> the admission quota ledger
        self.core._publish_fleet_counts(
            unpack_seg_counts(wire, meta.k, meta.r_total, meta.p,
                              meta.seg_capacity))
        if overflow:
            self.stats["overflows"] += 1
            for b in meta.members:
                b.note_overflow()
        return bool(overflow)

    # ------------------------------------------------------- quarantine

    def note_step_failure(self) -> None:
        self.stats["step_failures"] += 1
        self._step_failures += 1
        for b in self._members:
            b.stats["step_failures"] += 1

    def probe_rows(self, rows: Sequence[int]) -> bool:
        """The fleet bisection oracle: one trial step on a clone of the
        resident state over a synthetic wire carrying only ``rows`` (fleet
        ids), rebuilt from the owning buckets' host mirrors. True iff the
        step completed."""
        if self.B == 0:
            return True
        rows = [int(r) for r in rows]
        locs = [self._locate(r) for r in rows]
        try:
            faults.maybe_fail("device.step", rows=[lr for _b, lr in locs])
            if self._state is None:
                self._state, self._seg_ids = self._device_state()
                self._stale = False
            s = self.S
            d = pad_pow2(max(2 * len(rows), 1), floor=MIN_EVENTS)
            packed = np.zeros((d, s + 2), np.uint32)
            for i, ((b, lr), fr) in enumerate(zip(locs, rows)):
                packed[2 * i, :b.S] = b.up_vals[lr]
                packed[2 * i, s] = fr
                packed[2 * i, s + 1] = (1 if b.up_exists[lr] else 0) | 4
                packed[2 * i + 1, :b.S] = b.down_vals[lr]
                packed[2 * i + 1, s] = fr
                packed[2 * i + 1, s + 1] = (
                    (1 if b.down_exists[lr] else 0) | 2 | 4)
            acks = np.full(self.ack_capacity, -1, np.int32)
            _state, _seg, wire = reconcile_step_fleet(
                _clone_state(self._state), self._seg_ids.clone(),
                to_device(packed, self.device), to_device(acks, self.device),
                patch_capacity=self._patch_capacity(),
                seg_capacity=self._seg_capacity, mesh=self.mesh)
            # force execution: the card reports kernel faults at a sync
            np.asarray(HostWire(wire, _mesh_devices(self.mesh)))
            return True
        except Exception:  # noqa: BLE001 — any failure means "poisoned"
            return False

    def bisect_poison(self, suspects: Sequence[int],
                      max_probes: int = BISECT_MAX_PROBES) -> list[int] | None:
        """Segment-scoped bisection over the ragged batch: the group test
        is seeded with one suspect group per member bucket, so a clean
        segment clears in one probe and poison isolates within its own
        segment. None when even the empty probe fails (systemic)."""
        if not self.probe_rows([]):
            return None
        groups: dict[int, list[int]] = {}
        for r in suspects:
            b, _lr = self._locate(int(r))
            groups.setdefault(id(b), []).append(int(r))
        return _group_test_poison(self.probe_rows, list(groups.values()),
                                  max_probes)

    def quarantine_row(self, row: int) -> tuple[object | None, Section | None]:
        """Evict one poisoned fleet row via its owning bucket (which
        zeroes the mirrors, frees the row, marks itself stale — forcing
        the fleet re-upload — and hands back the key for requeue)."""
        b, lr = self._locate(int(row))
        self.stats["quarantined"] += 1
        return b.quarantine_row(lr)


class FusedCore:
    """The per-loop serving core: one tick loop over all fused buckets."""

    _instances: dict[int, "FusedCore"] = {}
    # process-default admission quota ledger (set_process_ledger): the
    # sink for the fleet batch's device-side per-segment counters
    _process_ledger = None

    def __init__(self, mesh=None, batch_window: float = 0.002,
                 pipeline: str | None = None,
                 fleet: bool | None = None,
                 device: "str | torch.device | None" = None):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        self.mesh = mesh
        # the CUDA card unless the caller asks for the CPU by name; on a
        # mesh, the mesh's devices (its lead takes the wires)
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.lead:
                raise ValueError(f"device={device} is not the mesh's lead "
                                 f"device {mesh.lead}")
            self.device = mesh.lead
        else:
            self.device = resolve_device(device)
        # fleet-wide ragged batching (default on): every tick packs all
        # dirty buckets into ONE pipelined device program. KCP_FLEET_BATCH=0
        # is the fallback knob — per-bucket dispatch, the A/B reference
        # for the ragged differential fuzz
        if fleet is None:
            fleet = os.environ.get("KCP_FLEET_BATCH", "1").lower() not in (
                "0", "false", "off")
        self.fleet_mode = fleet
        self._fleet = FleetBatch(self) if fleet else None
        self._segments: dict[int, Section] = {}  # seg id -> section
        self._next_seg = 0
        self.ledger = FusedCore._process_ledger
        # tick pipelining mode: "double" (default) keeps up to
        # PIPELINE_DEPTH steps in flight per bucket — pack N+1 and apply
        # N-1 while the device runs N; "serial" collects every wire in
        # the tick that submitted it (the A/B reference for the
        # equivalence fuzz)
        if pipeline is None:
            pipeline = os.environ.get("KCP_PIPELINE", "") or "double"
        if pipeline not in PIPELINE_MODES:
            raise ValueError(f"pipeline must be one of {PIPELINE_MODES}, "
                             f"got {pipeline!r}")
        self.pipeline = pipeline
        self.fetch_depth = PIPELINE_DEPTH if pipeline == "double" else 0
        REGISTRY.gauge(
            "fused_pipeline_window",
            "configured in-flight tick window (0 = serial mode)",
        ).set(self.fetch_depth)
        self.buckets: dict[int, FusedBucket] = {}
        self.controller = BatchController(
            "fused-core", self._process_batch, batch_window=batch_window,
            overlap_drain=(pipeline == "double"),
        )
        self._inflight: list[tuple[FusedBucket, HostWire, tuple]] = []
        self._flush_task: asyncio.Task | None = None
        self._eager_collect: bool | None = None  # resolved on first flush
        # quarantined keys awaiting their bounded-backoff requeue
        self._quarantine_retries: dict[tuple[int, object], int] = {}
        self._refs = 0
        self._started = False
        self._stopping = False
        self._stop_done: asyncio.Event | None = None
        self._loop = None

    # ---------------------------------------------------------- lifecycle

    @classmethod
    def for_current_loop(cls, mesh=None, pipeline: str | None = None,
                         device: "str | torch.device | None" = None,
                         ) -> "FusedCore":
        """The process-wide core for the running asyncio loop (tests run
        many loops sequentially; each gets a fresh core).

        ``pipeline=None`` falls back to ``KCP_PIPELINE`` (default
        "double"); ``device=None`` is the CUDA card, or the mesh's lead
        device on a mesh. ``mesh=None`` falls back to the process serving
        mesh (``parallel.mesh.set_serving_mesh``), so a configured process
        serves sharded without every engine re-plumbing the mesh.

        Every caller in one loop (the push syncers' engines, the
        deployment splitter) shares the one core: a caller asking for
        another device or mesh than the live core's is an error."""
        if mesh is None:
            mesh = get_serving_mesh()
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        core = cls._instances.get(id(loop))
        # the identity check guards against id() reuse after a dead loop
        # is garbage-collected: a stale core's tick task died with its loop
        if core is None or core._closed() or core._loop is not loop:
            core = cls(mesh=mesh, pipeline=pipeline, device=device)
            core._loop = loop
            cls._instances[id(loop)] = core
            return core
        want = resolve_device(device, mesh)
        if core.mesh != mesh or _device_key(core.device) != _device_key(want):
            raise ValueError(
                f"the FusedCore of this loop runs on {core.device} with mesh "
                f"{core.mesh}; a caller asked for {want} with mesh {mesh}")
        if pipeline is not None and core.pipeline != pipeline:
            log.warning("FusedCore for this loop already exists with "
                        "pipeline=%s; keeping it", core.pipeline)
        return core

    @classmethod
    def set_process_ledger(cls, ledger) -> None:
        """Install the admission quota ledger the fleet batch's device-
        side per-segment counters feed. Duck-typed: any object with
        ``ingest_device_counts(dict)``. Applies to live cores too."""
        cls._process_ledger = ledger
        for core in cls._instances.values():
            core.ledger = ledger

    def _publish_fleet_counts(self, seg_counts: np.ndarray) -> None:
        """Forward a collected fleet wire's per-segment live-row counts
        to the quota ledger, keyed by each owning section's
        ``fused_ledger_key()`` (sections without one don't account)."""
        ledger = self.ledger
        if ledger is None:
            return
        counts: dict[tuple, int] = {}
        released = []
        for seg, section in self._segments.items():
            if section.released:
                released.append(seg)
                continue
            if seg >= seg_counts.shape[0]:
                continue
            keyfn = getattr(section.owner, "fused_ledger_key", None)
            key = keyfn() if keyfn is not None else None
            if key is None:
                continue
            counts[key] = counts.get(key, 0) + int(seg_counts[seg])
        for seg in released:
            del self._segments[seg]
        if counts:
            ledger.ingest_device_counts(counts)
            REGISTRY.counter(
                "fused_fleet_ledger_updates_total",
                "device-side per-segment count batches forwarded to the "
                "quota ledger").inc()

    def _closed(self) -> bool:
        return self._started and self._refs == 0

    async def start(self) -> None:
        self._refs += 1
        if not self._started:
            self._started = True
            await self.controller.start()

    async def stop(self) -> None:
        if self._refs > 0:
            self._refs -= 1
        if self._refs > 0 or not self._started:
            return
        if self._stopping:
            # double-stop (or stop concurrent with an in-flight stop):
            # an idempotent no-op — wait for the first stop's drain so
            # every caller returns to a fully-drained core
            if self._stop_done is not None:
                await self._stop_done.wait()
            return
        self._stopping = True
        self._stop_done = asyncio.Event()
        try:
            # controller first: its shutdown drain runs the FINAL ticks,
            # and those submits append in-flight wires — draining
            # _inflight before the tick loop exits would strand (and
            # silently drop) the last window's patches (proven by the
            # pipeline shutdown/drain test)
            await self.controller.stop()
            if self._flush_task is not None:
                self._flush_task.cancel()
                self._flush_task = None
            await self._drain_inflight()
            # drop the registry entry so closed cores (and their device-
            # resident bucket state) do not accumulate across loops
            for k, v in list(FusedCore._instances.items()):
                if v is self:
                    del FusedCore._instances[k]
        finally:
            self._stop_done.set()

    # ------------------------------------------------------------ plumbing

    def bucket(self, slots: int) -> FusedBucket:
        b = self.buckets.get(slots)
        if b is None:
            b = FusedBucket(slots, self.device, mesh=self.mesh,
                            always_stamp=self.fleet_mode)
            self.buckets[slots] = b
        return b

    def register(self, owner: SectionOwner, slots: int) -> Section:
        section = self.bucket(slots).section(owner)
        # fleet segment id: stable for the section's lifetime; retired
        # ids are not reused (the capacity is pow2-padded and tiny)
        section.seg = self._next_seg
        self._segments[self._next_seg] = section
        self._next_seg += 1
        return section

    def register_placement(self, owner, p: int = 8,
                           slots: int = 64) -> FusedBucket:
        """Attach a placement owner (the deployment splitter) to the
        default bucket — its roots then ride the SAME fused step that
        serves the sync sections."""
        b = self.bucket(slots)
        b.register_placement(owner, p)
        return b

    def kick(self, bucket: FusedBucket) -> None:
        """Request a tick for a bucket dirtied outside the section path
        (placement staging)."""
        self.controller.queue.add(("__kick__", False, id(bucket), None))

    def enqueue(self, section: Section, side: bool, key) -> None:
        self.controller.enqueue((id(section.owner), side, key, section))

    def enqueue_many(self, section: Section, side: bool, keys) -> None:
        """Batch enqueue a churn/feedback key set (one queue crossing)."""
        oid = id(section.owner)
        self.controller.enqueue_many(
            [(oid, side, key, section) for key in keys])

    # ---------------------------------------------------------------- tick

    async def _process_batch(self, items: Sequence) -> list:
        # 1. encode touched keys (engines re-read their informer caches);
        #    section=None items are retick markers — their bucket is
        #    already marked stale and will re-run on this tick. Items
        #    whose section was released (engine stop or vocabulary
        #    migration) are stale: touching them would resurrect rows in
        #    the old bucket — drop them, the replacement section was
        #    re-enqueued with the same keys.
        t0 = time.perf_counter()
        # wall-clock tick anchor for convergence attribution: the engine
        # stamps which dispatch carried a traced row by pairing this with
        # its fused_apply callback time
        self.last_tick_start = time.time()
        # per key, remember WHICH side(s) this batch's events touched —
        # an informer event changes exactly one mirror side (the
        # reference's two controllers each watch one apiserver,
        # pkg/syncer/specsyncer.go:43-55 / statussyncer.go:29-39), so an
        # existing row ships only that side's wire entry; mask bit 1 = up,
        # bit 2 = down
        touched: dict[Section, dict] = {}
        for _oid, side, key, section in items:
            if section is not None and not section.released:
                km = touched.setdefault(section, {})
                km[key] = km.get(key, 0) | (2 if side else 1)
        for section, keymasks in touched.items():
            self._encode_section(section, keymasks)
        if touched:
            _phase("encode", time.perf_counter() - t0)

        # 2. one fused step per dirty bucket; collection is pipelined.
        #    Occupancy telemetry per submit: how deep the in-flight window
        #    already was (depth histogram) and whether this dispatch
        #    overlapped an executing step (the pipeline's whole point)
        inflight_by_bucket: dict[int, int] = {}
        for b, _w, _m in self._inflight:
            inflight_by_bucket[id(b)] = inflight_by_bucket.get(id(b), 0) + 1
        depth_h = REGISTRY.histogram(
            "fused_pipeline_depth",
            "in-flight steps per bucket at submit time",
            buckets=DEPTH_BUCKETS)
        # fleet mode: ONE ragged batch covers every dirty bucket — the
        # same pipelined window applies, with the fleet as the unit
        submitters = ((self._fleet,) if self._fleet is not None
                      else tuple(self.buckets.values()))
        for bucket in submitters:
            try:
                submitted = bucket.submit()
            except Exception as err:  # noqa: BLE001 — degraded-mode gate
                if self._recover_step_failure(bucket, err):
                    continue
                # surface loudly: a row-independent submit failure (bad
                # sharding, systemic device error) otherwise dies as 5
                # silent INFO-level retries
                log.exception("fused-core: %s submit failed "
                              "(B=%d S=%d device=%s)",
                              type(bucket).__name__, bucket.B, bucket.S,
                              bucket.device)
                raise
            if submitted is not None:
                wire, meta = submitted
                depth = inflight_by_bucket.get(id(bucket), 0)
                depth_h.observe(depth)
                if depth:
                    REGISTRY.counter(
                        "fused_pipeline_overlap_ticks_total",
                        "submits issued while a previous step was still "
                        "in flight (overlapped ticks)").inc()
                self._inflight.append((bucket, wire, meta))

        # 3. collect: per BUCKET, oldest in-flight wires beyond the
        #    pipeline window (blocking is fine by then — their data has
        #    had fetch_depth full ticks to land; serial mode, depth 0,
        #    collects everything including this tick's own wire). Depth
        #    is per bucket so one bucket's fresh wire never forces a
        #    zero-depth blocking collect of another's.
        #    (Collecting already-ready wires opportunistically here was
        #    rejected in the reference: on a synchronous backend every
        #    wire is instantly "ready", which serializes dispatch into
        #    the tick.)
        counts: dict[int, int] = {}
        for b, _w, _m in self._inflight:
            counts[id(b)] = counts.get(id(b), 0) + 1
        i = 0
        while i < len(self._inflight):
            b, w, m = self._inflight[i]
            if counts[id(b)] > self.fetch_depth:
                self._inflight.pop(i)
                counts[id(b)] -= 1
                self._collect(b, w, m)
            else:
                i += 1
        if self._inflight:
            self._schedule_flush()
        return []

    # ------------------------------------------------ degraded-mode path

    def _recover_step_failure(self, bucket, err: Exception) -> bool:
        """Survive a failed device step without stalling the bucket's
        co-tenants: retry once wholesale (full re-upload rebuilds the
        resident state from the host mirrors — the source of truth), and
        on a second consecutive failure bisect the submitted rows to
        quarantine the poison. ``bucket`` is a FusedBucket or the
        FleetBatch (whose bisection is segment-scoped and whose
        quarantine routes through the owning member bucket). Returns
        False when the failure is row-independent (the caller then
        propagates it)."""
        bucket.note_step_failure()
        REGISTRY.counter(
            "fused_step_failures_total",
            "fused device-step submissions that raised").inc()
        if bucket._step_failures == 1:
            log.warning("fused-core: device step failed (%s: %s); retrying "
                        "once with a full re-upload", type(err).__name__, err)
            bucket.mark_stale()
            self.controller.queue.add(("__retick__", False, id(bucket), None))
            return True
        suspects = list(bucket._last_rows)
        bad = bucket.bisect_poison(suspects)
        if bad is None:
            # even the empty probe fails: systemic. Propagate — but keep
            # the bucket dirty: the failed submit already consumed the
            # staged events and cleared _stale, so without this the
            # controller's retried items would find nothing to submit
            # and the bucket would wedge converged-looking forever
            bucket.mark_stale()
            return False
        for row in bad:
            key, section = bucket.quarantine_row(row)
            log.warning("fused-core: quarantined row %d (key=%r) after "
                        "repeated device-step failures", row, key)
            if key is not None and section is not None:
                self._requeue_quarantined(section, key)
        bucket._step_failures = 0
        bucket.mark_stale()
        self.controller.queue.add(("__retick__", False, id(bucket), None))
        return True

    def _requeue_quarantined(self, section: Section, key) -> None:
        """Hand a quarantined key back to its owner after a bounded
        exponential backoff — level-triggered recovery: if the poison was
        transient the re-staged row converges; if not, the next failing
        tick re-quarantines it at a longer (capped) delay."""
        qk = (id(section), key)
        n = self._quarantine_retries.get(qk, 0)
        self._quarantine_retries[qk] = n + 1
        delay = min(QUARANTINE_BASE_BACKOFF * (2 ** n), QUARANTINE_MAX_BACKOFF)
        REGISTRY.counter(
            "fused_quarantine_requeues_total",
            "quarantined keys scheduled for an owner requeue").inc()
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # no running loop (synchronous callers): the next owner event recovers

        def _requeue() -> None:
            if not section.released:
                self.enqueue(section, False, key)

        loop.call_later(delay, _requeue)

    def _encode_section(self, section: Section, keymasks: dict) -> None:
        bucket = section.bucket
        keys = list(keymasks)
        # a key new to the bucket must initialize BOTH device mirror
        # sides; an existing row ships only the side(s) its events touched
        masks = np.fromiter(
            (keymasks[k] | (0 if k in section.rows else 3) for k in keys),
            np.uint8, len(keys))
        many = getattr(section.owner, "fused_encode_many", None)
        try:
            if many is not None:
                up_v, up_e, down_v, down_e = many(keys)
            else:
                ups, upes, downs, downes = [], [], [], []
                for key in keys:
                    u, ue, dv, de = section.owner.fused_encode(key)
                    ups.append(u)
                    upes.append(ue)
                    downs.append(dv)
                    downes.append(de)
                try:
                    up_v, down_v = np.stack(ups), np.stack(downs)
                except ValueError:
                    # ragged widths (an engine mid-vocabulary-migration):
                    # per-key slow path, both sides as before
                    for key, u, ue, dv, de in zip(keys, ups, upes, downs,
                                                  downes):
                        row = section.row_for(key)
                        bucket.stage(row, False, u, ue)
                        bucket.stage(row, True, dv, de)
                    section.refresh_mask()
                    return
                up_e = np.asarray(upes, bool)
                down_e = np.asarray(downes, bool)
        except BucketOverflow:
            # engine's vocabulary outgrew this bucket: the engine
            # re-registers in a larger bucket and replays its rows
            section.owner.fused_overflow()
            return
        rows = np.fromiter((section.row_for(k) for k in keys),
                           np.int64, len(keys))
        up_v, up_e = np.asarray(up_v), np.asarray(up_e)
        down_v, down_e = np.asarray(down_v), np.asarray(down_e)
        up_sel = (masks & 1) != 0
        if up_sel.all():
            bucket.stage_many(rows, False, up_v, up_e)
        elif up_sel.any():
            bucket.stage_many(rows[up_sel], False, up_v[up_sel], up_e[up_sel])
        down_sel = (masks & 2) != 0
        if down_sel.all():
            bucket.stage_many(rows, True, down_v, down_e)
        elif down_sel.any():
            bucket.stage_many(rows[down_sel], True, down_v[down_sel],
                              down_e[down_sel])
        section.refresh_mask()

    def _collect(self, bucket: FusedBucket, wire: HostWire,
                 meta: tuple) -> None:
        t0 = time.perf_counter()
        # fetch blocks ONLY on the compact wire (its host copy was issued
        # at dispatch) — never on the resident state. The
        # ready split is the pipeline-occupancy answer: a blocked fetch
        # means the host outran the device by the full window.
        try:
            ready = bool(wire.is_ready())
        except AttributeError:  # plain ndarray in tests
            ready = True
        REGISTRY.counter(
            "fused_collect_ready_total" if ready
            else "fused_collect_blocked_total",
            "fetches that found the wire already on host (ready) vs had "
            "to wait for the device (blocked)").inc()
        host_wire = np.asarray(wire)
        t1 = time.perf_counter()
        overflow = bucket.dispatch(host_wire, meta)
        _phase("collect_wait", t1 - t0)
        _phase("dispatch", time.perf_counter() - t1)
        if overflow:
            # level-triggered: re-run the bucket with doubled capacity
            bucket.mark_stale()
            self.controller.queue.add(("__retick__", False, id(bucket), None))

    def _schedule_flush(self) -> None:
        if self._flush_task is not None:
            self._flush_task.cancel()
        self._flush_task = asyncio.create_task(self._idle_flush())

    async def _idle_flush(self) -> None:
        """Collect in-flight wires off the tick path.

        On the card (asynchronous), this polls ``wire.is_ready()``
        between ticks and collects the moment the device finishes —
        patches apply ~one device round trip after dispatch instead of
        waiting for the NEXT tick's depth-based collect (about a full
        tick of convergence latency under continuous load), and it never
        blocks a submit because only ready wires are popped. On the
        synchronous CPU every wire is instantly "ready", so eager
        collection would serialize dispatch into the loop — there, keep
        the original behavior: only
        collect once the loop has been quiet for IDLE_FLUSH_S (without
        which the last tick's patches would wait for the next informer
        event)."""
        if self._eager_collect is None:
            self._eager_collect = self.device.type != "cpu"
        try:
            if not self._eager_collect:
                await asyncio.sleep(IDLE_FLUSH_S)
            while self._inflight:
                bucket, wire, meta = self._inflight[0]
                # exponential poll backoff, capped at 8 ms so a ready
                # wire is still collected promptly
                poll = 0.001
                while not wire.is_ready():
                    await asyncio.sleep(poll)
                    poll = min(poll * 2, 0.008)
                # the head can change across the awaits (a tick's depth-
                # based collect pops it, and a collect failure means
                # _schedule_flush never cancelled this task) — pop only
                # the wire this iteration actually inspected
                if not self._inflight or self._inflight[0][1] is not wire:
                    continue
                self._inflight.pop(0)
                self._collect(bucket, wire, meta)
        except asyncio.CancelledError:
            pass

    async def _drain_inflight(self) -> None:
        while self._inflight:
            self._collect(*self._inflight.pop(0))
