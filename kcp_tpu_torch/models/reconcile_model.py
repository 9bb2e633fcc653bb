"""The flagship device program: one fused reconcile step for the fleet
(the port of ``kcp_tpu.models.reconcile_model``).

One step runs the whole control plane's decision math over resident
tensors:

  1. scatter the tick's informer deltas into the resident mirrors
  2. spec/status three-way diff over every row        (syncer lanes)
  3. replica placement over every root deployment      (splitter lane)
  4. label-selector fan-out over every object x cluster (informer lane)
  5. global convergence statistics

Lanes 2 and 4 always go through ``decide_and_match``: the hand-written
CUDA kernel on the card, its plain PyTorch version on the CPU. On the
card the packed step's wire side lanes (segment stamps, the acks copy,
mask stamps) and its delta scatters are two launches of ``wire_scatter``,
read straight off the wire; on the CPU they are the drop-mode scatters of
``ops.diff``, which stay the path the reference is checked against.

On the unsharded path each stage is an ``obs.span`` (``step.stamps``,
``step.scatter``, ``step.decide_match``, ``step.splitter``,
``step.stats``, ``step.compact``, ``step.wire``): a child of the
caller's ``step.dispatch`` when its tick is traced, one context-variable
read when it is not. They time the host's launches, not the device.

On a mesh (``mesh=``) the state is a ReconcileState of
:class:`~kcp_tpu_torch.parallel.mesh.ShardedTensor` (``shard_state``):
the wire is unpacked once on the mesh's lead device, each row shard
applies the entries whose rows it owns (drop-mode scatters drop the rest)
and runs the kernel and the placement lane over its own rows on its own
device, and the quantities that cross shards — match counts, stats,
per-segment counts, patch and placement compaction — are reduced on the
lead device. On a mesh whose ``hosts`` axis spans the processes of a
``torch.distributed`` group, each process runs only its own row shards
and those reductions go through collectives on the group
(``parallel.mesh.all_sum``, ``gather_blocks``), so that every process
assembles the same wire. The wire is byte-equal to the unsharded step's.

Where the reference donates its state to a jitted step, this port
updates the resident mirrors IN PLACE: ``up_vals``/``up_exists``/
``down_vals``/``down_exists``, a per-row ``status_mask`` and the fleet's
``seg_ids`` are written by the step, and the returned state (same
tensors, plus the new ``current`` placement) is the one to keep. A
caller that must keep its input intact (the poison-row probe) passes
clones. ``uint32`` lanes are ``int32`` bit views; every count, index and
wire word is ``int32``; nothing in a step waits for the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import obs
from ..ops.cuda_kernels import decide_and_match, decide_and_match_shards, wire_scatter
from ..ops.diff import (
    DECISION_NOOP,
    apply_deltas,
    compact_patches,
    first_true,
    scatter_rows_drop,
)
from ..ops.placement import placement_changed, split_replicas
from ..parallel.mesh import FLAGS, ShardedTensor, all_sum, gather_blocks, row_factor, shard_state
from ..utils.device import resolve_device


class ReconcileState(NamedTuple):
    """Resident control-plane state (one schema bucket, or the fleet).

    B = object rows (all tenants), S = slot columns, R = root deployments,
    P = physical clusters, L = label slots, C = cluster selectors.
    """

    up_vals: torch.Tensor  # int32 view of uint32 [B, S]
    up_exists: torch.Tensor  # bool [B]
    down_vals: torch.Tensor  # int32 view of uint32 [B, S]
    down_exists: torch.Tensor  # bool [B]
    status_mask: torch.Tensor  # bool [S] (bucket-wide) or [B, S] (per-row)
    replicas: torch.Tensor  # int32 [R]
    avail: torch.Tensor  # bool [R, P]
    current: torch.Tensor  # int32 [R, P] currently-applied leaf replicas
    pair_hashes: torch.Tensor  # int32 view of uint32 [B, L]
    sel_hashes: torch.Tensor  # int32 view of uint32 [C]


class ReconcileDeltas(NamedTuple):
    """One tick's informer deltas, padded to a fixed D. Single-sided: one
    payload column per row, routed by ``side``."""

    idx: torch.Tensor  # int32 [D] row indices
    vals: torch.Tensor  # int32 view of uint32 [D, S] (ignored for deletes)
    exists: torch.Tensor  # bool [D] False = delete event
    side: torch.Tensor  # bool [D] False = upstream mirror, True = downstream
    valid: torch.Tensor  # bool [D] padding mask


class ReconcileOutputs(NamedTuple):
    # compact lanes — the only thing the host applier fetches each tick
    patch_idx: torch.Tensor  # int32 [K] actionable row indices (pad = B)
    patch_code: torch.Tensor  # uint8 [K] decision per patch row
    patch_upsync: torch.Tensor  # bool [K] status-upsync flag per patch row
    patch_count: torch.Tensor  # int32 [] valid patch rows
    patch_overflow: torch.Tensor  # bool [] > K rows actionable this tick
    stats: torch.Tensor  # int32 [8] global counters (see STATS_FIELDS)
    # full lanes — stay resident; fetched only by tests/debugging
    decision: torch.Tensor  # uint8 [B] NOOP/CREATE/UPDATE/DELETE
    status_upsync: torch.Tensor  # bool [B]
    leaf_replicas: torch.Tensor  # int32 [R, P] desired placement
    placement_dirty: torch.Tensor  # bool [R]
    match_counts: torch.Tensor  # int32 [C] objects matched per cluster selector


STATS_FIELDS = (
    "rows", "creates", "updates", "deletes", "upsyncs",
    "placement_dirty", "matched", "applied_deltas",
)


def _sharded(state: ReconcileState, mesh) -> None:
    if not isinstance(state.up_vals, ShardedTensor) or state.up_vals.mesh != mesh:
        raise TypeError("a step with mesh= takes a state sharded over that mesh "
                        "(parallel.mesh.shard_state)")


def reconcile_step(state: ReconcileState, deltas: ReconcileDeltas,
                   patch_capacity: int = 8192, mesh=None,
                   ) -> tuple[ReconcileState, ReconcileOutputs]:
    """One fused step. Updates the state's mirrors in place (see the
    module docstring) and returns (new state, outputs). With ``mesh=``
    the state is sharded and the full lanes of the outputs come back
    whole on the mesh's lead device."""
    if mesh is not None:
        _sharded(state, mesh)
        sh = _step_sharded(state, deltas, patch_capacity)
        return sh.state, sh.outputs()
    new_state, outputs, _seg = _step(state, deltas, patch_capacity)
    return new_state, outputs


def _step(state: ReconcileState, deltas: ReconcileDeltas | torch.Tensor,
          patch_capacity: int, seg_ids: torch.Tensor | None = None,
          seg_capacity: int = 8,
          ) -> tuple[ReconcileState, ReconcileOutputs, torch.Tensor | None]:
    """The unsharded step; with ``seg_ids`` the kernel's fleet form also
    gives the per-segment live-row counts (else None). ``deltas`` is a
    ReconcileDeltas, or on the card the packed wire itself, whose delta
    entries one ``wire_scatter`` launch applies."""
    i32 = torch.int32
    # 1. scatter deltas, routed by side (apply_deltas owns the padding-
    #    drop and unique-index contract)
    with obs.span("step.scatter"):
        if isinstance(deltas, torch.Tensor):
            applied = wire_scatter("deltas", deltas, state.up_vals, state.up_exists,
                                   state.down_vals, state.down_exists)[0]
            up_vals, up_exists = state.up_vals, state.up_exists
            down_vals, down_exists = state.down_vals, state.down_exists
        else:
            applied = None
            up_vals, up_exists = apply_deltas(
                state.up_vals, state.up_exists, deltas.idx,
                deltas.vals, deltas.exists, deltas.valid & ~deltas.side)
            down_vals, down_exists = apply_deltas(
                state.down_vals, state.down_exists, deltas.idx,
                deltas.vals, deltas.exists, deltas.valid & deltas.side)

    # 2+4. decision lanes and fan-out counts in one pass (only resident
    #      upstream objects fan out); the fleet form adds the per-segment
    #      live-row counts of the scattered state
    with obs.span("step.decide_match"):
        lanes = decide_and_match(
            up_vals, up_exists, down_vals, down_exists, state.status_mask,
            state.pair_hashes, state.sel_hashes, seg_ids,
            None if seg_ids is None else seg_capacity)
    decision, status_upsync, match_counts = lanes[:3]

    # 3. splitter lane
    with obs.span("step.splitter"):
        leaf = split_replicas(state.replicas, state.avail)
        p_dirty = placement_changed(state.current, leaf)

    # 5. global stats
    with obs.span("step.stats"):
        stats = torch.stack([
            up_exists.sum(dtype=i32),
            (decision == 1).sum(dtype=i32),
            (decision == 2).sum(dtype=i32),
            (decision == 3).sum(dtype=i32),
            status_upsync.sum(dtype=i32),
            p_dirty.sum(dtype=i32),
            match_counts.sum(dtype=i32),
            deltas.valid.sum(dtype=i32) if applied is None else applied,
        ])

    new_state = state._replace(current=leaf)
    with obs.span("step.compact"):
        patches = compact_patches(decision, status_upsync, patch_capacity)
    outputs = ReconcileOutputs(
        patch_idx=patches.idx, patch_code=patches.code,
        patch_upsync=patches.upsync, patch_count=patches.count,
        patch_overflow=patches.overflow,
        decision=decision, status_upsync=status_upsync,
        leaf_replicas=leaf, placement_dirty=p_dirty,
        match_counts=match_counts, stats=stats,
    )
    return new_state, outputs, (lanes[3] if seg_ids is not None else None)


# ---------------------------------------------------------------------------
# Packed wire format — one array per direction across the host<->device
# link, byte-for-byte the reference's. Patch entries carry row index (20
# bits), decision code (2 bits, bit 20-21) and the status-upsync flag
# (bit 23).
#
# Wire layout (int32):
#   [0]                 patch count
#   [1]                 patch overflow flag
#   [2:10]              stats
#   [10]                placement-dirty count
#   [PACK_HDR : +K]     packed patch entries (K = patch_capacity)
#   [PACK_HDR+K : +R*(1+P)]  placement entries: R rows of (root row index
#                       or R for padding, P leaf counts), dirty roots first
#   fleet wires only: seg_capacity per-segment live-row counts
# ---------------------------------------------------------------------------

PACK_HDR = 16  # int32 slots ahead of the packed patch entries
PACK_IDX_MASK = (1 << 20) - 1
PACK_CODE_SHIFT = 20
PACK_UPSYNC_BIT = 1 << 23
PACK_PLACEMENT_COUNT = 10  # hdr slot carrying the placement-dirty count
MASK_STAMP_BIT = 8  # flag: entry carries a status-mask row, not a delta


def pack_deltas(deltas) -> np.ndarray:
    """Host-side: pack a (numpy) delta batch into one uint32 [D, S+2] array."""
    d = np.asarray(deltas.vals).shape[0]
    flags = (
        np.asarray(deltas.exists).astype(np.uint32)
        | (np.asarray(deltas.side).astype(np.uint32) << 1)
        | (np.asarray(deltas.valid).astype(np.uint32) << 2)
    )
    return np.concatenate(
        [
            np.asarray(deltas.vals),
            np.asarray(deltas.idx).astype(np.uint32).reshape(d, 1),
            flags.reshape(d, 1),
        ],
        axis=1,
    )


def unpack_deltas(packed: torch.Tensor) -> ReconcileDeltas:
    """Device-side: unpack the int32 view of the uint32 [D, S+2] wire.
    Mask-stamp entries (flag bit 8) are excluded from ``valid`` and
    consumed by :func:`apply_mask_stamps`."""
    s = packed.shape[1] - 2
    flags = packed[:, s + 1]
    return ReconcileDeltas(
        idx=packed[:, s],
        vals=packed[:, :s],
        exists=(flags & 1) != 0,
        side=(flags & 2) != 0,
        valid=((flags & 4) != 0) & ((flags & MASK_STAMP_BIT) == 0),
    )


def _stamp_rows(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(selected, row index, flags) of the wire's MASK_STAMP entries."""
    s = packed.shape[1] - 2
    flags = packed[:, s + 1]
    sel = ((flags & 4) != 0) & ((flags & MASK_STAMP_BIT) != 0)
    return sel, packed[:, s], flags


def apply_mask_stamps(status_mask: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """Scatter mask-stamp entries into the per-row status mask, in place.

    A row allocated after its bucket's last full upload has a host-side
    mask stamp the device never saw; the stamp rides the packed wire as
    a flag-bit-8 entry whose vals columns are the bool mask row."""
    if status_mask.ndim != 2:
        return status_mask  # bucket-wide [S] masks have no per-row lane
    sel, idx, _flags = _stamp_rows(packed)
    s = packed.shape[1] - 2
    scatter_rows_drop(status_mask, idx, packed[:, :s] != 0, sel)
    return status_mask


def apply_side_lanes_plain(state: ReconcileState, packed: torch.Tensor,
                           acks: torch.Tensor | None = None,
                           seg_ids: torch.Tensor | None = None) -> None:
    """The wire's side lanes as torch scatters, in place, in the step's
    order: the segment stamps into ``seg_ids``, the acks copy (each acked
    row's down mirror becomes its up mirror), the mask stamps. The packed
    step's CPU path; on the card ``wire_scatter("stamps", ...)`` does the
    same in one launch."""
    b = state.up_vals.shape[0]
    if seg_ids is not None:
        apply_seg_stamps(seg_ids, packed)
    if acks is not None and b > 0:
        # padding (-1) must not scatter AT ALL: scatter_rows_drop routes
        # it to a no-op write instead of clipping it onto row 0
        valid = (acks >= 0) & (acks < b)
        gather = acks.clamp(0, b - 1).long()
        scatter_rows_drop(state.down_vals, acks, state.up_vals[gather], valid)
        scatter_rows_drop(state.down_exists, acks, state.up_exists[gather], valid)
    apply_mask_stamps(state.status_mask, packed)


def reconcile_step_packed(state: ReconcileState, packed: torch.Tensor,
                          acks: torch.Tensor | None = None,
                          patch_capacity: int = 8192, mesh=None,
                          seg_ids: torch.Tensor | None = None,
                          seg_capacity: int = 8,
                          ) -> tuple[ReconcileState, torch.Tensor]:
    """The wire-format step: one int32 [D, S+2] array in (a bit view of
    the uint32 wire), one int32 array out.

    ``acks`` is the converged-row compression lane: int32 row indices
    (negative = padding) whose downstream mirror becomes a copy of the
    resident upstream mirror; the copy runs before the delta scatter.

    With ``seg_ids`` (the fleet's row->segment lane, a ShardedTensor on a
    mesh, whose step stamps each shard's block itself) the wire's segment
    stamps are scattered into it, in place, and the wire grows the tail of
    ``seg_capacity`` per-segment live-row counts, from the kernel's fleet
    form."""
    b = state.up_vals.shape[0]
    if b > PACK_IDX_MASK + 1:
        raise ValueError(
            f"packed patch entries hold 20-bit row indices; B={b} exceeds "
            f"{PACK_IDX_MASK + 1} — shard the bucket or use the unpacked "
            f"ReconcileOutputs lanes")
    if mesh is not None:
        _sharded(state, mesh)
        sh = _step_sharded(state, unpack_deltas(packed.to(mesh.lead)),
                           patch_capacity, packed=packed, acks=acks,
                           seg_ids=seg_ids, seg_capacity=seg_capacity)
        wire = sh.wire()
        return sh.state, wire if seg_ids is None else torch.cat([wire, sh.seg_counts])
    # the wire's side lanes first: the fleet's segment stamps, the acks
    # copy, the mask stamps. On the card one wire_scatter launch, and the
    # delta lanes stay on the wire for the step's second launch; on the
    # CPU the torch scatters, and the delta lanes unpacked
    with obs.span("step.stamps"):
        if state.up_vals.device.type == "cuda":
            wire_scatter("stamps", packed, state.up_vals, state.up_exists, state.down_vals,
                         state.down_exists, state.status_mask, seg_ids, acks)
            deltas = packed
        else:
            apply_side_lanes_plain(state, packed, acks, seg_ids)
            deltas = unpack_deltas(packed)
    new_state, out, seg_counts = _step(state, deltas, patch_capacity, seg_ids, seg_capacity)
    with obs.span("step.wire"):
        wire = _pack_wire(out.patch_idx, out.patch_code, out.patch_upsync,
                          out.patch_count, out.patch_overflow, out.stats,
                          out.placement_dirty, out.leaf_replicas)
        if seg_counts is not None:
            wire = torch.cat([wire, seg_counts])
    return new_state, wire


def _pack_wire(patch_idx, patch_code, patch_upsync, patch_count, patch_overflow,
               stats, dirty, leaf) -> torch.Tensor:
    """The int32 wire from the step's compact lanes (layout above)."""
    i32 = torch.int32
    upsync_bit = torch.where(patch_upsync, PACK_UPSYNC_BIT, 0).to(i32)
    entries = patch_idx | (patch_code.to(i32) << PACK_CODE_SHIFT) | upsync_bit
    # placement segment: dirty roots compacted first, each carrying its
    # P leaf counts (the deployment splitter's serving lane)
    r = dirty.shape[0]
    pidx = first_true(dirty, r)
    safe = pidx.clamp(max=r - 1).long()
    counts = torch.where((pidx < r)[:, None], leaf[safe], 0).to(i32)
    pl_entries = torch.cat([pidx[:, None], counts], dim=1).reshape(-1)
    hdr = torch.cat([
        patch_count.view(1),
        patch_overflow.to(i32).view(1),
        stats,
        dirty.sum(dtype=i32).view(1),
        torch.zeros(PACK_HDR - 11, dtype=i32, device=stats.device),
    ])
    return torch.cat([hdr, entries, pl_entries])


# ---------------------------------------------------------------------------
# Fleet lane — cross-bucket ragged batching (syncer/core.py FleetBatch).
# Each fleet row carries a segment id (its owning section) in a resident
# int32 [B] lane. Rows allocated after the last full upload learn theirs
# from their MASK_STAMP entry (flag bits 8..23); the step ends with a
# per-segment count of live upstream rows on the wire tail.
# ---------------------------------------------------------------------------

SEG_SHIFT = 8  # mask-stamp flag bits [8..23] carry the row's segment id
SEG_FIELD_MASK = 0xFFFF
# unowned/freed rows: always >= any real segment capacity, so the
# counter scatter drops them
SEG_NONE = 0xFFFF


def apply_seg_stamps(seg_ids: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """Scatter segment-id stamps from MASK_STAMP entries into the
    resident row->segment lane, in place."""
    sel, idx, flags = _stamp_rows(packed)
    seg = (flags >> SEG_SHIFT) & SEG_FIELD_MASK
    scatter_rows_drop(seg_ids, idx, seg, sel)
    return seg_ids


def reconcile_step_fleet(state: ReconcileState, seg_ids: torch.Tensor,
                         packed: torch.Tensor, acks: torch.Tensor | None = None,
                         patch_capacity: int = 8192, seg_capacity: int = 8,
                         mesh=None,
                         ) -> tuple[ReconcileState, torch.Tensor, torch.Tensor]:
    """:func:`reconcile_step_packed` plus the resident segment lane and
    the per-segment live-row counters on the wire tail, which the kernel's
    fleet form counts in the same pass as the decisions. Out-of-range
    segment ids (padding, unowned rows) drop out of the count. With
    ``mesh=``, ``seg_ids`` is a row-sharded ShardedTensor like the
    state's flags."""
    new_state, wire = reconcile_step_packed(state, packed, acks, patch_capacity,
                                            mesh=mesh, seg_ids=seg_ids,
                                            seg_capacity=seg_capacity)
    return new_state, seg_ids, wire


def unpack_seg_counts(wire: np.ndarray, patch_capacity: int, r: int, p: int,
                      seg_capacity: int) -> np.ndarray:
    """Host-side: the per-segment live-row counts from a fleet wire."""
    off = PACK_HDR + patch_capacity + r * (1 + p)
    return wire[off:off + seg_capacity]


def unpack_patches(wire: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray, bool, np.ndarray]:
    """Host-side: (idx, code, upsync, overflow, stats) from the wire array."""
    count = int(wire[0])
    entries = wire[PACK_HDR:PACK_HDR + count]
    return (
        entries & PACK_IDX_MASK,
        (entries >> PACK_CODE_SHIFT) & 3,
        (entries & PACK_UPSYNC_BIT) != 0,
        bool(wire[1]),
        wire[2:10],
    )


def unpack_placement(wire: np.ndarray, patch_capacity: int, p: int,
                     r: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Host-side: (dirty root row indices [N], leaf counts [N, P]) from the
    wire's placement segment; ``r`` bounds it for fleet wires."""
    n = int(wire[PACK_PLACEMENT_COUNT])
    seg = wire[PACK_HDR + patch_capacity:]
    if r is not None:
        seg = seg[:r * (1 + p)]
    seg = seg.reshape(-1, 1 + p)
    return seg[:n, 0], seg[:n, 1:]


# ---------------------------------------------------------------------------
# Host <-> device staging
# ---------------------------------------------------------------------------


class WireBuffers:
    """Double-buffered host staging for the packed-delta wire.

    ``acquire`` hands out the least-recently-used (packed, acks) pair as
    numpy views (``uint32 [d, width]`` zeroed, ``int32 [ack_capacity]``
    filled with -1). On the card the buffers are pinned, :meth:`upload`
    copies them without blocking and records an event, and the slot's
    next ``acquire`` waits on that event — only if the pipeline ran ahead
    of the copy engine (``reuse_waits`` counts those). On the CPU the
    step reads the host buffers directly and synchronously.
    """

    def __init__(self, depth: int = 2, device: torch.device | None = None):
        self.depth = depth
        self.device = torch.device("cpu") if device is None else device
        self._pin = self.device.type == "cuda"
        self._packed: list[torch.Tensor | None] = [None] * depth
        self._acks: list[torch.Tensor | None] = [None] * depth
        self._pending: list = [None] * depth  # torch.cuda.Event per slot
        self._i = 0
        self.reuse_waits = 0

    def acquire(self, d: int, width: int,
                ack_capacity: int) -> tuple[int, np.ndarray, np.ndarray]:
        i = self._i
        self._i = (i + 1) % self.depth
        ev = self._pending[i]
        if ev is not None:
            self._pending[i] = None
            if not ev.query():
                self.reuse_waits += 1
                ev.synchronize()
        packed = self._packed[i]
        if packed is None or tuple(packed.shape) != (d, width):
            packed = self._packed[i] = torch.zeros(
                (d, width), dtype=torch.int32, pin_memory=self._pin)
        else:
            packed.zero_()
        acks = self._acks[i]
        if acks is None or tuple(acks.shape) != (ack_capacity,):
            acks = self._acks[i] = torch.full(
                (ack_capacity,), -1, dtype=torch.int32, pin_memory=self._pin)
        else:
            acks.fill_(-1)
        return i, packed.numpy().view(np.uint32), acks.numpy()

    def upload(self, slot: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The slot's (packed int32, acks) on the device."""
        packed, acks = self._packed[slot], self._acks[slot]
        if not self._pin:
            return packed, acks
        packed_d = packed.to(self.device, non_blocking=True)
        acks_d = acks.to(self.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self._pending[slot] = ev
        return packed_d, acks_d


class HostWire:
    """A device wire on its way to the host: a non-blocking copy into
    pinned memory plus an event (``copy_to_host_async`` in the
    reference). On a mesh, ``devices`` are the shard devices: an event on
    each of their streams marks the whole sharded step done. ``is_ready``
    polls the events; ``np.asarray`` waits on them."""

    def __init__(self, wire: torch.Tensor, devices=()):
        self._events = []
        if wire.device.type == "cpu":
            self._host = wire
        else:
            self._host = torch.empty(wire.shape, dtype=wire.dtype, pin_memory=True)
            self._host.copy_(wire, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(wire.device))
            self._events.append(ev)
        for dev in devices:
            if dev.type == "cuda" and dev != wire.device:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                self._events.append(ev)

    def is_ready(self) -> bool:
        return all(ev.query() for ev in self._events)

    def __array__(self, dtype=None, copy=None):
        for ev in self._events:
            ev.synchronize()
        arr = self._host.numpy()
        return arr if dtype is None else arr.astype(dtype)


def to_device(a, device: torch.device) -> torch.Tensor:
    """One host array on ``device`` as a copy (uint32 as an int32 bit view)."""
    arr = np.ascontiguousarray(np.asarray(a))
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(arr).to(device, copy=True)


def state_from_numpy(state, device=None) -> ReconcileState:
    """A reference ``ReconcileState`` of numpy arrays (``example_state``,
    a bucket's host mirrors) as the port's tensors on ``device`` (default
    the card): uint32 lanes become int32 bit views, everything is copied."""
    dev = resolve_device(device)
    return ReconcileState(*(to_device(a, dev) for a in state))


def deltas_from_numpy(deltas, device=None) -> ReconcileDeltas:
    """A numpy delta batch (``example_deltas``) as tensors on ``device``."""
    dev = resolve_device(device)
    return ReconcileDeltas(*(to_device(a, dev) for a in deltas))


def wire_to_numpy(wire: torch.Tensor) -> np.ndarray:
    """The int32 wire as host numpy (the bytes the reference's wire holds)."""
    return wire.cpu().numpy()


def example_state(
    b: int = 8192, s: int = 64, r: int = 1024, p: int = 8, l: int = 8, c: int = 64,
    seed: int = 0, dirty_frac: float = 0.01,
) -> ReconcileState:
    """A synthetic populated state as host numpy (the reference's
    generator, seed for seed); :func:`state_from_numpy` moves it."""
    rng = np.random.default_rng(seed)
    up = rng.integers(1, 2**32, size=(b, s), dtype=np.uint32)
    down = up.copy()
    flip = rng.random(b) < dirty_frac
    down[flip, :1] ^= 1
    status_mask = np.zeros(s, bool)
    status_mask[-max(1, s // 8):] = True
    return ReconcileState(
        up_vals=up,
        up_exists=np.ones(b, bool),
        down_vals=down,
        down_exists=np.ones(b, bool),
        status_mask=status_mask,
        replicas=rng.integers(0, 100, size=r).astype(np.int32),
        avail=rng.random((r, p)) < 0.9,
        current=np.zeros((r, p), np.int32),
        pair_hashes=rng.integers(1, 2**32, size=(b, l), dtype=np.uint32),
        sel_hashes=rng.integers(1, 2**32, size=c, dtype=np.uint32),
    )


def example_deltas(b: int = 8192, s: int = 64, d: int = 256, seed: int = 1) -> ReconcileDeltas:
    """A synthetic delta batch as host numpy, unique indices (the
    apply_deltas contract)."""
    rng = np.random.default_rng(seed)
    return ReconcileDeltas(
        idx=rng.permutation(b)[:d].astype(np.int32),
        vals=rng.integers(1, 2**32, size=(d, s), dtype=np.uint32),
        exists=np.ones(d, bool),
        side=rng.random(d) < 0.5,
        valid=rng.random(d) < 0.9,
    )


class ReconcileModel:
    """Convenience wrapper holding the resident state and the step."""

    def __init__(self, state, device=None, mesh=None):
        self.mesh = mesh
        if mesh is not None:
            self.device = mesh.lead
            self.state = shard_state(state, mesh)
        else:
            self.device = resolve_device(device)
            self.state = state_from_numpy(state, self.device)

    def step(self, deltas) -> ReconcileOutputs:
        if not isinstance(deltas.idx, torch.Tensor):
            deltas = deltas_from_numpy(deltas, self.device)
        self.state, out = reconcile_step(self.state, deltas, mesh=self.mesh)
        return out


# ---------------------------------------------------------------------------
# The sharded step. Row-local work runs per row shard on its device; what
# crosses shards is reduced on the mesh's lead device (and, across the
# processes of a multi-process mesh, through collectives on the group).
# ---------------------------------------------------------------------------


def _localize(idx: torch.Tensor, valid: torch.Tensor, lo: int, n: int,
              b: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Global row indices -> (this shard's local indices, entries that
    land in it). Negative indices count from the end of the whole B
    first, as the unsharded scatter normalizes them."""
    idx = idx.to(torch.int32)
    loc = torch.where(idx < 0, idx + b, idx) - lo
    return loc, valid & (loc >= 0) & (loc < n)


class _Sharded(NamedTuple):
    """What one sharded step leaves on the lead device (and per local
    row shard)."""

    state: ReconcileState
    patch_idx: torch.Tensor
    patch_code: torch.Tensor
    patch_upsync: torch.Tensor
    patch_count: torch.Tensor
    patch_overflow: torch.Tensor
    stats: torch.Tensor
    decisions: list  # per local row shard, on its device
    upsyncs: list
    leaf: torch.Tensor  # whole [R, P] on the lead
    dirty: torch.Tensor  # whole [R] on the lead
    match_counts: torch.Tensor
    seg_counts: torch.Tensor | None

    def wire(self) -> torch.Tensor:
        return _pack_wire(self.patch_idx, self.patch_code, self.patch_upsync,
                          self.patch_count, self.patch_overflow, self.stats,
                          self.dirty, self.leaf)

    def outputs(self) -> ReconcileOutputs:
        lead = self.stats.device
        mesh = self.state.up_vals.mesh
        rows = gather_blocks(mesh, {i: (d.to(lead), u.to(lead)) for i, d, u in zip(
            mesh.local_rows, self.decisions, self.upsyncs)},
            [hi - lo for lo, hi in self.state.up_vals.bounds])
        return ReconcileOutputs(
            patch_idx=self.patch_idx, patch_code=self.patch_code,
            patch_upsync=self.patch_upsync, patch_count=self.patch_count,
            patch_overflow=self.patch_overflow, stats=self.stats,
            decision=torch.cat([r[0] for r in rows]),
            status_upsync=torch.cat([r[1] for r in rows]),
            leaf_replicas=self.leaf, placement_dirty=self.dirty,
            match_counts=self.match_counts)


def _step_sharded(state: ReconcileState, deltas: ReconcileDeltas,
                  patch_capacity: int, packed: torch.Tensor | None = None,
                  acks: torch.Tensor | None = None,
                  seg_ids: ShardedTensor | None = None,
                  seg_capacity: int = 8) -> _Sharded:
    """The step over a sharded state, in the unsharded step's order per
    shard: segment stamps, acks copy, mask stamps, delta scatter, kernel,
    placement, local compaction. Updates every local shard in place.

    Rows split unevenly when B does not divide by the row factor
    (``parallel.mesh.row_bounds``): the step never pads, so any B gives
    the unsharded answer. On a multi-process mesh every process calls it
    with the same wire and runs its own row shards (``mesh.local_rows``);
    the counts, stats, placement lanes and patch candidates of the others
    arrive through the group's collectives, in the same order on every
    process."""
    mesh = state.up_vals.mesh
    lead = mesh.lead
    i32 = torch.int32
    b, s = state.up_vals.shape
    k = patch_capacity
    per_row = state.status_mask.ndim == 2
    n_valid = deltas.valid.sum(dtype=i32)
    kernel_in, currents = [], [None] * row_factor(mesh)
    for i in mesh.local_rows:
        lo, hi = state.up_vals.bounds[i]
        n = hi - lo
        dev = mesh.grid[i][0]
        up = state.up_vals.row_block(i)
        down = state.down_vals.row_block(i)
        mask = state.status_mask.row_block(i)
        up_ex = state.up_exists.blocks[i][0]
        down_ex = state.down_exists.blocks[i][0]
        if n:
            d = ReconcileDeltas(*(t.to(dev) for t in deltas))
            if packed is not None:
                pk = packed.to(dev)
                sel, idx, flags = _stamp_rows(pk)
                loc, ok = _localize(idx, sel, lo, n, b)
                if seg_ids is not None:
                    scatter_rows_drop(seg_ids.blocks[i][0], loc,
                                      (flags >> SEG_SHIFT) & SEG_FIELD_MASK, ok)
                if acks is not None:
                    ak = acks.to(dev)
                    aloc, aok = _localize(ak, (ak >= 0) & (ak < b), lo, n, b)
                    gather = aloc.clamp(0, n - 1).long()
                    scatter_rows_drop(down, aloc, up[gather], aok)
                    scatter_rows_drop(down_ex, aloc, up_ex[gather], aok)
                if per_row:
                    scatter_rows_drop(mask, loc, pk[:, :s] != 0, ok)
            loc, ok = _localize(d.idx, d.valid & ~d.side, lo, n, b)
            apply_deltas(up, up_ex, loc, d.vals, d.exists, ok)
            loc, ok = _localize(d.idx, d.valid & d.side, lo, n, b)
            apply_deltas(down, down_ex, loc, d.vals, d.exists, ok)
            # gathered slot columns go back to their shards
            state.up_vals.write_row_block(i, up)
            state.down_vals.write_row_block(i, down)
            if per_row:
                state.status_mask.write_row_block(i, mask)
        kernel_in.append((up, up_ex, down, down_ex, mask,
                          state.pair_hashes.blocks[i][0],
                          state.sel_hashes.blocks[i][0],
                          *(() if seg_ids is None else (seg_ids.blocks[i][0],))))
    decisions, upsyncs, match_counts, seg_counts = decide_and_match_shards(
        kernel_in, lead, None if seg_ids is None else seg_capacity, mesh=mesh)

    sizes = [hi - lo for lo, hi in state.up_vals.bounds]
    # each shard's first min(K, n) actionable rows, in row order
    kks = [min(k, n) for n in sizes]
    cands, sums, placed = {}, [], {}
    for i, dec, ups, args in zip(mesh.local_rows, decisions, upsyncs, kernel_in):
        lo, n, kk = state.up_vals.bounds[i][0], sizes[i], kks[i]
        up_ex = args[1]
        # placement lane over this shard's roots
        leaf = split_replicas(state.replicas.blocks[i][0], state.avail.blocks[i][0])
        currents[i] = [leaf]
        placed[i] = (leaf.to(lead),
                     placement_changed(state.current.blocks[i][0], leaf).to(lead))
        act = (dec != DECISION_NOOP) | ups
        sums.append(torch.stack([
            up_ex.sum(dtype=i32), (dec == 1).sum(dtype=i32),
            (dec == 2).sum(dtype=i32), (dec == 3).sum(dtype=i32),
            ups.sum(dtype=i32), act.sum(dtype=i32)]).to(lead))
        if n == 0:
            cands[i] = (torch.empty(0, dtype=i32, device=lead),
                        torch.empty(0, dtype=torch.uint8, device=lead),
                        torch.empty(0, dtype=torch.bool, device=lead))
            continue
        pos = first_true(act, kk)
        valid = pos < n
        safe = pos.clamp(max=n - 1).long()
        cands[i] = (torch.where(valid, pos + lo, b).to(lead),
                    torch.where(valid, dec[safe], 0).to(torch.uint8).to(lead),
                    (valid & ups[safe]).to(lead))
    # the global compaction: the shards' candidates concatenate in row
    # order, so the first K valid ones are the whole bucket's first K
    if sum(kks):
        every = gather_blocks(mesh, cands, kks)
        cidx, ccode, cup = (torch.cat(c) for c in zip(*every))
        m = cidx.shape[0]
        take = first_true(cidx < b, k)
        hit = take < m
        tsafe = take.clamp(max=m - 1).long()
        patch_idx = torch.where(hit, cidx[tsafe], b)
        patch_code = torch.where(hit, ccode[tsafe], 0).to(torch.uint8)
        patch_up = hit & cup[tsafe]
    else:
        patch_idx = torch.full((k,), b, dtype=i32, device=lead)
        patch_code = torch.zeros(k, dtype=torch.uint8, device=lead)
        patch_up = torch.zeros(k, dtype=torch.bool, device=lead)
    part = all_sum(mesh, torch.stack(sums).sum(dim=0, dtype=i32))
    total = part[5]
    leaves = gather_blocks(mesh, placed, [hi - lo for lo, hi in state.replicas.bounds])
    leaf = torch.cat([p[0] for p in leaves])
    dirty = torch.cat([p[1] for p in leaves])
    stats = torch.stack([
        part[0], part[1], part[2], part[3], part[4],
        dirty.sum(dtype=i32), match_counts.sum(dtype=i32), n_valid.to(lead)])
    new_current = ShardedTensor(mesh, FLAGS, state.current.shape, currents)
    return _Sharded(
        state=state._replace(current=new_current),
        patch_idx=patch_idx.to(i32), patch_code=patch_code, patch_upsync=patch_up,
        patch_count=total.clamp(max=k), patch_overflow=total > k, stats=stats,
        decisions=decisions, upsyncs=upsyncs, leaf=leaf, dirty=dirty,
        match_counts=match_counts, seg_counts=seg_counts)
