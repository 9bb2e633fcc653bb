"""Batched spec/status three-way diff — the syncer hot loop as tensor ops
(the port of ``kcp_tpu.ops.diff``).

Decision codes (uint8):
    0 NOOP    — in sync (or neither side exists)
    1 CREATE  — upstream exists, downstream missing -> create downstream
    2 UPDATE  — both exist, spec lanes differ       -> update downstream
    3 DELETE  — upstream gone, downstream exists    -> delete downstream

``status_upsync`` is an independent lane (both exist and status differs ->
copy status upstream).

Conventions shared by the whole port: ``uint32`` lanes travel as
``int32`` bit views (equality is all the diff needs, and it is the same
on the bits); every count and index is ``int32``; nothing here calls
``nonzero``, boolean-mask indexing or ``.item()``, so a step on the card
never waits for the host. JAX's drop-mode scatter and fixed-size
``nonzero`` are :func:`scatter_rows_drop` and :func:`first_true`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

DECISION_NOOP = 0
DECISION_CREATE = 1
DECISION_UPDATE = 2
DECISION_DELETE = 3


class SyncDecisions(NamedTuple):
    decision: torch.Tensor  # uint8 [B]
    status_upsync: torch.Tensor  # bool [B]
    changed_slots: torch.Tensor  # bool [B, S] (valid where both sides exist)


def sync_decisions(
    up_vals: torch.Tensor,  # int32 view of uint32 [B, S]
    up_exists: torch.Tensor,  # bool [B]
    down_vals: torch.Tensor,  # int32 view of uint32 [B, S]
    down_exists: torch.Tensor,  # bool [B]
    status_mask: torch.Tensor,  # bool [S] or [B, S]: True for status.* slots
) -> SyncDecisions:
    """``status_mask`` may be per-bucket ([S]) or per-row ([B, S])."""
    mask = status_mask if status_mask.ndim == 2 else status_mask[None, :]
    neq = up_vals != down_vals  # [B, S]
    spec_dirty = (neq & ~mask).any(dim=-1)
    status_dirty = (neq & mask).any(dim=-1)

    both = up_exists & down_exists
    decision = (both & spec_dirty).to(torch.uint8) * DECISION_UPDATE
    decision = torch.where(~up_exists & down_exists, DECISION_DELETE, decision)
    decision = torch.where(up_exists & ~down_exists, DECISION_CREATE, decision)
    return SyncDecisions(decision, both & status_dirty, neq)


def scatter_rows_drop(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
                      valid: torch.Tensor) -> None:
    """In place: ``dst[idx[i]] = src[i]`` for every ``valid[i]``, JAX
    ``.at[idx].set(src, mode="drop")`` semantics, without a host sync.

    Negative indices count from the end (as JAX normalizes them) and
    out-of-range rows drop. Torch has no drop mode and boolean filtering
    would block the host, so every entry writes: a dropped entry writes
    its (clamped) target row's FINAL value — the value of the valid
    entry aimed at that row if there is one, else the row's current
    value — so all writes to one row agree and their order does not
    matter. A one-dimensional ``[B+1]`` winner map (row -> valid entry,
    slot B the sink) finds that entry. Batches carry unique valid
    indices (the apply_deltas contract); duplicates are unspecified, as
    in the reference."""
    b = dst.shape[0]
    if b == 0 or idx.shape[0] == 0:
        return
    idx = idx.to(torch.int32)
    idx = torch.where(idx < 0, idx + b, idx)
    ok = valid & (idx >= 0) & (idx < b)
    tgt = idx.clamp(0, b - 1)
    entries = torch.arange(idx.shape[0], dtype=torch.int32, device=dst.device)
    winner = torch.full((b + 1,), -1, dtype=torch.int32, device=dst.device)
    winner.index_put_((torch.where(ok, idx, b).long(),), entries)
    w = winner[tgt.long()]
    has = w >= 0
    pick = src[w.clamp(min=0).long()]
    cur = dst[tgt.long()]
    if dst.ndim > 1:
        has = has.view(-1, *([1] * (dst.ndim - 1)))
    dst.index_put_((tgt.long(),), torch.where(has, pick, cur))


def apply_deltas(
    vals: torch.Tensor,  # int32 [B, S] resident mirror (updated in place)
    exists: torch.Tensor,  # bool [B] (updated in place)
    idx: torch.Tensor,  # int32 [D] rows touched by this delta batch
    new_vals: torch.Tensor,  # int32 [D, S] new encodings
    new_exists: torch.Tensor,  # bool [D] False = delete
    valid: torch.Tensor,  # bool [D] padding mask for the delta batch
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter a padded delta batch into the resident mirror, IN PLACE
    (the port's form of the reference's donated state). Padding rows
    drop. The host batcher dedups deltas by key (last event wins) before
    building the batch. Returns ``(vals, exists)`` for symmetry with the
    reference."""
    scatter_rows_drop(vals, idx, new_vals, valid)
    scatter_rows_drop(exists, idx, new_exists, valid)
    return vals, exists


def first_true(mask: torch.Tensor, size: int) -> torch.Tensor:
    """int32 [size]: the indices of the first ``size`` True entries of a
    1-D mask in order, padded with ``len(mask)`` — ``jnp.nonzero(mask,
    size=size, fill_value=len(mask))`` as a cumsum compaction plus a
    scatter into a sink-padded buffer (``torch.nonzero`` on the card
    would wait for the host)."""
    n = mask.shape[0]
    pos = torch.cumsum(mask, 0, dtype=torch.int32) - 1
    keep = mask & (pos < size)
    out = torch.full((size + 1,), n, dtype=torch.int32, device=mask.device)
    out.index_put_((torch.where(keep, pos, size).long(),),
                   torch.arange(n, dtype=torch.int32, device=mask.device))
    return out[:size]


class PatchSet(NamedTuple):
    """A fixed-capacity compaction of the actionable rows of a tick:
    only rows whose decision != NOOP or that need a status upsync.
    ``idx`` rows past ``count`` are padding (== B); ``overflow`` means
    more than ``capacity`` rows were actionable (level-triggered, so the
    next tick re-derives any row it skips)."""

    idx: torch.Tensor  # int32 [K] actionable row indices, padded with B
    code: torch.Tensor  # uint8 [K] decision code per patch row
    upsync: torch.Tensor  # bool [K] status-upsync flag per patch row
    count: torch.Tensor  # int32 [] number of valid patch rows (clamped to K)
    overflow: torch.Tensor  # bool [] capacity exceeded this tick


def compact_patches(decision: torch.Tensor, status_upsync: torch.Tensor,
                    capacity: int) -> PatchSet:
    """Compact the full decision lanes into a bounded patch set."""
    b = decision.shape[0]
    actionable = (decision != DECISION_NOOP) | status_upsync
    total = actionable.sum(dtype=torch.int32)
    idx = first_true(actionable, capacity)
    safe = idx.clamp(max=b - 1).long()
    valid = idx < b
    code = torch.where(valid, decision[safe], torch.zeros_like(decision[safe]))
    upsync = valid & status_upsync[safe]
    return PatchSet(
        idx=idx,
        code=code,
        upsync=upsync,
        count=total.clamp(max=capacity),
        overflow=total > capacity,
    )
