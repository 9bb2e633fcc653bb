"""Batched replica placement + status fan-in — the deployment splitter
math (the port of ``kcp_tpu.ops.placement``). All integer math is int32
with floor division, as in the reference."""

from __future__ import annotations

import torch


def split_replicas(replicas: torch.Tensor, avail: torch.Tensor,
                   balanced: bool = False) -> torch.Tensor:
    """Even split with the remainder going to the first available cluster.

    replicas: int32 [B]   desired root replicas
    avail:    bool  [B,P] cluster availability
    returns:  int32 [B,P] leaf replica counts (0 where unavailable)

    Parity (default): floor division, then the WHOLE remainder on the
    first available cluster. ``balanced=True`` spreads the remainder +1
    over the first ``rest`` clusters instead.
    """
    avail_i = avail.to(torch.int32)
    n = avail_i.sum(dim=-1, keepdim=True, dtype=torch.int32)  # [B,1]
    n_safe = n.clamp(min=1)
    base = torch.div(replicas[:, None], n_safe, rounding_mode="floor")
    rem = replicas[:, None] - base * n_safe
    # rank of each available cluster among available ones, in column order
    rank = torch.cumsum(avail_i, dim=-1, dtype=torch.int32) - 1
    if balanced:
        extra = (rank < rem).to(torch.int32)
    else:
        extra = (rank == 0).to(torch.int32) * rem
    leaf = base + extra
    return torch.where(avail & (n > 0), leaf, 0).to(torch.int32)


def split_replicas_weighted(replicas: torch.Tensor, weights: torch.Tensor,
                            sel: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Capacity-weighted split over a *selected* cluster subset: floor
    ``replicas*w/W`` each, then the remainder (one per cluster) to the
    best-ranked selected clusters. Integer-exact (see the reference for
    the clipping contract that keeps ``replicas*weight`` inside int32)."""
    w = torch.where(sel, weights, 0).to(torch.int32)
    total = w.sum(dim=-1, keepdim=True, dtype=torch.int32)
    total_safe = total.clamp(min=1)
    base = torch.div(replicas[:, None] * w, total_safe, rounding_mode="floor")
    rem = replicas - base.sum(dim=-1, dtype=torch.int32)
    extra = (rank < rem[:, None]) & sel
    return torch.where(sel & (total > 0), base + extra.to(torch.int32), 0).to(torch.int32)


def aggregate_status(leaf_counters: torch.Tensor, leaf_mask: torch.Tensor) -> torch.Tensor:
    """Sum leaf status counters [B,P,C] over the leafs that exist [B,P]
    into root counters [B,C]."""
    masked = leaf_counters * leaf_mask[..., None].to(leaf_counters.dtype)
    return masked.sum(dim=1, dtype=leaf_counters.dtype)


def placement_changed(current: torch.Tensor, desired: torch.Tensor) -> torch.Tensor:
    """bool [B]: any leaf's replica count differs -> row needs patching."""
    return (current != desired).any(dim=-1)
