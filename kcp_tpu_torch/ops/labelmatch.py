"""Label-selector matching as batched tensor ops (the device functions
of ``kcp_tpu.ops.labelmatch``).

Each object's labels are uint32 pair hashes (hash(key\\0value)) and key
hashes, 0-padded to L slots, carried as int32 bit views. Selectors
compile to R requirement rows of up to V alternative hashes:

    requirement satisfied = negate XOR (any alternative hash present)

- :func:`match_batch` — N objects x 1 compiled selector
- :func:`fanout_match` — N objects x C single-pair selectors (the syncer
  fan-out shape, one ``kcp.dev/cluster=<id>`` per cluster)

The selector compiler and the numpy twins the store uses come with the
store slice.
"""

from __future__ import annotations

import torch


def match_batch(
    pair_hashes: torch.Tensor,  # int32 [N, L]
    key_hashes: torch.Tensor,  # int32 [N, L]
    alts: torch.Tensor,  # int32 [R, V]
    negate: torch.Tensor,  # bool [R]
    use_key: torch.Tensor,  # bool [R]
    valid: torch.Tensor,  # bool [R]
) -> torch.Tensor:
    """bool [N]: does each object match the selector?"""
    table = torch.where(use_key[:, None, None], key_hashes[None], pair_hashes[None])  # [R,N,L]
    alt_valid = alts != 0  # [R,V]
    eq = table[:, :, :, None] == alts[:, None, None, :]  # [R,N,L,V]
    contains = (eq & alt_valid[:, None, None, :]).flatten(2).any(dim=2)  # [R,N]
    satisfied = contains ^ negate[:, None]
    satisfied = satisfied | ~valid[:, None]
    return satisfied.all(dim=0)


def fanout_match(pair_hashes: torch.Tensor, selector_hashes: torch.Tensor) -> torch.Tensor:
    """bool [N, C]: object n carries selector c's (key=value) pair."""
    return (pair_hashes[:, None, :] == selector_hashes[None, :, None]).any(dim=-1)
