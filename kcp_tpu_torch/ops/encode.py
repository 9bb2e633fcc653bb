"""Host-side shape helpers of the encoder (the port's copy of
``kcp_tpu.ops.encode.pad_pow2``; the object encoders come with the
engine slice)."""

from __future__ import annotations


def pad_pow2(n: int, floor: int = 8) -> int:
    """Round up to a power of two (min ``floor``) — stable buffer shapes."""
    if n <= floor:
        return floor
    return 1 << (n - 1).bit_length()


class BucketOverflow(Exception):
    """An object needs more slots than its bucket has: the owner grows
    its encoder and re-registers in a wider bucket."""
