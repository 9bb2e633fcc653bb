"""Label-selector matching as batched tensor ops (the device functions
of ``kcp_tpu.ops.labelmatch``).

Each object's labels are uint32 pair hashes (hash(key\\0value)) and key
hashes, 0-padded to L slots, carried as int32 bit views. Selectors
compile to R requirement rows of up to V alternative hashes:

    requirement satisfied = negate XOR (any alternative hash present)

- :func:`match_batch` — N objects x 1 compiled selector
- :func:`fanout_match` — N objects x C single-pair selectors (the syncer
  fan-out shape, one ``kcp.dev/cluster=<id>`` per cluster)

Host side (the reference's, copied): :func:`compile_selector` /
:func:`try_compile_selector` build the [R, V] selector shape, and
:func:`match_batch_np` / :func:`fanout_match_np` are the numpy twins the
store's batched watch fan-out runs per micro-batch; :func:`match_host` is
the plain oracle. Importing the module loads no torch, so a serve-only
process's selector watches stay torch-free.
"""


from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..store.selectors import LabelSelector
from .hashing import hash_key, hash_pair


@dataclass(frozen=True)
class CompiledSelector:
    """Device-ready selector: [R, V] alternatives + per-row flags."""

    alts: np.ndarray  # uint32 [R, V] candidate hashes (0 = unused alt)
    negate: np.ndarray  # bool [R]
    use_key: np.ndarray  # bool [R] match against key hashes, not pair hashes
    valid: np.ndarray  # bool [R] requirement rows in use

    @property
    def rows(self) -> int:
        return int(self.alts.shape[0])


def compile_selector(
    sel: LabelSelector,
    max_reqs: int = 8,
    max_alts: int = 8,
    pair_hash=hash_pair,
    key_hash=hash_key,
) -> CompiledSelector:
    """Compile to the [R, V] kernel shape; raises ValueError when the
    selector exceeds it. ``pair_hash``/``key_hash`` default to the 32-bit
    FNV hashes the device kernels consume; exact host-side consumers pass
    interning functions instead (ids must be nonzero uint32)."""
    reqs = sel.requirements
    if len(reqs) > max_reqs:
        raise ValueError(f"selector has {len(reqs)} requirements (max {max_reqs})")
    alts = np.zeros((max_reqs, max_alts), dtype=np.uint32)
    negate = np.zeros(max_reqs, dtype=bool)
    use_key = np.zeros(max_reqs, dtype=bool)
    valid = np.zeros(max_reqs, dtype=bool)
    for i, r in enumerate(reqs):
        valid[i] = True
        if r.op in ("=", "in"):
            hashes = [pair_hash(r.key, v) for v in r.values]
        elif r.op in ("!=", "notin"):
            negate[i] = True
            hashes = [pair_hash(r.key, v) for v in r.values]
        elif r.op == "exists":
            use_key[i] = True
            hashes = [key_hash(r.key)]
        elif r.op == "!exists":
            negate[i] = True
            use_key[i] = True
            hashes = [key_hash(r.key)]
        else:
            raise ValueError(f"unknown op {r.op!r}")
        if len(hashes) > max_alts:
            raise ValueError(f"requirement on {r.key!r} has {len(hashes)} values (max {max_alts})")
        alts[i, : len(hashes)] = hashes
    return CompiledSelector(alts, negate, use_key, valid)


def try_compile_selector(
    sel: LabelSelector,
    max_reqs: int = 8,
    max_alts: int = 8,
    pair_hash=hash_pair,
    key_hash=hash_key,
) -> CompiledSelector | None:
    """:func:`compile_selector`, but a selector that exceeds the [R, V]
    kernel shape returns None (counted in ``labelmatch_fallback_total``)
    so callers fall back to host-path matching instead of erroring out —
    an oversized selector is a valid request, just not a kernel-shaped
    one. Unknown operators still raise."""
    reqs = sel.requirements
    oversized = len(reqs) > max_reqs or any(
        len(r.values) > max_alts for r in reqs)
    if oversized:
        from ..utils.trace import REGISTRY

        REGISTRY.counter(
            "labelmatch_fallback_total",
            "selectors too large for the match kernel, matched host-side",
        ).inc()
        return None
    return compile_selector(sel, max_reqs, max_alts, pair_hash, key_hash)


def match_batch(
    pair_hashes: torch.Tensor,  # int32 [N, L]
    key_hashes: torch.Tensor,  # int32 [N, L]
    alts: torch.Tensor,  # int32 [R, V]
    negate: torch.Tensor,  # bool [R]
    use_key: torch.Tensor,  # bool [R]
    valid: torch.Tensor,  # bool [R]
) -> torch.Tensor:
    """bool [N]: does each object match the selector?"""
    import torch  # here, not at import: the store's host fan-out needs none

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


def match_batch_np(
    pair_hashes: np.ndarray,  # uint32 [N, L]
    key_hashes: np.ndarray,  # uint32 [N, L]
    cs: CompiledSelector,
) -> np.ndarray:
    """Numpy twin of :func:`match_batch`: bool [N], no device round trip.

    The store's watch fan-out runs this per micro-batch — tens to
    hundreds of rows, where a transfer would dominate the compare."""
    table = np.where(cs.use_key[:, None, None], key_hashes[None], pair_hashes[None])  # [R,N,L]
    eq = table[:, :, :, None] == cs.alts[:, None, None, :]  # [R,N,L,V]
    contains = (eq & (cs.alts != 0)[:, None, None, :]).any(axis=(2, 3))  # [R,N]
    satisfied = np.logical_xor(contains, cs.negate[:, None]) | ~cs.valid[:, None]
    return satisfied.all(axis=0)


def fanout_match_np(pair_hashes: np.ndarray, selector_hashes: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`fanout_match`: bool [N, C]."""
    return (pair_hashes[:, None, :] == selector_hashes[None, :, None]).any(axis=-1)


def match_host(sel: LabelSelector, labels_list: list[dict | None]) -> np.ndarray:
    """Host reference implementation (differential-test oracle)."""
    return np.array([sel.matches(labels or {}) for labels in labels_list], dtype=bool)
