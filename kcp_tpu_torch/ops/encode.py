"""Irregular objects -> regular tensors.

The central trick of the TPU build (SURVEY.md §7.1): Kubernetes-style
objects are open-schema JSON, but batched device kernels need fixed
shapes. Objects are therefore:

1. flattened to (field-path, leaf-value) pairs,
2. bucketed by schema (one :class:`BucketEncoder` per schema bucket, so
   every batch is shape-homogeneous),
3. encoded as a dense ``uint32[S]`` vector of value hashes indexed by a
   per-bucket slot vocabulary (path -> slot), 0 = absent,
4. padded to the bucket's power-of-two capacity.

Volatile metadata (resourceVersion, generation, uid, creationTimestamp,
managedFields) is excluded, matching the reference's diff semantics
(pkg/syncer/specsyncer.go:17-41 deepEqualApartFromStatus). ``status.*``
slots are flagged so the diff kernel can run the spec lane and the status
lane from one encoding (statussyncer.go:15-27 deepEqualStatus).

A bucket that outgrows its slot capacity raises :class:`BucketOverflow`;
the caller re-buckets at double capacity (the host escape hatch for odd
objects — capacities stay powers of two so XLA recompiles at most
log2(max_slots) times per bucket).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable, Mapping, Sequence

import numpy as np

from .hashing import hash_value

VOLATILE_META = frozenset(
    {"resourceVersion", "generation", "uid", "creationTimestamp", "managedFields"}
)


class BucketOverflow(Exception):
    """Object needs more slots than the bucket has; re-bucket larger."""


def flatten_object(obj: Mapping, max_depth: int = 8) -> list[tuple[str, Any]]:
    """Flatten to dotted-path leaves. Lists and over-deep subtrees hash whole.

    Patch granularity is object-level (the host rebuilds patches from real
    objects; the device only *decides*), so leaves don't need to be scalar.
    """
    out: list[tuple[str, Any]] = []

    def walk(prefix: str, v: Any, depth: int) -> None:
        if isinstance(v, Mapping) and depth < max_depth:
            if not v:
                out.append((prefix, {}))
                return
            for k in sorted(v.keys()):
                if depth == 1 and prefix == "metadata" and k in VOLATILE_META:
                    continue
                walk(f"{prefix}.{k}" if prefix else str(k), v[k], depth + 1)
        else:
            out.append((prefix, v))

    for k in sorted(obj.keys()):
        if k in ("apiVersion", "kind"):
            out.append((k, obj[k]))
            continue
        walk(k, obj[k], 1)
    return out


@dataclass
class EncodedBatch:
    """A device-ready batch of encoded objects."""

    values: np.ndarray  # uint32 [N, S]
    exists: np.ndarray  # bool   [N]
    keys: list  # host-side row -> object key alignment

    @property
    def n(self) -> int:
        return int(self.values.shape[0])

    @property
    def slots(self) -> int:
        return int(self.values.shape[1])


@dataclass
class BucketEncoder:
    """Slot vocabulary + encoder for one schema bucket.

    When the native library (native/encode.cc) loads, encoding runs
    through the C++ flatten+hash pipeline — byte-for-byte identical to
    the Python path (differential-tested in tests/test_native.py) — and
    the vocabulary is mirrored back after each call so
    :meth:`status_mask` and callers keep working unchanged.
    """

    capacity: int = 64
    slots: dict[str, int] = field(default_factory=dict)
    slot_paths: list[str] = field(default_factory=list)
    _native: Any = field(default=None, repr=False, compare=False)
    _native_tried: bool = field(default=False, repr=False, compare=False)

    def _slot_for(self, path: str) -> int:
        slot = self.slots.get(path)
        if slot is None:
            if len(self.slot_paths) >= self.capacity:
                raise BucketOverflow(
                    f"bucket full at {self.capacity} slots (adding {path!r})"
                )
            slot = len(self.slot_paths)
            self.slots[path] = slot
            self.slot_paths.append(path)
        return slot

    def _native_bucket(self):
        if not self._native_tried:
            self._native_tried = True
            try:
                from ..native import NativeBucket, available

                if available():
                    nb = NativeBucket(self.capacity)
                    for path in self.slot_paths:  # seed existing vocab
                        nb.add_path(path)
                    self._native = nb
            except Exception:
                self._native = None
        return self._native

    def _sync_native_vocab(self, nb) -> None:
        if nb.nslots > len(self.slot_paths):
            for path in nb.slot_paths()[len(self.slot_paths):]:
                self.slots[path] = len(self.slot_paths)
                self.slot_paths.append(path)

    def encode(self, obj: Mapping, out: np.ndarray | None = None) -> np.ndarray:
        """Encode one object into a uint32[capacity] vector."""
        if out is None:
            out = np.zeros(self.capacity, dtype=np.uint32)
        nb = self._native_bucket()
        if nb is not None:
            import json

            try:
                payload = json.dumps(obj).encode("utf-8")
            except (TypeError, ValueError):
                payload = None
            rc = nb.encode_json(payload, out) if payload is not None else -2
            if rc == 0:
                self._sync_native_vocab(nb)
                return out
            if rc == -1:
                self._sync_native_vocab(nb)
                raise BucketOverflow(f"bucket full at {self.capacity} slots")
            # Parse anomaly (e.g. >128-deep nesting, non-serializable
            # value): retire the native bucket for good — continuing to
            # use it after the Python path grows the vocabulary would
            # break the prefix invariant _sync_native_vocab relies on and
            # silently scramble slot assignments.
            self._native = None
        for path, value in flatten_object(obj):
            out[self._slot_for(path)] = hash_value(value)
        return out

    def encode_batch(
        self,
        objs: Sequence[Mapping | None],
        keys: Sequence | None = None,
        pad_to: int | None = None,
    ) -> EncodedBatch:
        """Encode objects (None = absent) into a padded batch.

        ``pad_to`` rounds the batch dimension up (power-of-two padding keeps
        the number of distinct compiled shapes small).
        """
        n = len(objs)
        rows = pad_to if pad_to is not None else n
        values = np.zeros((rows, self.capacity), dtype=np.uint32)
        exists = np.zeros(rows, dtype=bool)
        for i, obj in enumerate(objs):
            if obj is None:
                continue
            self.encode(obj, out=values[i])
            exists[i] = True
        return EncodedBatch(values, exists, list(keys) if keys is not None else list(range(n)))

    def status_mask(self) -> np.ndarray:
        """bool[capacity]: True where the slot is a ``status.*`` path."""
        mask = np.zeros(self.capacity, dtype=bool)
        for path, slot in self.slots.items():
            if path == "status" or path.startswith("status."):
                mask[slot] = True
        return mask

    def grown(self) -> "BucketEncoder":
        """A fresh encoder at double capacity (same vocabulary prefix)."""
        enc = BucketEncoder(capacity=self.capacity * 2)
        enc.slots = dict(self.slots)
        enc.slot_paths = list(self.slot_paths)
        return enc


def pad_pow2(n: int, floor: int = 8) -> int:
    """Round up to a power of two (min ``floor``) for stable jit shapes."""
    if n <= floor:
        return floor
    return 1 << (n - 1).bit_length()


def encode_labels(
    labels: Mapping[str, str] | None, capacity: int
) -> tuple[np.ndarray, np.ndarray]:
    """Encode a label map as (pair_hashes, key_hashes) uint32[capacity].

    Used by the labelmatch kernel; 0-padded. Overflowing label maps keep
    the first ``capacity`` pairs sorted by key (deterministic) — the host
    matcher remains the escape hatch for pathological objects.
    """
    from .hashing import hash_key, hash_pair

    pairs = np.zeros(capacity, dtype=np.uint32)
    keys = np.zeros(capacity, dtype=np.uint32)
    if labels:
        for i, k in enumerate(sorted(labels.keys())[:capacity]):
            pairs[i] = hash_pair(k, str(labels[k]))
            keys[i] = hash_key(k)
    return pairs, keys


def encode_label_batch(
    label_maps: Iterable[Mapping[str, str] | None], capacity: int = 8, pad_to: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    maps = list(label_maps)
    rows = pad_to if pad_to is not None else len(maps)
    pairs = np.zeros((rows, capacity), dtype=np.uint32)
    keys = np.zeros((rows, capacity), dtype=np.uint32)
    for i, m in enumerate(maps):
        pairs[i], keys[i] = encode_labels(m, capacity)
    return pairs, keys
