"""Host-side hashing primitives feeding the device encoders.

Objects never cross the host<->device boundary as strings: every field
path, leaf value, label pair, and schema token is hashed host-side to a
uint32 and the device operates on hash tensors only. FNV-1a is used for
its simplicity and distribution; collisions are handled by design — a
hash collision can at worst cause a *missed* update (two different values
mapping to the same hash), and level-triggered resync bounds the damage
exactly the way the reference's 10h informer resyncs bound missed events
(reference: pkg/syncer/syncer.go:27).

These are pure functions of canonical JSON, so host and device (and any
future C++ encoder) agree byte-for-byte.
"""

from __future__ import annotations

import json
from functools import lru_cache
from typing import Any

FNV_OFFSET = 0x811C9DC5
FNV_PRIME = 0x01000193
_MASK = 0xFFFFFFFF


def fnv1a(data: bytes, seed: int = FNV_OFFSET) -> int:
    h = seed
    for b in data:
        h ^= b
        h = (h * FNV_PRIME) & _MASK
    return h


@lru_cache(maxsize=65536)
def hash_str(s: str) -> int:
    # memoized: schema keys and label names repeat across thousands of
    # objects, and the pure-python FNV byte loop dominates tokenization
    # otherwise (the suite's schema-bucketing lane measured it)
    return fnv1a(s.encode("utf-8"))


def canonical_json(value: Any) -> str:
    """Deterministic JSON: sorted keys, no whitespace."""
    return json.dumps(value, sort_keys=True, separators=(",", ":"), ensure_ascii=False)


@lru_cache(maxsize=65536)
def _hash_scalar(type_name: str, value) -> int:
    # type_name disambiguates python equality collisions (True == 1 and
    # hash(True) == hash(1), but canonical_json renders "true" vs "1" —
    # a bare value-keyed cache would alias them)
    h = fnv1a(canonical_json(value).encode("utf-8"))
    return h if h != 0 else 1


def hash_value(value: Any) -> int:
    """Hash a JSON leaf (or subtree) value; never returns 0.

    0 is reserved as the "absent" sentinel in encoded tensors. Scalar
    leaves are memoized (enum members, type names, and common field
    values repeat endlessly across a fleet's objects and schemas);
    dict/list subtrees hash uncached.
    """
    if value is None or isinstance(value, (str, int, float, bool)):
        if isinstance(value, float) and value == 0.0:
            # -0.0 == 0.0 with equal python hashes, but canonical_json
            # renders them "-0.0" vs "0.0" — a cache key would alias
            # them and make the hash first-caller-dependent across hosts
            h = fnv1a(canonical_json(value).encode("utf-8"))
            return h if h != 0 else 1
        return _hash_scalar(type(value).__name__, value)
    h = fnv1a(canonical_json(value).encode("utf-8"))
    return h if h != 0 else 1


def hash_pair(key: str, value: str) -> int:
    """Hash a label (key, value) pair into one uint32; never 0."""
    h = fnv1a(b"\x00".join((key.encode("utf-8"), value.encode("utf-8"))))
    return h if h != 0 else 1


def hash_key(key: str) -> int:
    h = hash_str(key)
    return h if h != 0 else 1


def mix32(h: int) -> int:
    """Murmur3 finalizer — avalanche a uint32."""
    h &= _MASK
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _MASK
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _MASK
    h ^= h >> 16
    return h
