"""Batched schema hashing: bucket assignment for shape-homogeneous
batches (the port of ``kcp_tpu.ops.schemahash``).

The negotiation controller compares imported schemas across many
tenants. The tree-walk LCD computation stays on the host
(``kcp_tpu_torch.schemacompat``); the *bucketing* decision ("which imports
share a schema, which negotiated schema does an import already match")
reduces to hashing the canonical token stream of each schema.

Device computation: a polynomial rolling hash over fixed-length uint32
token vectors

    h = mix( sum_i tokens[i] * P^(T-1-i)  mod 2^32 )

with a murmur3 finalizer for avalanche, for a whole ``[B, T]`` batch in
one call on the tensor's device. torch has no unsigned 32-bit arithmetic
worth the name (``uint32`` has no shifts and its sums widen), so the hash
runs in int64 on values masked to 32 bits after every product and sum:
the low 32 bits of a wrapped int64 product equal those of the exact one,
so the result equals the reference's ``uint32`` bit for bit.

Host-side :func:`tokenize_schemas` produces the canonical token stream
(sorted keys, type tags), so equal schemas tokenize equally regardless of
dict ordering. Its three tiers (the ``kcptok`` extension, the native
JSON-blob parser, the Python walk) give identical tokens, so the same
schema hashes identically on every host.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..native import load_tokenizer, tokenize_schemas_native
from .hashing import canonical_json, hash_str, hash_value

POLY = np.uint32(0x01000193)  # FNV prime as the polynomial base
_M32 = 0xFFFFFFFF


def tokenize_schema_py(schema: dict, max_tokens: int = 256) -> np.ndarray:
    """Pure-Python canonical uint32 token stream of a JSON-schema subtree.

    Deterministic: dict keys sorted; every structural element contributes
    (key-hash, value-token) pairs; nested dicts/lists recurse with
    open/close markers so different nestings cannot collide structurally.
    Overflow truncates (the trailing tokens still contribute via the
    length token); the LCD engine re-checks equality on the host before
    trusting a bucket hit.
    """
    toks: list[int] = []

    OPEN, CLOSE, LIST_OPEN, LIST_CLOSE = 0xA11CE, 0xB0B, 0xC0DE, 0xD00D

    def walk(v) -> None:
        if len(toks) >= max_tokens:
            return
        if isinstance(v, dict):
            toks.append(OPEN)
            for k in sorted(v.keys()):
                toks.append(hash_str(k))
                walk(v[k])
            toks.append(CLOSE)
        elif isinstance(v, list):
            toks.append(LIST_OPEN)
            for item in v:
                walk(item)
            toks.append(LIST_CLOSE)
        else:
            toks.append(hash_value(v))

    walk(schema)
    toks.append(len(toks))  # length token guards truncation collisions
    arr = np.zeros(max_tokens, dtype=np.uint32)
    arr[: min(len(toks), max_tokens)] = np.array(toks[:max_tokens], dtype=np.uint64).astype(
        np.uint32
    )
    return arr


def _strictly_json(v) -> bool:
    """True iff ``v`` is built only from JSON-shaped Python types (the
    native tiers may only be used on input every tier renders the same
    way)."""
    if isinstance(v, dict):
        return all(
            isinstance(k, str) and _strictly_json(x) for k, x in v.items()
        )
    if isinstance(v, list):
        return all(_strictly_json(x) for x in v)
    return v is None or isinstance(v, (str, int, float, bool))


def tokenize_schemas(schemas: list[dict], max_tokens: int = 256) -> np.ndarray:
    """Batch tokenizer ``[B, T]`` uint32.

    Tier 1 walks the dicts in the ``kcptok`` extension. Without it, tier 2
    serializes each schema once (canonical JSON) and parses and walks the
    whole batch natively in one call, but only when every schema is
    strictly JSON-shaped: ``json.dumps`` would coerce a tuple into an array
    and diverge from the Python walk's opaque-leaf hash. The Python walk
    is the last tier, and the only one used when tier 1 rejects a schema.
    """
    if not schemas:
        return np.zeros((0, max_tokens), dtype=np.uint32)
    tok = load_tokenizer()
    if tok is not None:
        out = np.empty((len(schemas), max_tokens), dtype=np.uint32)
        schemas_list = schemas if isinstance(schemas, list) else list(schemas)
        if tok.tokenize(schemas_list, max_tokens, out) == 0:
            return out
        # nonzero: some schema is not JSON-shaped; only the Python walk
        # hashes it as the other hosts do
    elif all(_strictly_json(s) for s in schemas):
        try:
            blobs = [canonical_json(s).encode("utf-8") for s in schemas]
            out = tokenize_schemas_native(blobs, max_tokens)
        except (TypeError, ValueError):
            out = None  # non-JSON-serializable schema
        if out is not None:
            return out
    return np.stack([tokenize_schema_py(s, max_tokens) for s in schemas])


def tokenize_schema(schema: dict, max_tokens: int = 256) -> np.ndarray:
    """Single-schema tokenizer (a batch of one through the native path)."""
    return tokenize_schemas([schema], max_tokens)[0]


@lru_cache(maxsize=8)
def _powers(t: int) -> np.ndarray:
    out = np.ones(t, dtype=np.uint64)
    for i in range(t - 2, -1, -1):
        out[i] = (out[i + 1] * int(POLY)) & 0xFFFFFFFF
    return out.astype(np.uint32)


def schema_hashes(tokens: torch.Tensor) -> torch.Tensor:
    """int64 ``[B]`` holding each token row's uint32 hash (``[B, T]``
    tokens of any integer dtype; values are read as uint32 bit patterns).
    Runs on ``tokens.device``."""
    t = tokens.shape[-1]
    tok = tokens.to(torch.int64) & _M32  # an int32 view's negatives, unwrapped
    powers = torch.from_numpy(_powers(t).astype(np.int64)).to(tokens.device)
    h = ((tok * powers) & _M32).sum(dim=-1) & _M32
    # murmur3 finalizer, masked after every multiply
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    h = h ^ (h >> 16)
    return h


def bucket_by_hash(hashes: np.ndarray) -> dict[int, np.ndarray]:
    """Group row indices by hash value (one argsort and one boundary scan
    instead of a per-row Python loop)."""
    h = np.asarray(hashes)
    if h.size == 0:
        return {}
    order = np.argsort(h, kind="stable").astype(np.int32)
    sorted_h = h[order]
    starts = np.flatnonzero(np.r_[True, sorted_h[1:] != sorted_h[:-1]])
    ends = np.r_[starts[1:], sorted_h.size]
    return {int(sorted_h[s]): order[s:e] for s, e in zip(starts, ends)}
