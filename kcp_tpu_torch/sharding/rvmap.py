"""Vector resourceVersion: the router's honest RV across N shards.

Each shard allocates its own monotonically increasing store RV, so a
single scalar cannot describe a merged wildcard list/watch position —
"resume from 1742" is meaningless when three independent counters are
involved. The router therefore reports a *vector* RV: the per-shard RV
list, packed into one arbitrary-precision integer so it rides the
existing wire surface unchanged (``metadata.resourceVersion`` strings,
``?resourceVersion=`` watch resumes, ``int()`` round trips in RestClient
and the informer all keep working — Python ints are unbounded).

Encoding: ``MAGIC(2B) | shard-count(1B) | LEB128 varint per shard RV``,
big-endian int of those bytes. The magic keeps any plausible scalar
store RV (which would need to exceed 2^40 *and* collide with the magic
prefix AND parse to the exact byte length) from masquerading as a
vector; decoding is strict — wrong magic, wrong shard count, or trailing
bytes all return ``None``, and the router answers such resumes with an
honest 410 Gone (re-list) instead of guessing.
"""

from __future__ import annotations

MAGIC = b"\xc5\x52"  # arbitrary, non-zero leading byte (survives int round trip)
MAX_SHARDS = 255


def _varint(n: int, out: bytearray) -> None:
    if n < 0:
        raise ValueError(f"negative rv {n}")
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def encode_rvmap(rvs: list[int]) -> int:
    """Pack per-shard RVs (ring order) into one opaque integer."""
    if not rvs or len(rvs) > MAX_SHARDS:
        raise ValueError(f"rv vector of {len(rvs)} shards (1..{MAX_SHARDS})")
    out = bytearray(MAGIC)
    out.append(len(rvs))
    for rv in rvs:
        _varint(int(rv), out)
    return int.from_bytes(bytes(out), "big")


def decode_rvmap(value: int, n_shards: int) -> list[int] | None:
    """Unpack a vector RV for an ``n_shards`` ring; ``None`` when the
    value is not a vector for exactly that ring size (a plain scalar RV,
    a vector minted by a differently-sized ring, garbage)."""
    if value <= 0:
        return None
    raw = value.to_bytes((value.bit_length() + 7) // 8, "big")
    if len(raw) < 4 or raw[:2] != MAGIC or raw[2] != n_shards:
        return None
    rvs: list[int] = []
    i = 3
    for _ in range(n_shards):
        rv = 0
        shift = 0
        while True:
            if i >= len(raw) or shift > 63:
                return None
            b = raw[i]
            i += 1
            rv |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        rvs.append(rv)
    if i != len(raw):  # trailing bytes: not our encoding
        return None
    return rvs
