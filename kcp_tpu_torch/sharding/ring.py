"""Shard ring: consistent (rendezvous/HRW) hashing of logical clusters.

The sharded control plane partitions by logical-cluster name — the unit
the whole fork is organized around (SURVEY §0: many cheap tenant control
planes keyed by cluster prefix; upstream kcp later shipped the same
partition as shards). Rendezvous hashing (highest-random-weight) gives
the two properties a shard ring needs with no virtual-node bookkeeping:

- deterministic, coordination-free: every router (and every smart
  client) computes the same owner from the shard list alone;
- minimal movement: adding a shard reassigns only the keys whose
  highest weight the new shard now holds (~1/N of the keyspace);
  removing one reassigns only ITS keys.

Weights come from blake2b over ``shard-name \\x00 cluster-name`` — a
stable, process-independent hash (``hash()`` is per-process salted and
would scatter ownership across restarts).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

DEFAULT_SHARDS_ENV = "KCP_SHARDS"


@dataclass(frozen=True)
class Shard:
    """One shard server: a stable identity + its primary's base URL,
    plus any read replicas fed by that primary's WAL (the router routes
    plain reads to them; writes and RV-resumes stay on the primary)."""

    name: str
    url: str
    replicas: tuple[str, ...] = ()


def _weight(shard_name: str, cluster: str) -> int:
    h = hashlib.blake2b(digest_size=8)
    h.update(shard_name.encode("utf-8"))
    h.update(b"\x00")
    h.update(cluster.encode("utf-8"))
    return int.from_bytes(h.digest(), "big")


def owner_name(names, cluster: str) -> str:
    """HRW owner of ``cluster`` given only the ring's shard NAMES.

    Ownership depends on the name set alone (URLs never enter the
    hash), so a shard that knows the ring's names and its own name can
    verify a smart client's direct request without knowing anyone's
    address — the server half of the ``X-Kcp-Ring-Epoch`` handshake."""
    return max(names, key=lambda n: (_weight(n, cluster), n))


class ShardRing:
    """An ordered, deduplicated set of shards with HRW ownership.

    ``overrides`` is the per-cluster *pending-migration* overlay: while
    a cluster's WAL is being streamed to its new HRW owner, the ring
    pins it to the OLD owner by name so ownership flips atomically per
    cluster (when the migration completes and the override is dropped),
    never wholesale at an epoch bump. Overrides ride the ``/ring``
    document, so routers, shards, and smart clients all resolve the
    same owner mid-migration."""

    def __init__(self, shards: list[Shard],
                 overrides: dict[str, str] | None = None):
        if not shards:
            raise ValueError("shard ring needs at least one shard")
        seen_names: dict[str, str] = {}
        seen_urls: dict[str, str] = {}
        for s in shards:
            if s.name in seen_names:
                raise ValueError(
                    f"duplicate shard name {s.name!r} (urls {seen_names[s.name]!r}"
                    f" and {s.url!r}): shard names are ring identities — "
                    f"rename one entry in KCP_SHARDS/--shards")
            if s.url in seen_urls:
                raise ValueError(
                    f"duplicate shard url {s.url!r} (names {seen_urls[s.url]!r}"
                    f" and {s.name!r}): two ring entries would route distinct "
                    f"keyspaces to one server — remove or fix one entry in "
                    f"KCP_SHARDS/--shards")
            seen_names[s.name] = s.url
            seen_urls[s.url] = s.name
        self.shards: tuple[Shard, ...] = tuple(shards)
        ov = dict(overrides or {})
        for cluster, name in ov.items():
            if name not in seen_names:
                raise ValueError(
                    f"override {cluster!r} -> {name!r} names a shard "
                    f"not in the ring ({sorted(seen_names)})")
        self.overrides: dict[str, str] = ov

    def __len__(self) -> int:
        return len(self.shards)

    def __iter__(self):
        return iter(self.shards)

    def index_of(self, name: str) -> int:
        for i, s in enumerate(self.shards):
            if s.name == name:
                return i
        raise ValueError(f"no shard named {name!r} in the ring")

    def owner_index(self, cluster: str) -> int:
        """Index of the shard owning ``cluster`` (ties broken by name so
        the choice is total even for colliding 64-bit weights); a
        pending-migration override pins the cluster to its old owner."""
        pinned = self.overrides.get(cluster)
        if pinned is not None:
            return self.index_of(pinned)
        return self.hrw_index(cluster)

    def hrw_index(self, cluster: str) -> int:
        """Pure HRW owner index, ignoring overrides — the *target* of a
        pending migration (``owner_index`` is where traffic goes NOW)."""
        best = 0
        best_key = (_weight(self.shards[0].name, cluster), self.shards[0].name)
        for i in range(1, len(self.shards)):
            key = (_weight(self.shards[i].name, cluster), self.shards[i].name)
            if key > best_key:
                best, best_key = i, key
        return best

    def owner(self, cluster: str) -> Shard:
        return self.shards[self.owner_index(cluster)]

    def with_shard_added(self, shard: Shard,
                         pin_clusters: list[str] | None = None) -> "ShardRing":
        """A new ring with ``shard`` appended; ``pin_clusters`` are the
        existing clusters whose HRW owner would change — each is pinned
        (override) to its CURRENT owner so nothing moves until its
        migration completes."""
        ov = dict(self.overrides)
        for cluster in pin_clusters or ():
            ov.setdefault(cluster, self.shards[self.owner_index(cluster)].name)
        return ShardRing(list(self.shards) + [shard], ov)

    def with_shard_removed(self, name: str) -> "ShardRing":
        """A new ring without shard ``name``; refuses while any override
        still pins a cluster to it (that cluster's data lives there)."""
        pinned = sorted(c for c, n in self.overrides.items() if n == name)
        if pinned:
            raise ValueError(
                f"cannot remove shard {name!r}: clusters {pinned} are "
                f"still pinned to it by pending migrations")
        remaining = [s for s in self.shards if s.name != name]
        if len(remaining) == len(self.shards):
            raise ValueError(f"no shard named {name!r} in the ring")
        return ShardRing(remaining, dict(self.overrides))

    def without_override(self, cluster: str) -> "ShardRing":
        """A new ring with ``cluster``'s pending-migration pin dropped —
        the atomic per-cluster ownership flip."""
        if cluster not in self.overrides:
            raise ValueError(f"no pending migration for cluster {cluster!r}")
        ov = dict(self.overrides)
        del ov[cluster]
        return ShardRing(list(self.shards), ov)

    @classmethod
    def from_spec(cls, spec: str, replicas: str = "") -> "ShardRing":
        """Parse a shard-list spec: comma-separated ``name=url`` entries
        (bare URLs get ``shard<i>`` names). This is the ``KCP_SHARDS``
        format and the ``kcp start --role router --shards`` argument.

        A shard entry may append ``|``-separated read-replica URLs:
        ``s0=http://h0:6443|http://h0r:6444`` — the first URL is the
        primary (the ring hashes names, so replicas never change
        ownership). ``replicas`` (the ``KCP_REPLICAS`` format) is an
        alternative per-shard mapping, ``;``-separated
        ``name=url[|url...]`` entries, merged after the inline form.
        """
        shards: list[Shard] = []
        for i, entry in enumerate(s.strip() for s in spec.split(",")):
            if not entry:
                continue
            name, sep, url = entry.partition("=")
            if not sep:
                name, url = f"shard{i}", entry
            urls = [u.strip().rstrip("/") for u in url.split("|") if u.strip()]
            if not urls or any("://" not in u for u in urls):
                raise ValueError(
                    f"shard entry {entry!r}: expected "
                    f"[name=]http[s]://host:port[|replica-url...]")
            shards.append(Shard(name.strip(), urls[0], tuple(urls[1:])))
        if replicas:
            by_name = {s.name: s for s in shards}
            for entry in (e.strip() for e in replicas.split(";")):
                if not entry:
                    continue
                name, sep, urls_raw = entry.partition("=")
                name = name.strip()
                if not sep or name not in by_name:
                    raise ValueError(
                        f"replica entry {entry!r}: expected "
                        f"<shard-name>=url[|url...] naming a shard in the "
                        f"ring ({sorted(by_name)})")
                extra = tuple(u.strip().rstrip("/")
                              for u in urls_raw.split("|") if u.strip())
                if any("://" not in u for u in extra):
                    raise ValueError(
                        f"replica entry {entry!r}: URLs must be "
                        f"http[s]://host:port")
                s = by_name[name]
                by_name[name] = Shard(s.name, s.url, s.replicas + extra)
            shards = [by_name[s.name] for s in shards]
        return cls(shards)

    @classmethod
    def from_env(cls) -> "ShardRing":
        spec = os.environ.get(DEFAULT_SHARDS_ENV, "")
        if not spec:
            raise ValueError(
                f"no shard list: set {DEFAULT_SHARDS_ENV} or pass --shards")
        return cls.from_spec(spec, os.environ.get("KCP_REPLICAS", ""))
