"""kcp_tpu_torch.sharding — the horizontally-sharded control plane.

One process scales *within* itself (pipelined ticks, indexed stores,
encode-once serving); the BASELINE north star — 1M reconciles/sec across
10k logical clusters — needs N of them. This package partitions logical
clusters across shard servers with a consistent-hash ring
(:mod:`.ring`, rendezvous/HRW) and fronts the fleet with a router
(:mod:`.router`) that speaks the unchanged REST surface: single-cluster
requests proxy byte-verbatim to the owning shard, wildcard lists/watches
scatter-gather and merge under vector-RV bookkeeping (:mod:`.rvmap`).

Run it: ``kcp start --role shard`` per shard (a plain server), then
``kcp start --role router --shards s0=http://h0:6443,s1=http://h1:6443``.
"""

from .ring import Shard, ShardRing, owner_name
from .router import RouterHandler
from .rvmap import decode_rvmap, encode_rvmap

__all__ = ["Shard", "ShardRing", "RouterHandler", "owner_name",
           "decode_rvmap", "encode_rvmap"]
