"""HA replication: WAL shipping, RV-honest read replicas, promotion.

The log IS the replication transport: every committed store mutation is
already a WAL record (both the native binary engine and the JSON-lines
fallback journal the same record dicts), so the primary ships exactly
those records over the existing HTTP chunked-stream surface and a
follower replays them into a live :class:`~kcp_tpu_torch.store.store.LogicalStore`
— watch events fan out on the follower, the encode-once byte caches
warm on the follower's own snapshots, and the follower's local WAL makes
it durable in its own right.

- :class:`~kcp_tpu_torch.replication.hub.ReplicationHub` — primary side:
  record window + subscriber queues + semi-sync acks + fencing.
- :class:`~kcp_tpu_torch.replication.applier.ReplicationApplier` — follower
  side: feed client, exact-RV apply, lag metrics, standby promotion.
"""

from .applier import ReplicationApplier
from .hub import ReplicationHub

__all__ = ["ReplicationApplier", "ReplicationHub"]
