"""Multi-tenant admission & flow control for the REST write path.

Three layers between authz and the store verbs (see chain.py, quota.py,
flow.py): a pluggable admission chain (mutating defaulting → validation
→ quota), vectorized per-(cluster, resource) quota ledgers with a
reserve → commit/rollback protocol, and APF-style flow control (per-flow
token buckets + shuffle-sharded bounded queues + a global concurrency
limit, overflow answered 429 + Retry-After).
"""

from .chain import (
    NOOP_TICKET,
    AdmissionChain,
    DefaultingPlugin,
    Ticket,
    ValidationPlugin,
    build_chain,
    enabled,
)
from .flow import FlowController
from .quota import (
    QUOTA_RESOURCE,
    QuotaLedger,
    QuotaPlugin,
    Reservation,
    UsageRecountController,
    normalize_hard,
)

__all__ = [
    "NOOP_TICKET",
    "AdmissionChain",
    "DefaultingPlugin",
    "FlowController",
    "QUOTA_RESOURCE",
    "QuotaLedger",
    "QuotaPlugin",
    "Reservation",
    "Ticket",
    "UsageRecountController",
    "ValidationPlugin",
    "build_chain",
    "enabled",
    "normalize_hard",
]
