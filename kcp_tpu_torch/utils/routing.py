"""Multi-cluster write routing: the one copy of the wildcard rule.

Fork semantics (reference call site: clientutils.EnableMultiCluster,
pkg/server/server.go:230): a write issued against the wildcard cluster is
routed to the logical cluster named in ``metadata.clusterName``; a write
without that routing information is an error.
"""

from __future__ import annotations

from .errors import ApiError, InvalidError

WILDCARD = "*"


def resolve_write_cluster(cluster: str, obj: dict,
                          exc: type[ApiError] = InvalidError) -> str:
    if cluster != WILDCARD:
        return cluster
    target = (obj.get("metadata") or {}).get("clusterName")
    if not target:
        raise exc("wildcard client write requires metadata.clusterName routing")
    return target
