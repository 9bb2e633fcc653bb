"""kcp_tpu_torch.server — the minimal multi-tenant API server.

The analog of the reference's pkg/server (server.go:79-292) plus the
behavior it inherits from the un-vendored kcp-dev/kubernetes fork: a
Kubernetes-style REST+watch HTTP surface over the LogicalStore, with
per-tenant routing via the ``/clusters/<name>`` path prefix or the
``X-Kubernetes-Cluster`` header and wildcard ``*`` cross-tenant reads
(reference: pkg/server/server.go:164; docs/investigations/
logical-clusters.md:70-74).
"""

from .handler import RestHandler
from .httpd import HttpServer
from .rest import MultiClusterRestClient, RestClient, RestWatch
from .server import Config, Server

__all__ = [
    "Config",
    "HttpServer",
    "MultiClusterRestClient",
    "RestClient",
    "RestHandler",
    "RestWatch",
    "Server",
]
