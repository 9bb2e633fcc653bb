"""Standalone cluster + apiresource controllers against a running kcp.

The analog of the reference's cmd/cluster-controller/main.go:27-87: for a
server started with --no-install-controllers, this process connects over
HTTP (the EnableMultiCluster wildcard client, main.go:41) and runs the
cluster, apiresource-negotiation, CRD-lifecycle, and deployment-splitter
controllers out-of-process.
"""

from __future__ import annotations

import asyncio
import logging
import signal
import sys

from ..physical import PhysicalRegistry
from ..server.rest import MultiClusterRestClient, RestClient
from . import add_device_argument
from .help import parser

DOC = """Run the kcp-tpu control-plane controllers out-of-process against a
running kcp-tpu server. Registered Cluster resources get API importers and
syncers; imported schemas are negotiated into published APIs; root
Deployments are split across clusters."""


def build_parser():
    p = parser("cluster-controller", DOC)
    p.add_argument("--server", default="http://127.0.0.1:6443",
                   help="kcp-tpu API server URL")
    p.add_argument("--ca-file", default=None,
                   help="CA bundle for an https --server")
    p.add_argument("--resources-to-sync", default="deployments.apps")
    p.add_argument("--syncer-mode", choices=["push", "pull", "none"], default="push")
    p.add_argument("--syncer-image", default="",
                   help="image the pull-mode installer deploys (default: the "
                        "installer's DEFAULT_SYNCER_IMAGE; see "
                        "contrib/syncer-image)")
    p.add_argument("--auto-publish-apis", action="store_true")
    p.add_argument("--backend", choices=["fused", "host"], default="fused",
                   help="push syncers' and splitter's backend (fused: the "
                        "batched device step on --device, the reference's "
                        "'tpu'; host: the per-object host path). Schema "
                        "hashes always run on --device")
    add_device_argument(p)
    p.add_argument("--poll-interval", type=float, default=60.0)
    p.add_argument("--num-threads", type=int, default=2,
                   help="workers per controller (reference: Start(2), "
                        "server.go:241,250)")
    return p


async def run(args) -> None:
    from ..reconcilers.apiresource import NegotiationController
    from ..reconcilers.cluster import ClusterController, SyncerMode
    from ..reconcilers.crdlifecycle import CRDLifecycleController
    from ..reconcilers.deployment import DeploymentSplitter

    client = MultiClusterRestClient(args.server, ca_file=args.ca_file)
    registry = PhysicalRegistry()
    # physical clusters reachable over HTTP resolve to REST clients
    registry.register_factory("http", lambda url: RestClient(url, cluster="default"))
    registry.register_factory("https", lambda url: RestClient(url, cluster="default"))

    mode = {"push": SyncerMode.PUSH, "pull": SyncerMode.PULL,
            "none": SyncerMode.NONE}[args.syncer_mode]
    controllers = [
        NegotiationController(client, auto_publish=args.auto_publish_apis,
                              device=args.device),
        CRDLifecycleController(client),
        ClusterController(
            client, registry,
            resources_to_sync=[r for r in args.resources_to_sync.split(",") if r],
            mode=mode, backend=args.backend, device=args.device,
            poll_interval=args.poll_interval,
            import_poll_interval=args.poll_interval,
            **({"syncer_image": args.syncer_image}
               if args.syncer_image else {})),
        DeploymentSplitter(client, device=args.device),
    ]
    for c in controllers:
        if isinstance(c, (NegotiationController, ClusterController)):
            await c.start(num_workers=args.num_threads)
        else:
            await c.start()

    stop = asyncio.Event()
    loop = asyncio.get_event_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:
            pass
    await stop.wait()
    for c in reversed(controllers):
        await c.stop()


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    asyncio.run(run(args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
