"""Standalone deployment splitter.

The analog of the reference's cmd/deployment-splitter/main.go:17-33: run
only the Deployment split/aggregate controller against a kcp-tpu server —
root Deployments are split across registered Clusters with the batched
placement solver; leaf statuses aggregate back to the root.
"""

from __future__ import annotations

import asyncio
import logging
import signal
import sys

from ..server.rest import MultiClusterRestClient
from . import add_device_argument
from .help import parser

DOC = """Split root Deployments across registered Clusters into labeled
leaf Deployments (replicas evenly partitioned by the batched placement
kernel) and aggregate leaf status back to the root."""


def build_parser():
    p = parser("deployment-splitter", DOC)
    p.add_argument("--server", default="http://127.0.0.1:6443",
                   help="kcp-tpu API server URL (reference: -kubeconfig)")
    p.add_argument("--backend", choices=["fused", "host"], default="fused",
                   help="fused: roots ride the fused core's placement "
                        "lanes on --device (the reference's 'tpu'); host: "
                        "numpy lanes")
    add_device_argument(p)
    p.add_argument("--ca-file", default=None,
                   help="CA bundle for an https --server")
    return p


async def run(args) -> None:
    from ..reconcilers.deployment import DeploymentSplitter

    client = MultiClusterRestClient(args.server, ca_file=args.ca_file)
    splitter = DeploymentSplitter(client, backend=args.backend,
                                  device=args.device)
    await splitter.start()
    stop = asyncio.Event()
    loop = asyncio.get_event_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:
            pass
    await stop.wait()
    await splitter.stop()


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    asyncio.run(run(args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
