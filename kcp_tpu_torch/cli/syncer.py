"""Standalone syncer — spec↔status sync between two API servers.

The analog of the reference's cmd/syncer/main.go:24-73: connect upstream
(kcp, filtered to one logical cluster) and downstream (physical cluster),
then run the batched spec-downsync + status-upsync engine for the listed
resource types. In the reference this binary is what pull-mode deploys
into each physical cluster; the installed Deployment invokes the pod
form (``-from_kubeconfig /kcp/kubeconfig -cluster <name> <resources>``,
reference flags cmd/syncer/main.go:17-28), which this binary accepts
natively — the pull-mode emulator (kcp_tpu_torch/physical/podrunner.py) parses
installed args through THIS parser so installer, binary, and emulator
share one argument surface.

Usage (direct):
    python -m kcp_tpu_torch.cli.syncer --from-server http://kcp:6443 \
        --from-cluster tenant-a --to-server http://physical:8080 \
        --cluster us-east1 deployments.apps configmaps
Usage (pod form):
    python -m kcp_tpu_torch.cli.syncer -from_kubeconfig /kcp/kubeconfig \
        --to-server http://physical:8080 -cluster us-east1 configmaps
"""

from __future__ import annotations

import asyncio
import json
import logging
import signal
import sys

from ..server.rest import RestClient
from . import add_device_argument
from .help import parser

DOC = """Sync specs down from a kcp-tpu logical cluster to a physical
cluster and statuses back up, for the listed resource types. Objects are
selected by the kcp.dev/cluster=<cluster> label; sync decisions are
computed by the batched decide-and-match kernel on a CUDA card
(--backend fused, the default) or on the host (--backend host)."""


def build_parser(pod_form_only: bool = False):
    """The one syncer argument surface.

    ``pod_form_only`` relaxes the server flags for parsing an installed
    Deployment's args (the pod gets its downstream in-cluster, so the
    manifest carries no --to-server).
    """
    p = parser("syncer", DOC)
    p.add_argument("--from-server", default=None,
                   help="upstream kcp-tpu URL")
    p.add_argument("-from_kubeconfig", "--from-kubeconfig",
                   dest="from_kubeconfig", default=None,
                   help="path to an upstream kubeconfig (the pull-mode pod "
                        "mount; reference: -from_kubeconfig)")
    p.add_argument("--from-cluster", default="admin",
                   help="upstream logical cluster name")
    p.add_argument("--to-server", required=not pod_form_only, default=None,
                   help="downstream physical cluster URL (reference: "
                        "-to_kubeconfig / in-cluster config)")
    p.add_argument("--to-cluster", default="default",
                   help="downstream tenant (physical servers are usually "
                        "single-tenant: 'default')")
    p.add_argument("-cluster", "--cluster", dest="cluster", required=True,
                   help="sync target id — the kcp.dev/cluster label value "
                        "(reference: -cluster)")
    p.add_argument("--backend", choices=["fused", "host"], default="fused",
                   help="fused: the batched device step (the reference's "
                        "'tpu'); host: the per-object host path")
    p.add_argument("--from-ca-file", default=None,
                   help="CA bundle for an https --from-server (a kubeconfig's "
                        "certificate-authority-data is used automatically)")
    p.add_argument("--to-ca-file", default=None,
                   help="CA bundle for an https --to-server")
    p.add_argument("--mesh", default="",
                   help="serving-mesh spec (N, NxM or NxMxK) to shard the "
                        "fused core over the visible CUDA devices (or over "
                        "--device repeated when it names one)")
    add_device_argument(p)
    p.add_argument("resources", nargs="+",
                   help="resource types to sync, e.g. deployments.apps")
    return p


def kubeconfig_credentials(content: str) -> tuple[str, str, bytes | None]:
    """(server URL, bearer token, CA PEM or None) of the current context
    in a kubeconfig (the JSON shape render_kubeconfig writes; token empty
    when the server runs open, CA present when it serves TLS)."""
    import base64

    cfg = json.loads(content)
    current = cfg.get("current-context", "")
    ctx = next((c["context"] for c in cfg.get("contexts", [])
                if c.get("name") == current), None) or {}
    cluster_name = ctx.get("cluster") or current
    user_name = ctx.get("user", "")
    token = next((u.get("user", {}).get("token", "")
                  for u in cfg.get("users", []) if u.get("name") == user_name), "")
    for c in cfg.get("clusters", []):
        if c.get("name") == cluster_name:
            ca_b64 = c["cluster"].get("certificate-authority-data", "")
            ca = base64.b64decode(ca_b64) if ca_b64 else None
            return c["cluster"]["server"], token, ca
    raise ValueError(f"kubeconfig has no cluster {cluster_name!r}")


async def run(args) -> None:
    from ..syncer import start_syncer

    from_server, token, from_ca = args.from_server, "", None
    if from_server is None:
        if not args.from_kubeconfig:
            raise SystemExit("one of --from-server / -from_kubeconfig required")
        with open(args.from_kubeconfig, encoding="utf-8") as f:  # kcp-lint: disable=async-discipline -- one-shot CLI startup read; nothing is serving on this loop yet
            from_server, token, from_ca = kubeconfig_credentials(f.read())
    upstream = RestClient(from_server, cluster=args.from_cluster, token=token,
                          ca_data=from_ca,
                          ca_file=getattr(args, "from_ca_file", None))
    downstream = RestClient(args.to_server, cluster=args.to_cluster,
                            ca_file=getattr(args, "to_ca_file", None))
    mesh = None
    if args.mesh:
        from ..parallel.mesh import mesh_on

        mesh = mesh_on(args.mesh, args.device)
    syncer = await start_syncer(upstream, downstream, args.resources,
                                args.cluster, backend=args.backend, mesh=mesh,
                                device=args.device)
    stop = asyncio.Event()
    loop = asyncio.get_event_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:
            pass
    await stop.wait()
    await syncer.stop()


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    asyncio.run(run(args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
