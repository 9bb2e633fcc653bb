"""Pull-mode pod emulation: run the installed syncer like a kubelet would.

In the reference's pull mode, installSyncer deploys a Pod into the
physical cluster whose container runs the standalone syncer binary with
``-from_kubeconfig /kcp/kubeconfig -cluster <name> <resources...>``
(pkg/reconciler/cluster/syncer.go:38-227; binary flags
cmd/syncer/main.go:17-28), and kubelet makes it run. There is no kubelet
against a fake physical cluster, so this module is the stand-in: it
reads the installed Deployment + ConfigMap back out of the physical
cluster, parses the container args exactly as the syncer binary would,
and starts the same in-process ``Syncer`` the standalone CLI runs.

Because it consumes the *installed manifests* — not the installer's
inputs — it keeps the manifests honest: an arg or mount drift between
installer and binary breaks the pull-mode tests, the same way it would
break a real pod.
"""

from __future__ import annotations

from typing import Callable

from ..client import Client
from ..syncer.syncer import Syncer, start_syncer
from ..utils import errors
from ..reconcilers.cluster.installer import SYNCER_NAME, SYNCER_NAMESPACE


class PodSpecError(Exception):
    """The installed manifests do not form a runnable syncer pod."""


def parse_installed_syncer(physical: Client) -> tuple[str, str, list[str], str]:
    """Read back (kcp_kubeconfig, cluster_name, resources, mesh_spec)
    from the installed Deployment + ConfigMap, the way the container
    would see them (kubeconfig via the volume mount, the rest via
    args)."""
    try:
        dep = physical.get("deployments.apps", SYNCER_NAME, SYNCER_NAMESPACE)
        cm = physical.get("configmaps", f"{SYNCER_NAME}-kubeconfig", SYNCER_NAMESPACE)
    except errors.NotFoundError as err:
        raise PodSpecError(f"syncer not installed: {err}") from err

    kubeconfig = (cm.get("data") or {}).get("kubeconfig")
    if not kubeconfig:
        raise PodSpecError("kubeconfig ConfigMap has no 'kubeconfig' key")

    containers = (((dep.get("spec") or {}).get("template") or {})
                  .get("spec") or {}).get("containers") or []
    if not containers:
        raise PodSpecError("syncer Deployment has no containers")
    args = list(containers[0].get("args") or [])

    # parse through the binary's OWN parser (kcp_tpu_torch/cli/syncer.py) so
    # installer output, the deployed binary, and this emulator share one
    # argument surface — any drift fails here the way it would in a pod
    from ..cli.syncer import build_parser

    try:
        ns = build_parser(pod_form_only=True).parse_args(args)
    except SystemExit as err:  # argparse reports to stderr then exits
        raise PodSpecError(
            f"installed syncer args not parseable by the syncer binary: {args}"
        ) from err
    if not ns.from_kubeconfig:
        raise PodSpecError("no -from_kubeconfig arg in syncer Deployment")
    return kubeconfig, ns.cluster, list(ns.resources), getattr(ns, "mesh", "")


async def run_installed_syncer(
    physical: Client,
    resolve_kubeconfig: Callable[[str], Client],
    backend: str = "fused",  # the deployed binary's default (cli/syncer.py)
    device=None,
) -> Syncer:
    """Start the syncer exactly as the installed pod would.

    ``resolve_kubeconfig`` turns the mounted kubeconfig content into a
    kcp upstream client (the fake-registry analog of client-go building
    a clientset from /kcp/kubeconfig). ``device`` is the pod's card
    (``None``: the CUDA card; ``"cpu"`` on a host); a mesh spec in the
    installed args spreads over the visible CUDA devices, or repeats a
    named ``device``.
    """
    kubeconfig, cluster, resources, mesh_spec = parse_installed_syncer(physical)
    upstream = resolve_kubeconfig(kubeconfig)
    mesh = None
    if mesh_spec:
        from ..parallel.mesh import mesh_on

        mesh = mesh_on(mesh_spec, device)
    # start_syncer, not Syncer: the pod's binary validates the resource
    # set via discovery first (RetryableError while a resource is not
    # served yet), and the emulator must fail the same way
    return await start_syncer(upstream, physical, resources, cluster,
                              backend=backend, mesh=mesh, device=device)
