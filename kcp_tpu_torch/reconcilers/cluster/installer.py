"""Pull-mode syncer installation into a physical cluster.

Behavioral parity with the reference's installer (pkg/reconciler/cluster/
syncer.go:38-252): render the syncer's namespace, service account, RBAC,
kubeconfig ConfigMap and Deployment into the physical cluster; health is
judged from the running workload; uninstall deletes the namespace.

In the reference the deployed image is a Go binary; here the deployed
artifact is this framework's own syncer CLI (cli/syncer_main.py) — the
manifests carry its arguments the same way (cluster id + resource list).
"""

from __future__ import annotations

import logging

from ...client import Client
from ...utils import errors

log = logging.getLogger(__name__)

SYNCER_NAMESPACE = "kcp-syncer"
SYNCER_NAME = "syncer"
# the one definition of the default pull-mode image (contrib/syncer-image);
# Config, both CLIs, and the controller import it
DEFAULT_SYNCER_IMAGE = "kcp-tpu/syncer:latest"


def syncer_manifests(
    cluster_name: str, kcp_kubeconfig: str, resources: list[str], image: str,
    mesh_spec: str = "",
) -> list[tuple[str, dict]]:
    """(gvr, object) pairs to apply, mirroring installSyncer's manifest set
    (syncer.go:38-227). ``mesh_spec`` forwards the serving-mesh sharding
    to the pod's syncer CLI (--mesh) so pull mode shards like push mode."""
    mesh_args = ["--mesh", mesh_spec] if mesh_spec else []
    return [
        ("namespaces", {
            "apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": SYNCER_NAMESPACE},
        }),
        ("serviceaccounts", {
            "apiVersion": "v1", "kind": "ServiceAccount",
            "metadata": {"name": SYNCER_NAME, "namespace": SYNCER_NAMESPACE},
        }),
        ("clusterroles.rbac.authorization.k8s.io", {
            "apiVersion": "rbac.authorization.k8s.io/v1", "kind": "ClusterRole",
            "metadata": {"name": SYNCER_NAME},
            "rules": [
                {"apiGroups": ["*"], "resources": ["*"],
                 "verbs": ["create", "get", "list", "watch", "update", "patch", "delete"]},
            ],
        }),
        ("clusterrolebindings.rbac.authorization.k8s.io", {
            "apiVersion": "rbac.authorization.k8s.io/v1", "kind": "ClusterRoleBinding",
            "metadata": {"name": SYNCER_NAME},
            "roleRef": {"apiGroup": "rbac.authorization.k8s.io",
                        "kind": "ClusterRole", "name": SYNCER_NAME},
            "subjects": [{"kind": "ServiceAccount", "name": SYNCER_NAME,
                          "namespace": SYNCER_NAMESPACE}],
        }),
        ("configmaps", {
            "apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": f"{SYNCER_NAME}-kubeconfig", "namespace": SYNCER_NAMESPACE},
            "data": {"kubeconfig": kcp_kubeconfig},
        }),
        ("deployments.apps", {
            "apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": SYNCER_NAME, "namespace": SYNCER_NAMESPACE},
            "spec": {
                "replicas": 1,
                "selector": {"matchLabels": {"app": SYNCER_NAME}},
                "template": {
                    "metadata": {"labels": {"app": SYNCER_NAME}},
                    "spec": {
                        "serviceAccountName": SYNCER_NAME,
                        "containers": [{
                            "name": SYNCER_NAME,
                            "image": image,
                            "args": (["-from_kubeconfig",
                                      "/kcp/kubeconfig",
                                      "-cluster", cluster_name]
                                     + mesh_args + list(resources)),
                            "volumeMounts": [{"name": "kubeconfig", "mountPath": "/kcp"}],
                        }],
                        "volumes": [{"name": "kubeconfig", "configMap": {
                            "name": f"{SYNCER_NAME}-kubeconfig"}}],
                    },
                },
            },
        }),
    ]


def install_syncer(
    physical: Client, cluster_name: str, kcp_kubeconfig: str,
    resources: list[str], image: str = DEFAULT_SYNCER_IMAGE,
    mesh_spec: str = "",
) -> None:
    for gvr, obj in syncer_manifests(cluster_name, kcp_kubeconfig, resources,
                                     image, mesh_spec):
        ns = obj["metadata"].get("namespace", "")
        try:
            physical.create(gvr, obj, namespace=ns)
        except errors.AlreadyExistsError:
            existing = physical.get(gvr, obj["metadata"]["name"], ns)
            obj["metadata"]["resourceVersion"] = existing["metadata"]["resourceVersion"]
            physical.update(gvr, obj, namespace=ns)


def uninstall_syncer(physical: Client) -> None:
    """Reference parity: deleting the namespace tears the syncer down
    (syncer.go:229-234)."""
    try:
        physical.delete("namespaces", SYNCER_NAMESPACE)
    except errors.NotFoundError:
        pass
    try:
        physical.delete("deployments.apps", SYNCER_NAME, SYNCER_NAMESPACE)
    except errors.NotFoundError:
        pass


def healthcheck_syncer(physical: Client) -> tuple[bool, str]:
    """Is the installed syncer workload healthy? (syncer.go:236-252 polls
    the pod phase; here the Deployment's readyReplicas stands in, since
    the fake agent maintains workload status.)"""
    try:
        dep = physical.get("deployments.apps", SYNCER_NAME, SYNCER_NAMESPACE)
    except errors.NotFoundError:
        return False, "syncer deployment not found"
    ready = (dep.get("status") or {}).get("readyReplicas", 0) or 0
    if ready < 1:
        return False, f"syncer not ready ({ready} ready replicas)"
    return True, ""
