"""Cluster API type (cluster.example.dev/v1alpha1).

Behavioral parity with the reference type (pkg/apis/cluster/v1alpha1/
cluster_types.go:36-83): ``spec.kubeconfig`` points at a physical cluster;
``status.conditions`` carries Ready; ``status.syncedResources`` lists the
negotiated resources currently syncing.

Objects are plain dicts (the whole framework is dynamic/unstructured —
fixed Go structs would buy nothing here and dicts flow straight into the
device encoder).
"""

from __future__ import annotations

from .conditions import FALSE, TRUE, is_condition_true, set_condition
from .scheme import GVR

GROUP = "cluster.example.dev"
VERSION = "v1alpha1"
CLUSTERS = GVR(GROUP, VERSION, "clusters")

READY = "Ready"

# Reasons mirroring the reference's condition reasons
# (cluster_types.go / cluster.go reconcile error paths).
REASON_INVALID_KUBECONFIG = "InvalidKubeConfig"
REASON_ERROR_STARTING_SYNCER = "ErrorStartingSyncer"
REASON_ERROR_INSTALLING_SYNCER = "ErrorInstallingSyncer"
REASON_SYNCER_NOT_READY = "SyncerNotReady"


def new_cluster(name: str, kubeconfig: str = "") -> dict:
    return {
        "apiVersion": f"{GROUP}/{VERSION}",
        "kind": "Cluster",
        "metadata": {"name": name},
        "spec": {"kubeconfig": kubeconfig},
    }


def set_ready(cluster: dict, reason: str = "", message: str = "") -> None:
    set_condition(cluster, READY, TRUE, reason, message)


def set_not_ready(cluster: dict, reason: str, message: str = "") -> None:
    set_condition(cluster, READY, FALSE, reason, message)


def is_ready(cluster: dict) -> bool:
    return is_condition_true(cluster, READY)


# Fleet placement surface (fleet/): provisioned capacity lives
# in spec, the health-adjusted allocatable in status, WAN locality in
# labels — mirroring node capacity/allocatable + topology labels upstream.
CAPACITY_KEY = "replicas"
REGION_LABEL = "fleet.kcp.dev/region"


def set_capacity(cluster: dict, replicas: int,
                 allocatable: int | None = None,
                 region: str = "") -> None:
    cluster.setdefault("spec", {})["capacity"] = {CAPACITY_KEY: int(replicas)}
    cluster.setdefault("status", {})["allocatable"] = {
        CAPACITY_KEY: int(replicas if allocatable is None else allocatable)}
    if region:
        cluster.setdefault("metadata", {}).setdefault(
            "labels", {})[REGION_LABEL] = region


def capacity_of(cluster: dict) -> int:
    """Provisioned replica capacity (0 = unspecified/unlimited-legacy)."""
    return int(((cluster.get("spec") or {}).get("capacity") or {})
               .get(CAPACITY_KEY, 0) or 0)


def allocatable_of(cluster: dict) -> int:
    """Health-adjusted allocatable replicas; falls back to capacity."""
    alloc = ((cluster.get("status") or {}).get("allocatable") or {})
    if CAPACITY_KEY in alloc:
        return int(alloc[CAPACITY_KEY] or 0)
    return capacity_of(cluster)


def region_of(cluster: dict) -> str:
    return ((cluster.get("metadata") or {}).get("labels") or {}).get(
        REGION_LABEL, "")


def synced_resources(cluster: dict) -> list[str]:
    return (cluster.get("status") or {}).get("syncedResources") or []


def set_synced_resources(cluster: dict, resources: list[str]) -> None:
    cluster.setdefault("status", {})["syncedResources"] = sorted(resources)
