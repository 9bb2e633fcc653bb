"""GVR/GVK registry.

The analog of the reference's scheme registration (pkg/apis/*/v1alpha1/
register.go) plus just enough discovery metadata for the dynamic client,
CRD puller, and API server.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GVR:
    group: str
    version: str
    resource: str  # plural, lowercase

    @property
    def storage_name(self) -> str:
        """Store resource key: ``<plural>`` or ``<plural>.<group>``."""
        return f"{self.resource}.{self.group}" if self.group else self.resource

    @property
    def api_path(self) -> str:
        if self.group:
            return f"/apis/{self.group}/{self.version}/{self.resource}"
        return f"/api/{self.version}/{self.resource}"

    def __str__(self) -> str:
        return self.storage_name

    @classmethod
    def parse(cls, s: str, version: str = "v1") -> "GVR":
        """Parse ``deployments.apps`` / ``configmaps`` style strings."""
        if "/" in s:  # group/version/resource
            group, version, resource = s.split("/", 2)
            return cls(group, version, resource)
        resource, _, group = s.partition(".")
        return cls(group, _default_version(group) or version, resource)


_GROUP_VERSIONS = {
    "": "v1",
    "apps": "v1",
    "rbac.authorization.k8s.io": "v1",
    "apiextensions.k8s.io": "v1",
    "cluster.example.dev": "v1alpha1",
    "apiresource.kcp.dev": "v1alpha1",
}


def _default_version(group: str) -> str | None:
    return _GROUP_VERSIONS.get(group)


@dataclass(frozen=True)
class ResourceInfo:
    gvr: GVR
    kind: str
    list_kind: str
    singular: str
    namespaced: bool
    has_status: bool = True


class Scheme:
    """Registry of known resource types (built-ins + registered CRDs)."""

    def __init__(self):
        self._by_storage: dict[str, ResourceInfo] = {}
        self._by_kind: dict[tuple[str, str], ResourceInfo] = {}

    def register(self, info: ResourceInfo) -> None:
        self._by_storage[info.gvr.storage_name] = info
        self._by_kind[(info.gvr.group, info.kind)] = info

    def unregister(self, storage_name: str) -> None:
        info = self._by_storage.pop(storage_name, None)
        if info:
            self._by_kind.pop((info.gvr.group, info.kind), None)

    def by_resource(self, storage_name: str) -> ResourceInfo | None:
        return self._by_storage.get(storage_name)

    def by_kind(self, group: str, kind: str) -> ResourceInfo | None:
        return self._by_kind.get((group, kind))

    def all(self) -> list[ResourceInfo]:
        return sorted(self._by_storage.values(), key=lambda i: i.gvr.storage_name)

    def group_versions(self) -> dict[str, set[str]]:
        out: dict[str, set[str]] = {}
        for info in self._by_storage.values():
            out.setdefault(info.gvr.group, set()).add(info.gvr.version)
        return out


_CORE = [
    ("", "v1", "namespaces", "Namespace", False),
    ("", "v1", "configmaps", "ConfigMap", True),
    ("", "v1", "secrets", "Secret", True),
    ("", "v1", "serviceaccounts", "ServiceAccount", True),
    ("", "v1", "resourcequotas", "ResourceQuota", True),
    ("", "v1", "services", "Service", True),
    ("", "v1", "pods", "Pod", True),
    ("apps", "v1", "deployments", "Deployment", True),
    ("rbac.authorization.k8s.io", "v1", "clusterroles", "ClusterRole", False),
    ("rbac.authorization.k8s.io", "v1", "clusterrolebindings", "ClusterRoleBinding", False),
    ("apiextensions.k8s.io", "v1", "customresourcedefinitions", "CustomResourceDefinition", False),
    ("cluster.example.dev", "v1alpha1", "clusters", "Cluster", False),
    ("apiresource.kcp.dev", "v1alpha1", "apiresourceimports", "APIResourceImport", False),
    ("apiresource.kcp.dev", "v1alpha1", "negotiatedapiresources", "NegotiatedAPIResource", False),
]


def default_scheme() -> Scheme:
    """Scheme with the built-in control-plane types.

    The three CRD-backed types mirror the reference's embedded config
    manifests applied at startup (reference: embed.go:12-13,
    pkg/reconciler/cluster/controller.go:316-350 RegisterCRDs).
    """
    s = Scheme()
    for group, version, plural, kind, namespaced in _CORE:
        singular = kind.lower()
        s.register(
            ResourceInfo(
                gvr=GVR(group, version, plural),
                kind=kind,
                list_kind=kind + "List",
                singular=singular,
                namespaced=namespaced,
            )
        )
    return s
