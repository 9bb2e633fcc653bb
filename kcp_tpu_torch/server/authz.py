"""RBAC-lite: bearer-token authentication + per-tenant RBAC evaluation.

The reference gets authn/authz from its forked generic control plane —
the minimal apiserver explicitly keeps RBAC among the built-in resources
(docs/investigations/minimal-api-server.md; the fork wires the standard
RBAC authorizer) and the scheme here already serves `clusterroles` /
`clusterrolebindings` (kcp_tpu_torch/apis/scheme.py). This module makes those
objects mean something:

- **Authentication**: ``Authorization: Bearer <token>`` resolved against
  a static token table (the reference's admin.kubeconfig model: tokens
  minted at startup, server.go:151-176). No token -> the anonymous user.
- **Authorization**: RBAC evaluated *per logical cluster* — bindings in
  tenant A grant nothing in tenant B (tenancy is the whole point of the
  logical-cluster model). Wildcard ``*`` verbs/groups/resources are
  supported; the well-known ``cluster-admin`` role name short-circuits.
- Cross-tenant wildcard reads (``/clusters/*``) require the caller to be
  admin in the root cluster, since they traverse every tenant at once.
- **Escalation prevention** (Kubernetes' RBAC escalation check, which
  the reference inherits from its forked generic control plane): writes
  to ``clusterroles`` are denied unless the writer already holds every
  permission the role grants (or holds the ``escalate`` verb on
  clusterroles); writes to ``clusterrolebindings`` are denied unless the
  writer already holds the referenced role's permissions (or holds the
  ``bind`` verb on clusterroles). Without this, any user granted
  ``create`` on clusterrolebindings could bind themselves cluster-admin.

Evaluation is pure host-side policy (small, irregular, latency-bound —
nothing to batch); enforcement sits in the REST handler so the
in-process Client, like the reference's loopback client, stays
privileged. Default OFF (Config.authz) to keep the open-prototype
behavior the reference ships with.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..store.store import WILDCARD, LogicalStore
from ..utils.errors import NotFoundError

ANONYMOUS = "system:anonymous"
ADMIN_USER = "admin"
CLUSTER_ADMIN_ROLE = "cluster-admin"
ROOT_CLUSTER = "admin"  # the default logical cluster of admin.kubeconfig

CLUSTERROLES = "clusterroles.rbac.authorization.k8s.io"
BINDINGS = "clusterrolebindings.rbac.authorization.k8s.io"


@dataclass
class Authenticator:
    """Static bearer-token table (token -> user name)."""

    tokens: dict[str, str] = field(default_factory=dict)

    def user_for(self, headers: dict[str, str]) -> str:
        auth = headers.get("authorization", "")
        if auth.lower().startswith("bearer "):
            token = auth[7:].strip()
            user = self.tokens.get(token)
            if user:
                return user
        return ANONYMOUS


def _rule_matches(rule: dict, verb: str, group: str, resource: str) -> bool:
    def hit(allowed, value):
        return "*" in allowed or value in allowed

    return (
        hit(rule.get("verbs", []), verb)
        and hit(rule.get("apiGroups", [""]), group)
        and hit(rule.get("resources", []), resource)
    )


class Authorizer:
    """Per-logical-cluster RBAC evaluation over the live store."""

    def __init__(self, store: LogicalStore):
        self.store = store

    def _roles_for(self, user: str, cluster: str) -> list[str]:
        bindings, _ = self.store.list(BINDINGS, cluster)
        out = []
        for b in bindings:
            for subj in b.get("subjects", []):
                if subj.get("kind", "User") == "User" and subj.get("name") == user:
                    out.append(b.get("roleRef", {}).get("name", ""))
        return out

    def allowed(self, user: str, cluster: str, verb: str, group: str,
                resource: str) -> bool:
        if user == ADMIN_USER:
            return True  # the minted admin identity is cluster-admin everywhere
        if cluster == WILDCARD:
            # cross-tenant traversal: only root-cluster admins (implies
            # any per-rule grant, so one membership test suffices)
            return CLUSTER_ADMIN_ROLE in self._roles_for(user, ROOT_CLUSTER)
        for role_name in self._roles_for(user, cluster):
            if role_name == CLUSTER_ADMIN_ROLE:
                return True
            try:
                role = self.store.get(CLUSTERROLES, cluster, role_name)
            except NotFoundError:
                continue  # dangling roleRef grants nothing
            for rule in role.get("rules", []):
                if _rule_matches(rule, verb, group, resource):
                    return True
        return False

    # ------------------------------------------------- escalation check

    def _covers(self, user: str, cluster: str, rules: list) -> bool:
        """Does the user already hold every permission ``rules`` grants?
        Wildcards are only covered by wildcards (a user without ``*``
        cannot grant ``*``), matching Kubernetes' covers semantics.

        The user's effective rule set is resolved ONCE (one binding list
        + one get per bound role), then each requested permission is
        cover-matched in memory — a wide submitted role must not amplify
        into per-combination store evaluations. Rules that are not even
        dict-shaped cannot be verified and are denied."""
        if user == ADMIN_USER:
            return True
        held: list[dict] = []
        for role_name in self._roles_for(user, cluster):
            if role_name == CLUSTER_ADMIN_ROLE:
                return True
            try:
                role = self.store.get(CLUSTERROLES, cluster, role_name)
            except NotFoundError:
                continue
            held.extend(r for r in role.get("rules", []) if isinstance(r, dict))
        for rule in rules:
            if not isinstance(rule, dict):
                return False
            for verb in rule.get("verbs", []):
                for group in rule.get("apiGroups", [""]):
                    for resource in rule.get("resources", []):
                        if not any(_rule_matches(h, verb, group, resource)
                                   for h in held):
                            return False
        return True

    def escalation_denied(self, user: str, cluster: str, resource: str,
                          body: dict | None) -> str | None:
        """For a clusterrole/clusterrolebinding write, a denial message if
        the writer would grant permissions they do not hold; None = allow.

        Mirrors Kubernetes' RBAC escalation prevention: the ``escalate``
        verb (on clusterroles) bypasses the role check, the ``bind`` verb
        bypasses the binding check."""
        if user == ADMIN_USER:
            return None
        body = body or {}
        if resource == "clusterroles":
            if self.allowed(user, cluster, "escalate",
                            "rbac.authorization.k8s.io", "clusterroles"):
                return None
            if not self._covers(user, cluster, body.get("rules", [])):
                return (f'user "{user}" cannot create/update a clusterrole '
                        f"granting permissions they do not hold "
                        f"(escalation check; needs the \"escalate\" verb)")
        elif resource == "clusterrolebindings":
            if self.allowed(user, cluster, "bind",
                            "rbac.authorization.k8s.io", "clusterroles"):
                return None
            role_name = (body.get("roleRef") or {}).get("name", "")
            if role_name == CLUSTER_ADMIN_ROLE:
                if CLUSTER_ADMIN_ROLE in self._roles_for(user, cluster):
                    return None
                return (f'user "{user}" cannot bind "{CLUSTER_ADMIN_ROLE}" '
                        f"without holding it (escalation check)")
            try:
                role = self.store.get(CLUSTERROLES, cluster, role_name)
            except NotFoundError:
                # binding a nonexistent role grants nothing today, but a
                # later role create would retroactively arm it — deny
                return (f'user "{user}" cannot bind nonexistent role '
                        f'"{role_name}" (escalation check)')
            if not self._covers(user, cluster, role.get("rules", [])):
                return (f'user "{user}" cannot bind role "{role_name}" '
                        f"granting permissions they do not hold "
                        f"(escalation check; needs the \"bind\" verb)")
        return None


def verb_for(method: str, has_name: bool, is_watch: bool) -> str:
    if is_watch:
        return "watch"
    if method == "GET":
        return "get" if has_name else "list"
    return {"POST": "create", "PUT": "update", "PATCH": "patch",
            "DELETE": "delete"}.get(method, method.lower())
