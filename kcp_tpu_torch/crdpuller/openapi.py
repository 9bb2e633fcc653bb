"""OpenAPI v2 (swagger) -> structural CRD schema synthesis.

The analog of the reference's ``SchemaConverter`` proto visitor
(pkg/crdpuller/discovery.go:289-475): given a physical cluster's
``/openapi/v2`` document, synthesize a structural JSON schema for an
arbitrary resource type so the API importer can feed real (non
preserve-unknown) schemas into LCD negotiation. Where the reference
visits kube-openapi proto models, this walks the raw swagger JSON —
same semantics, no proto dependency:

- ``$ref`` resolution with cycle detection (recursive schemas are an
  error, discovery.go:442-447)
- hardcoded overrides for well-known meta types (the ``knownSchemas``
  table, discovery.go:481-569) keyed by definition-name suffix
- the top-level ``metadata`` field collapses to a bare object
  (discovery.go:424-426)
- array merge/list extensions map onto ``x-kubernetes-list-type`` /
  ``x-kubernetes-list-map-keys`` (discovery.go:336-395)
- typeless/propertyless subtrees become embedded resources
  (``x-kubernetes-embedded-resource``) with preserve-unknown defaulting
  to true — a deliberate deviation from VisitArbitrary
  (discovery.go:325-335), whose exact output is invalid under
  Kubernetes structural-schema rules and fails the reference's own
  schemacompat dispatch (schemacompat.go:144-165)
- inline ``x-kubernetes-int-or-string`` / preserve-unknown extensions
  pass through, so CRD-derived documents (a kcp serving published CRDs
  as swagger) round-trip without degradation
"""

from __future__ import annotations

import copy
from typing import Any

REF_PREFIX = "#/definitions/"
GVK_EXT = "x-kubernetes-group-version-kind"
INT_OR_STRING = "x-kubernetes-int-or-string"
PRESERVE_UNKNOWN = "x-kubernetes-preserve-unknown-fields"

# knownSchemas analog (discovery.go:481-569): schemas for meta types that
# either can't round-trip through swagger (Quantity, IntOrString) or that
# CRDs must not constrain (RawExtension, ObjectMeta). Matched on the
# swagger definition-name suffix.
KNOWN_REF_SCHEMAS: dict[str, dict] = {
    ".ObjectMeta": {"type": "object"},
    ".Time": {"type": "string", "format": "date-time"},
    ".MicroTime": {"type": "string", "format": "date-time"},
    ".Duration": {"type": "string"},
    ".Quantity": {"x-kubernetes-int-or-string": True},
    ".IntOrString": {"x-kubernetes-int-or-string": True},
    ".RawExtension": {
        "type": "object",
        "x-kubernetes-preserve-unknown-fields": True,
        "x-kubernetes-embedded-resource": True,
    },
    ".Fields": {"type": "object", "x-kubernetes-preserve-unknown-fields": True},
    ".FieldsV1": {"type": "object", "x-kubernetes-preserve-unknown-fields": True},
    ".JSON": {"x-kubernetes-preserve-unknown-fields": True},
}


class ConversionError(Exception):
    """The document cannot produce a structural schema (recursive refs,
    missing definitions) — callers fall back to preserve-unknown."""


def definition_for_gvk(doc: dict, group: str, version: str, kind: str) -> str | None:
    """Find the swagger definition name carrying the matching
    ``x-kubernetes-group-version-kind`` extension."""
    for name, definition in (doc.get("definitions") or {}).items():
        for gvk in definition.get(GVK_EXT) or []:
            if (gvk.get("group", "") == group and gvk.get("version") == version
                    and gvk.get("kind") == kind):
                return name
    return None


class SwaggerConverter:
    """One conversion pass over a swagger document (stateful for cycle
    detection, like the reference's ``visited`` set)."""

    def __init__(self, doc: dict, root_name: str):
        self.definitions = doc.get("definitions") or {}
        self.root_name = root_name
        self._visiting: set[str] = set()

    def convert(self) -> dict:
        if self.root_name not in self.definitions:
            raise ConversionError(f"definition {self.root_name!r} not found")
        return self._node(self.definitions[self.root_name], at_root=True)

    # ------------------------------------------------------------- walk

    def _node(self, node: dict, inherited_desc: str = "", at_root: bool = False) -> dict:
        ref = node.get("$ref")
        if ref is not None:
            return self._ref(ref, inherited_desc or node.get("description", ""))

        out: dict[str, Any] = {}
        desc = inherited_desc or node.get("description", "")
        if desc:
            out["description"] = desc

        # int-or-string carried inline (CRD-derived documents — e.g. a
        # kcp serving its published CRDs as swagger — express it as the
        # extension, not as a known $ref): pass it through, or the
        # round-trip would degrade it to an arbitrary subtree
        if node.get(INT_OR_STRING):
            out[INT_OR_STRING] = True
            return out

        if "properties" in node:  # Kind
            out["type"] = "object"
            if node.get("required"):
                out["required"] = list(node["required"])
            props = {}
            for fname, fnode in node["properties"].items():
                if at_root and fname == "metadata":
                    # the reference collapses the root metadata subtree
                    props[fname] = {"type": "object"}
                else:
                    props[fname] = self._node(
                        fnode, inherited_desc=fnode.get("description", ""))
            out["properties"] = props
            self._copy_preserve_unknown(node, out)
            self._list_extensions(node, out)
            return out

        if "additionalProperties" in node and isinstance(
                node["additionalProperties"], dict):  # Map
            out["type"] = "object"
            out["additionalProperties"] = self._node(node["additionalProperties"])
            return out

        ntype = node.get("type")
        if ntype == "array":
            out["type"] = "array"
            items = node.get("items") or {}
            item_schema = self._node(items, inherited_desc=items.get("description", ""))
            self._array_extensions(node, items, out, item_schema)
            out["items"] = item_schema
            return out

        if ntype:  # Primitive (incl. propertyless objects)
            out["type"] = ntype
            if node.get("format"):
                out["format"] = node["format"]
            if node.get("enum"):
                out["enum"] = list(node["enum"])
            self._copy_preserve_unknown(node, out)
            return out

        # Arbitrary: no type, no properties, no ref. VisitArbitrary
        # (discovery.go:325-335) sets embedded-resource and copies
        # preserve-unknown only when the source extension exists —
        # but that exact shape is invalid under Kubernetes structural
        # rules (embedded-resource requires preserve-unknown or
        # properties) and fails the reference's own schemacompat type
        # dispatch. Deliberate deviation: preserve-unknown defaults to
        # true when the source carries no extension.
        out["x-kubernetes-embedded-resource"] = True
        out[PRESERVE_UNKNOWN] = bool(node.get(PRESERVE_UNKNOWN, True))
        return out

    @staticmethod
    def _copy_preserve_unknown(node: dict, out: dict) -> None:
        if node.get(PRESERVE_UNKNOWN) is not None:
            out[PRESERVE_UNKNOWN] = bool(node[PRESERVE_UNKNOWN])

    def _ref(self, ref: str, inherited_desc: str) -> dict:
        name = ref[len(REF_PREFIX):] if ref.startswith(REF_PREFIX) else ref
        for suffix, known in KNOWN_REF_SCHEMAS.items():
            if name.endswith(suffix):
                out = copy.deepcopy(known)
                if inherited_desc:
                    out["description"] = inherited_desc
                return out
        if name in self._visiting:
            raise ConversionError(f"recursive schema not supported: {name}")
        target = self.definitions.get(name)
        if target is None:
            raise ConversionError(f"unresolved $ref: {name}")
        self._visiting.add(name)
        try:
            return self._node(target, inherited_desc=inherited_desc)
        finally:
            self._visiting.discard(name)

    # ------------------------------------------------------- extensions

    @staticmethod
    def _list_extensions(node: dict, out: dict) -> None:
        """Kind-level merge extensions (discovery.go:429-439)."""
        if node.get("x-kubernetes-patch-merge-key"):
            out["x-kubernetes-list-map-keys"] = [node["x-kubernetes-patch-merge-key"]]
        if node.get("x-kubernetes-list-map-keys"):
            out["x-kubernetes-list-map-keys"] = list(node["x-kubernetes-list-map-keys"])
        if node.get("x-kubernetes-list-type"):
            out["x-kubernetes-list-type"] = node["x-kubernetes-list-type"]

    def _array_extensions(self, node: dict, items: dict, out: dict,
                          item_schema: dict) -> None:
        """Array merge-strategy extensions -> list-type/list-map-keys
        (discovery.go:336-395)."""
        item_is_kind = "properties" in items or (
            "$ref" in items
            and "properties" in (self.definitions.get(
                items["$ref"][len(REF_PREFIX):], {}))
        )
        if node.get("x-kubernetes-list-type"):
            out["x-kubernetes-list-type"] = node["x-kubernetes-list-type"]
        elif node.get("x-kubernetes-patch-strategy"):
            strategy = node["x-kubernetes-patch-strategy"]
            parts = strategy.split(",")
            if "merge" in parts:
                out["x-kubernetes-list-type"] = "map" if item_is_kind else "set"
            else:
                out["x-kubernetes-list-type"] = "atomic"
        if node.get("x-kubernetes-list-map-keys"):
            out["x-kubernetes-list-map-keys"] = list(node["x-kubernetes-list-map-keys"])
        elif node.get("x-kubernetes-patch-merge-key"):
            out["x-kubernetes-list-map-keys"] = [node["x-kubernetes-patch-merge-key"]]
            if not node.get("x-kubernetes-patch-strategy"):
                out["x-kubernetes-list-type"] = "map"
        # a map-typed list requires its map keys on the items
        # (discovery.go:381-391), unless a key field carries a default
        if out.get("x-kubernetes-list-map-keys") and item_schema.get("properties"):
            required = set(item_schema.get("required") or [])
            required.update(out["x-kubernetes-list-map-keys"])
            for fname, fschema in item_schema["properties"].items():
                if "default" in fschema:
                    required.discard(fname)
            item_schema["required"] = sorted(required)


def convert_definition(doc: dict, def_name: str) -> dict:
    """Convert one swagger definition to a structural CRD schema.

    Raises :class:`ConversionError` on recursion/missing refs — the
    caller's fallback chain (known schemas, preserve-unknown) applies.
    """
    return SwaggerConverter(doc, def_name).convert()


def doc_from_crds(crds: list[dict]) -> dict:
    """Synthesize an ``/openapi/v2`` document from CRD objects, one
    definition per served version, each carrying the GVK extension that
    :func:`definition_for_gvk` keys on. Used by both the REST handler
    and the in-process client so the puller sees the same document over
    either transport (reference analog: the apiserver's served openapi
    aggregate, consumed at discovery.go:60-66)."""
    definitions: dict[str, dict] = {}
    for crd in crds:
        spec = crd.get("spec") or {}
        group = spec.get("group", "")
        kind = (spec.get("names") or {}).get("kind", "")
        for v in spec.get("versions", []):
            schema = (v.get("schema") or {}).get("openAPIV3Schema")
            if not schema or not kind:
                continue
            d = copy.deepcopy(schema)
            d[GVK_EXT] = [{"group": group, "version": v.get("name", ""),
                           "kind": kind}]
            definitions[f"{group}.{v.get('name', '')}.{kind}"] = d
    return {"swagger": "2.0",
            "info": {"title": "kcp-tpu", "version": "v0.1.0"},
            "definitions": definitions}
