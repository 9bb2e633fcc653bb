"""cow-mutation: flag in-place mutation of CoW store snapshots.

The store's read-path contract (docs/operations.md "CoW contract"): with
``KCP_STORE_INDEX=1`` the store shares references between storage,
``list`` results, ``get_snapshot``, informer caches, watch ``Event``
payloads, and ``_sync_view_ro`` views. Mutating any of them corrupts the
store — silently, with no event and no RV bump — and with encode-once
serving on, also desynchronizes every cached byte string. This checker
taints values flowing out of the snapshot-returning APIs and flags
in-place writes to them; the fix is always the same: start from ``get``
(a private copy) or ``copy.deepcopy``, then write through ``update``.
"""

from __future__ import annotations

import ast

from .base import FileChecker, Finding, SourceFile, attr_chain
from .dataflow import COLL, ELEM, SAFE_CALLS, Taint, TaintScanner

#: helpers that mutate their first argument in place — passing a shared
#: snapshot into one is as much a violation as subscript assignment
ARG_MUTATORS = {
    "set_condition": 0,
    "remove_condition": 0,
    "set_ready": 0,
    "set_not_ready": 0,
    "set_synced_resources": 0,
    "accept_names": 0,
    "_stamp": 0,
}

#: functions that return a private deep copy of their input
COPYING_CALLS = SAFE_CALLS | {"transform_for_downstream"}


def _unwrap(node: ast.expr) -> ast.expr:
    while isinstance(node, ast.Await):
        node = node.value
    return node


def _effective_method(call: ast.Call) -> tuple[str, str]:
    """(method name, receiver chain) of a call, looking through the
    handler's ``self._st(self.store.list, ...)`` executor indirection."""
    fn = call.func
    name = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else "")
    chain = attr_chain(fn)
    if name == "_st" and call.args and isinstance(call.args[0], ast.Attribute):
        inner = call.args[0]
        return inner.attr, attr_chain(inner)
    return name, chain


class CowScanner(TaintScanner):
    rule = "cow-mutation"
    arg_mutators = ARG_MUTATORS

    def describe_mutation(self, text: str) -> str:
        return (f"in-place mutation of CoW snapshot {text!r} "
                f"(shared with the store; re-get() or deepcopy first)")

    def taint_of_call(self, call: ast.Call, env: dict[str, Taint]) -> Taint:
        name, chain = _effective_method(call)
        if name in COPYING_CALLS:
            return None
        if name == "get_snapshot" or name == "_sync_view_ro":
            return ELEM
        if "informer" in chain:
            if name == "get":
                return ELEM
            if name in ("list", "index"):
                return COLL
        if isinstance(call.func, ast.Attribute):
            base = self.taint(call.func.value, env)
            if base == ELEM and name == "get":
                return ELEM  # dict.get on a snapshot shares nested values
            if base in (ELEM, COLL) and name in ("items", "values"):
                return COLL
        return None

    def taint_of_attribute(self, node: ast.Attribute,
                           env: dict[str, Taint]) -> Taint:
        if node.attr in ("object", "old_object"):
            return ELEM  # watch Event payloads share store snapshots
        if node.attr == "cache" and "informer" in attr_chain(node):
            return COLL
        return None

    def tuple_call_taints(self, call: ast.Call,
                          n_targets: int) -> list[Taint] | None:
        name, _chain = _effective_method(call)
        if name == "list" and n_targets == 2:
            # `(items, rv) = <store-or-client>.list(...)`: items share
            # storage references on indexed stores
            return [COLL, None]
        return None

    def taint(self, node: ast.AST, env: dict[str, Taint]) -> Taint:
        return super().taint(_unwrap(node) if isinstance(node, ast.expr)
                             else node, env)

    def _handle_assign(self, targets: list[ast.expr], value: ast.expr,
                       env: dict[str, Taint]) -> None:
        super()._handle_assign(targets, _unwrap(value), env)


class CowChecker(FileChecker):
    name = "cow-mutation"

    def check(self, f: SourceFile) -> list[Finding]:
        return CowScanner(f).run()
