"""frozen-bytes: flag writes / re-encodes of encode-once cache bytes.

The encode-once serving contract (docs/architecture.md "Encode-once serving"):
bytes flowing out of ``encode_obj`` / ``encode_many`` / ``encode_event``
/ ``encode_events`` / ``list_encoded`` and the RV-keyed body cache are
*shared* — the same object is spliced into every response and every
watcher's stream. Treating them as scratch (``bytearray()`` wrapping,
element assignment, ``+=``) or round-tripping them back through
``json.loads`` on a serving path defeats the cache and, for mutable
wrappers, risks corrupting bytes mid-flight for every other consumer.
"""

from __future__ import annotations

import ast

from .base import FileChecker, Finding, SourceFile, expr_text
from .dataflow import COLL, ELEM, Taint, TaintScanner

ENCODE_ELEM = frozenset({"encode_obj", "encode_event"})
ENCODE_COLL = frozenset({"encode_many", "encode_events"})
CACHE_ATTRS = frozenset({"_enc_bytes", "_span_cache", "_list_cache"})


class FrozenBytesScanner(TaintScanner):
    rule = "frozen-bytes"
    flag_aug_name = True

    def describe_mutation(self, text: str) -> str:
        return (f"write to shared encode-once bytes {text!r} "
                f"(cached bytes are spliced into every response — "
                f"build new bytes instead)")

    def taint_of_call(self, call: ast.Call, env: dict[str, Taint]) -> Taint:
        fn = call.func
        name = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else "")
        if name in ENCODE_ELEM:
            return ELEM
        if name in ENCODE_COLL:
            return COLL
        if name == "get" and isinstance(fn, ast.Attribute) and \
                isinstance(fn.value, ast.Attribute) and \
                fn.value.attr in CACHE_ATTRS:
            return ELEM  # cache entry tuple: ent[1] is the shared bytes
        return None

    def taint_of_attribute(self, node: ast.Attribute,
                           env: dict[str, Taint]) -> Taint:
        if node.attr in CACHE_ATTRS:
            return COLL
        return None

    def tuple_call_taints(self, call: ast.Call,
                          n_targets: int) -> list[Taint] | None:
        fn = call.func
        name = fn.attr if isinstance(fn, ast.Attribute) else ""
        if name == "list_encoded" and n_targets == 2:
            return [COLL, None]
        return None

    def _scan_value(self, node: ast.expr, env: dict[str, Taint]) -> None:
        super()._scan_value(node, env)
        for call in ast.walk(node):
            if not isinstance(call, ast.Call) or not call.args:
                continue
            fn = call.func
            name = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else "")
            arg0 = call.args[0]
            if self.taint(arg0, env) != ELEM:
                continue
            if name == "bytearray":
                self._flag(call, f"bytearray() wrap of shared encode-once "
                                 f"bytes {expr_text(arg0)!r} — treating "
                                 f"cached bytes as mutable scratch breaks "
                                 f"the frozen-bytes contract")
            elif name == "loads":
                self._flag(call, f"re-decoding shared encode-once bytes "
                                 f"{expr_text(arg0)!r} on a serving path — "
                                 f"splice the cached bytes instead of "
                                 f"round-tripping them through json")


class FrozenBytesChecker(FileChecker):
    name = "frozen-bytes"

    def check(self, f: SourceFile) -> list[Finding]:
        return FrozenBytesScanner(f).run()
